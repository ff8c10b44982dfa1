"""ducosy_tpu_torch — the PyTorch/CUDA port of the ducosy_tpu serving path.

The JAX package (``ducosy_tpu``) is the reference; this package runs the
same dual-generator serving pipeline on an NVIDIA Hopper card. Plain tensor
code is PyTorch; the two TPU kernels on the serving path are hand-written
CUDA C++ (``csrc/``), built with nvcc at first use and bound with ctypes.

Layout (module names follow the JAX package so each counterpart is easy to
find):
  device.py        CUDA device resolution, no silent CPU fallback
  ops/             HU transforms, gaussian filters, antialiased resize
  ops/kernels/     kernel wrappers + their plain PyTorch versions
  models/          Generator (ResNet-9 + CBAM) and checkpoint conversion
  infer/           dual-generator engine and volume postprocess
  cli/generate.py  the serving CLI

Nothing here imports JAX. From ``ducosy_tpu`` only JAX-free host code is
used: ``config``, ``dicom`` and ``data.pairing``.
"""

__version__ = "0.1.0"
