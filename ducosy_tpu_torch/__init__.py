"""ducosy_tpu_torch — the PyTorch/CUDA port of ducosy_tpu.

The JAX package (``ducosy_tpu``) is the reference; this package runs the
dual-generator serving pipeline and the CycleGAN training step on an NVIDIA
Hopper card. Plain tensor code is PyTorch; the TPU kernels on those paths
are hand-written CUDA C++ (``csrc/``), built with nvcc at first use and
bound with ctypes.

Layout (module names follow the JAX package so each counterpart is easy to
find):
  device.py        CUDA device resolution, no silent CPU fallback
  ops/             HU transforms, filters, antialiased resize
  ops/kernels/     kernel wrappers, their plain PyTorch versions and the
                   autograd Functions of the training kernels
  models/          Generator (ResNet-9 + CBAM), PatchGAN discriminator,
                   checkpoint conversion
  losses/          the CycleGAN loss suite
  data/            the slice dataset with the port's resize
  train/           state, step, loop and checkpoints on one card
  infer/           dual-generator engine and volume postprocess
  cli/             the serving (generate.py) and training (train.py) CLIs

Nothing here imports JAX. From ``ducosy_tpu`` only JAX-free host code is
used: ``config``, ``dicom``, ``masks``, ``data`` (pairing, the loader and
the dataset's host helpers) and ``utils.{imaging,logging}``.
"""

__version__ = "0.2.0"
