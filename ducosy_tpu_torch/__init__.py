"""ducosy_tpu_torch — the PyTorch/CUDA port of ducosy_tpu.

The JAX package (``ducosy_tpu``) is the reference; this package runs the
dual-generator serving pipeline and the CycleGAN training step on an NVIDIA
Hopper card. Plain tensor code is PyTorch; the TPU kernels on those paths
are hand-written CUDA C++ (``csrc/``), built with nvcc at first use and
bound with ctypes.

Layout (module names follow the JAX package so each counterpart is easy to
find):
  config.py        the typed configuration (ranges, model, train, losses)
  device.py        CUDA device resolution, no silent CPU fallback
  dicom/           the DICOM codec (uncompressed, RLE and JPEG Lossless)
                   and the native parser, built at first use
  masks/           the HU-threshold anatomical masks (host numpy/scipy)
  ops/             HU transforms, filters, antialiased resize, int8 grids
  ops/kernels/     kernel wrappers, their plain PyTorch versions and the
                   autograd Functions of the training kernels
  models/          Generator (ResNet-9 + CBAM), PatchGAN discriminator,
                   checkpoint conversion
  losses/          the CycleGAN loss suite
  data/            patient pairing, the slice dataset, the host loader
  train/           state, step, loop and checkpoints
  parallel/        the data-parallel mesh, its collectives, rank spawning
  infer/           dual-generator engine and volume postprocess
  utils/           validation image grids and the metrics logger
  cli/             the serving (generate.py) and training (train.py) CLIs

Nothing here imports JAX or ``ducosy_tpu``: the host modules (config,
dicom, masks, data, utils) are the port's own copies, so the package runs
with the JAX package off the path.
"""

__version__ = "0.3.0"
