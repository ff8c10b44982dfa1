"""The CycleGAN loss suite in PyTorch (ducosy_tpu/losses)."""
