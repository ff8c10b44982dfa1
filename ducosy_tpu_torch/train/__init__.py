"""CycleGAN training, on one card or data-parallel (ducosy_tpu/train)."""
