"""One-card CycleGAN training (ducosy_tpu/train)."""
