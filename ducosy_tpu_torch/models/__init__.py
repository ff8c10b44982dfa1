"""Generator (ResNet-9 + CBAM) and checkpoint conversion (torch)."""
