"""HU transforms, filters, resize and the hand-written kernels (torch)."""
