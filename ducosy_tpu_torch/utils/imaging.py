"""Validation image grids.

Replaces torchvision save_image for the per-epoch [real_A | fake_B | real_B]
windowed comparison sheet (modules/trainer.py:262-282): rows of samples,
columns the three windowed images, written as JPEG via PIL.
"""
from __future__ import annotations

import numpy as np


def save_comparison_grid(path: str, real_a, fake_b, real_b, *,
                         max_rows: int = 4):
    """Each input: (N, H, W) or (N, H, W, 1) floats in [0, 1]."""
    from PIL import Image

    def squeeze(x):
        x = np.asarray(x)
        return x[..., 0] if x.ndim == 4 else x

    a, f, b = squeeze(real_a), squeeze(fake_b), squeeze(real_b)
    n = min(a.shape[0], max_rows)
    rows = [np.concatenate([a[i], f[i], b[i]], axis=1) for i in range(n)]
    grid = np.concatenate(rows, axis=0)
    img = (np.clip(grid, 0.0, 1.0) * 255).astype(np.uint8)
    Image.fromarray(img).save(path, quality=92)
