"""3-D CT volume postprocess on torch tensors
(ducosy_tpu/infer/postprocess.py:28-39, 91-113).

Only the serving path's method is ported: ``gaussian3d`` with unsharp
masking, the restore of stored values >= 750 from the original, and the
int16 cast. The other five methods (gaussian, adaptive, median,
interpolation, kalman) are listed in ROADMAP.md.
"""
from __future__ import annotations

import torch

from ducosy_tpu_torch.ops.filters import gaussian_filter_3d

# The reference thresholds STORED values, not HU: its synthesis feeds raw
# pixel arrays into postprocess_ct_volume's `volume >= 750` check
# (generate.py:213-263, postprocess.py:50).
RESTORE_THRESHOLD = 750.0


def unsharp_mask(smoothed, original, *, amount=0.5, radius=1.0):
    """XY-plane unsharp masking mixing the smoothed and the original high
    frequencies; clips to the original's range."""
    smoothed = smoothed.to(torch.float32)
    original = original.to(torch.float32)
    high = smoothed - gaussian_filter_3d(smoothed, (0.0, radius, radius))
    orig_high = original - gaussian_filter_3d(original, (0.0, radius, radius))
    combined = (1.0 - amount) * high + amount * orig_high
    sharpened = smoothed + combined * amount
    return torch.clamp(sharpened, original.min(), original.max())


def postprocess_volume(volume, *, sigma_z, sigma_xy, sharpen_amount,
                       sharpen_radius):
    """gaussian3d + unsharp on a (Z, H, W) stored-value volume, restore
    the voxels >= RESTORE_THRESHOLD from the original, cast to int16
    (truncation toward zero): ``_postprocess_impl(method="gaussian3d",
    enhance_sharpness=True)``."""
    original = volume.to(torch.float32)
    out = gaussian_filter_3d(original, (sigma_z, sigma_xy, sigma_xy))
    out = unsharp_mask(out, original, amount=sharpen_amount,
                       radius=sharpen_radius)
    out = torch.where(original >= RESTORE_THRESHOLD, original, out)
    return out.to(torch.int16)
