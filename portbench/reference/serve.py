"""The serving pipeline in plain float32 PyTorch (qqaazz0222/DuCoSy-GAN,
generate.py:137-263, modules/postprocess.py:6-111): a patient's stored
int16 slices to the final int16 series.

  1. HU = stored * slope + intercept; each range's window clipped and
     mapped linearly to [-1, 1];
  2. both generators (``nets.generator``), in blocks of slices;
  3. each output back to HU and to stored values (no rounding); the
     composite starts from the raw stored values, the soft-tissue output
     overwrites the voxels whose raw HU lies in its window, then the lung
     output those in its own;
  4. a z gaussian (pre_z_sigma), then gaussian3d (sigma_z, sigma_xy) with
     unsharp masking (amount, radius; clipped to the volume's range), the
     voxels whose z-smoothed value is >= the restore threshold (stored
     units) keep it, and the cast to int16 truncates toward zero.
Gaussians are scipy.ndimage's: a kernel of radius int(4 sigma + 0.5) and
the 'reflect' boundary (the edge sample repeated).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.nets import generator


def gaussian_1d(vol: torch.Tensor, sigma: float, dim: int) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter1d along ``dim`` (reflect boundary)."""
    if sigma <= 0:
        return vol
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = torch.tensor(k / k.sum(), dtype=torch.float32, device=vol.device)
    n = vol.shape[dim]
    idx = np.pad(np.arange(n), radius, mode="symmetric")
    padded = vol.index_select(dim, torch.from_numpy(idx).to(vol.device))
    out = torch.zeros_like(vol)
    for t in range(2 * radius + 1):
        out += k[t] * padded.narrow(dim, t, n)
    return out


def gaussian_3d(vol, sigmas):
    for dim, s in enumerate(sigmas):
        vol = gaussian_1d(vol, s, dim)
    return vol


def postprocess(merged: torch.Tensor, pp: dict) -> torch.Tensor:
    original = gaussian_1d(merged, pp["pre_z_sigma"], 0)
    smooth = gaussian_3d(original, (pp["sigma_z"], pp["sigma_xy"],
                                    pp["sigma_xy"]))
    a, r = pp["sharpen_amount"], pp["sharpen_radius"]
    high = smooth - gaussian_3d(smooth, (0.0, r, r))
    orig_high = original - gaussian_3d(original, (0.0, r, r))
    sharp = smooth + ((1 - a) * high + a * orig_high) * a
    sharp = torch.clamp(sharp, original.min(), original.max())
    out = torch.where(original >= pp["restore_threshold"], original, sharp)
    return out.to(torch.int16)


def serve_patient(stored: np.ndarray, st_params, lung_params, cfg: dict,
                  device, block: int = 16, conv=F.conv2d) -> np.ndarray:
    """The final int16 series of one patient, (Z, H, W) int16 on the
    host, computed ``block`` slices at a time on ``device``."""
    slope, inter = cfg["rescale"]["slope"], cfg["rescale"]["intercept"]
    st, lung = cfg["ranges"]["soft_tissue"], cfg["ranges"]["lung"]
    merged = torch.empty(stored.shape, dtype=torch.float32, device=device)
    with torch.no_grad():
        for lo in range(0, len(stored), block):
            raw = torch.from_numpy(np.ascontiguousarray(
                stored[lo:lo + block])).to(device).float()
            hu = raw * slope + inter
            out = raw
            for rng, p in ((st, st_params), (lung, lung_params)):
                lo_hu, hi_hu = rng["hu_min"], rng["hu_max"]
                x = 2 * (hu.clamp(lo_hu, hi_hu) - lo_hu) / (hi_hu - lo_hu) - 1
                y = generator(p, x[:, None], conv)[:, 0]
                y_hu = (y + 1) / 2 * (hi_hu - lo_hu) + lo_hu
                inside = (hu >= lo_hu) & (hu <= hi_hu)
                out = torch.where(inside, (y_hu - inter) / slope, out)
            merged[lo:lo + block] = out
        return postprocess(merged, cfg["postprocess"]).cpu().numpy()
