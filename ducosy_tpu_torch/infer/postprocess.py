"""3-D CT volume postprocess on torch tensors
(ducosy_tpu/infer/postprocess.py; reference modules/postprocess.py:6-300).

``postprocess_ct_volume`` smooths a (Z, H, W) stored-value volume along z
with one of six methods, optionally blends the original's high
frequencies back in (unsharp masking), restores the voxels >=
``hu_threshold`` from the original and casts to int16:
  gaussian      z-axis 1-D gaussian (sigma)
  gaussian3d    separable 3-D gaussian (sigma_z, sigma_xy); the serving
                path's method (``synthesis.synthesize_volume``)
  adaptive      z gaussian (base_sigma), then a (max_sigma, 0.3, 0.3) one
  median        z-axis median (kernel_size, symmetric z pad)
  interpolation cubic-spline z resample, on the host with scipy
  kalman        per-voxel 1-D kalman filter along z, a loop over slices
Every method but interpolation's spline runs on the volume's device in fp32.
"""
from __future__ import annotations

import numpy as np
import torch

from ducosy_tpu_torch.ops.filters import gaussian_filter_1d, gaussian_filter_3d

# The reference thresholds STORED values, not HU: its synthesis feeds raw
# pixel arrays into postprocess_ct_volume's `volume >= 750` check
# (generate.py:213-263, postprocess.py:50).
RESTORE_THRESHOLD = 750.0

METHODS = ("gaussian", "gaussian3d", "adaptive", "median", "interpolation",
           "kalman")
# the JAX package's keyword defaults (ducosy_tpu/infer/postprocess.py:150-164)
DEFAULTS = {"sigma": 1.0, "sigma_z": 2.0, "sigma_xy": 0.5, "base_sigma": 1.5,
            "max_sigma": 3.0, "kernel_size": 3, "process_variance": 1e-5,
            "measurement_variance": 1e-2, "sharpen_amount": 0.5,
            "sharpen_radius": 1.0}


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


def adaptive_smooth(volume, base_sigma=1.5, max_sigma=3.0):
    """z-gaussian(base_sigma), then a (max_sigma, 0.3, 0.3) 3-D gaussian
    (modules/postprocess.py:163-201)."""
    out = gaussian_filter_1d(volume.to(torch.float32), base_sigma, axis=0)
    return gaussian_filter_3d(out, (max_sigma, 0.3, 0.3))


def median_filter_z(volume, kernel_size=3):
    """Median of each voxel's kernel_size z-neighbours, the z axis padded
    symmetrically (edge slice repeated); for an even size the mean of the
    two middle values, as ``jnp.median``."""
    z = volume.shape[0]
    r = kernel_size // 2
    idx = np.pad(np.arange(z), (r, r), mode="symmetric")
    idx = torch.from_numpy(idx).to(volume.device)
    stacked = torch.stack([volume.index_select(0, idx[i:i + z])
                           for i in range(kernel_size)])
    srt = stacked.sort(dim=0).values
    mid = kernel_size // 2
    if kernel_size % 2:
        return srt[mid]
    return (srt[mid - 1] + srt[mid]) / 2


def kalman_filter_z(volume, process_variance=1e-5, measurement_variance=1e-2):
    """Per-voxel 1-D kalman filter along z (modules/postprocess.py:204-272):
    the state is one (H, W) estimate and its variance, stepped slice by
    slice on the device."""
    vol = volume.to(torch.float32)
    x_est, p_est = vol[0], torch.ones_like(vol[0])
    out = torch.empty_like(vol)
    for i in range(vol.shape[0]):
        p_pred = p_est + process_variance
        gain = p_pred / (p_pred + measurement_variance)
        x_est = x_est + gain * (vol[i] - x_est)
        p_est = (1.0 - gain) * p_pred
        out[i] = x_est
    return out


def interpolation_resample(volume: np.ndarray) -> np.ndarray:
    """Cubic z-spline resample (modules/postprocess.py:71-88) on the host
    with scipy, all pixels at once, in float64."""
    from scipy.interpolate import CubicSpline

    n = volume.shape[0]
    flat = np.asarray(volume, np.float64).reshape(n, -1)
    cs = CubicSpline(np.arange(n), flat, axis=0, extrapolate=True)
    return cs(np.linspace(0, n - 1, n * 2))[::2].reshape(volume.shape)


def postprocess_ct_volume(volume, method: str = "gaussian3d",
                          enhance_sharpness: bool = True,
                          hu_threshold: float = RESTORE_THRESHOLD, **kwargs):
    """postprocess_ct_volume (modules/postprocess.py:6-111) of a (Z, H, W)
    tensor (or numpy array, taken on the CPU): the int16 volume on the
    input's device. Keywords and their defaults as ``DEFAULTS``; the cast
    truncates toward zero."""
    if method not in METHODS:
        raise ValueError(
            f"Unknown method: {method}. Choose from {sorted(METHODS)}")
    unknown = set(kwargs) - set(DEFAULTS)
    if unknown:
        raise TypeError(f"unknown postprocess keywords {sorted(unknown)}")
    kw = {**DEFAULTS, **kwargs}
    original = torch.as_tensor(volume).to(torch.float32)
    if method == "gaussian":
        out = gaussian_filter_1d(original, kw["sigma"], axis=0)
    elif method == "gaussian3d":
        out = gaussian_filter_3d(original, (kw["sigma_z"], kw["sigma_xy"],
                                            kw["sigma_xy"]))
    elif method == "adaptive":
        out = adaptive_smooth(original, kw["base_sigma"], kw["max_sigma"])
    elif method == "median":
        out = median_filter_z(original, int(kw["kernel_size"]))
    elif method == "kalman":
        out = kalman_filter_z(original, kw["process_variance"],
                              kw["measurement_variance"])
    else:   # interpolation: scipy on the host, float64, back as fp32
        host = interpolation_resample(original.cpu().numpy())
        out = torch.from_numpy(host.astype(np.float32)).to(original.device)
    if enhance_sharpness:
        out = unsharp_mask(out, original, amount=kw["sharpen_amount"],
                           radius=kw["sharpen_radius"])
    out = torch.where(original >= hu_threshold, original, out)
    return out.to(torch.int16)


def apply_diffmap(volume, diff_volume, threshold: float = 8.0):
    """Add a thresholded HU difference map (modules/postprocess.py:275-300,
    the dormant nmodel path), on numpy arrays as the JAX package does.

    The uint8 cast is reference parity (postprocess.py:297): a delta above
    255 wraps around and a fraction truncates toward zero; it is a wrap,
    not a clip."""
    volume = np.asarray(volume)
    diff = np.asarray(diff_volume).copy()
    diff[diff < threshold] = 0
    return volume + diff.astype(np.uint8)
