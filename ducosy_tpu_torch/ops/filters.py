"""scipy.ndimage-compatible gaussian filters as fp32 matmuls
(ducosy_tpu/ops/filters.py:129-228).

Each 1-D filter is a dense (n, n) operator with the kernel AND scipy's
'reflect' boundary folded in, built once in numpy and applied with
``torch.tensordot`` — the same decomposition the JAX package hands to XLA.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _gaussian_kernel_1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy-compatible normalized kernel of radius int(truncate*sigma+0.5);
    sigma <= 0 gives the identity kernel."""
    if sigma <= 0:
        return np.ones((1,), dtype=np.float32)
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@lru_cache(maxsize=64)
def _gaussian_matrix(n: int, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """(n, n) operator M with M @ x == scipy gaussian_filter1d(x) under the
    'reflect' (numpy 'symmetric') boundary, applied iteratively for radii
    wider than the axis. Callers must not modify the cached array."""
    kern = _gaussian_kernel_1d(sigma, truncate).astype(np.float64)
    r = len(kern) // 2
    pad = np.eye(n, dtype=np.float64)
    rem = r
    while rem > 0:
        step = min(rem, pad.shape[0])
        pad = np.pad(pad, ((step, step), (0, 0)), mode="symmetric")
        rem -= step
    m = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        m[i] = kern @ pad[i:i + len(kern)]
    return m.astype(np.float32)


def _apply_axis_matrix(vol: torch.Tensor, m: np.ndarray, axis: int):
    """out[... i ...] = sum_j m[i, j] vol[... j ...], in fp32."""
    mt = torch.from_numpy(m).to(vol.device)
    out = torch.tensordot(mt, vol.to(torch.float32).movedim(axis, 0),
                          dims=([1], [0]))
    return out.movedim(0, axis).to(vol.dtype)


def gaussian_filter_1d(vol: torch.Tensor, sigma: float, axis: int = 0,
                       truncate: float = 4.0) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter1d (reflect boundary)."""
    if sigma <= 0:
        return vol
    m = _gaussian_matrix(int(vol.shape[axis]), float(sigma), truncate)
    return _apply_axis_matrix(vol, m, axis)


def gaussian_filter_3d(vol: torch.Tensor, sigmas, truncate: float = 4.0):
    """scipy.ndimage.gaussian_filter on a (Z, H, W) volume with per-axis
    sigmas, applied separably."""
    out = vol
    for axis, sigma in enumerate(sigmas):
        if sigma and sigma > 0:
            m = _gaussian_matrix(int(vol.shape[axis]), float(sigma), truncate)
            out = _apply_axis_matrix(out, m, axis)
    return out
