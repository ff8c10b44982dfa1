"""Image filters as fp32 matmuls (ducosy_tpu/ops/filters.py).

The loss suite's small filters (box blur, average pool, Sobel edges;
filters.py:20-126) and scipy.ndimage-compatible gaussians (:129-228). Each
1-D filter is a dense operator with the kernel and its boundary folded in,
built once in numpy and applied along H or W of an (N, H, W) tensor with a
matmul — the same decomposition the JAX package hands to XLA, so the sums
run in the same order up to the matmul's own.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ducosy_tpu_torch import trace


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
    """out[... i ...] = sum_j m[i, j] vol[... j ...], in fp32. The host
    matrix goes to the volume's device on every call (counted in
    ``filters.h2d_bytes``)."""
    trace.count("filters.h2d_bytes", m.nbytes)
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


def gaussian_blur_hw(x_nhwc: torch.Tensor, sigma: float,
                     truncate: float = 4.0) -> torch.Tensor:
    """Gaussian blur over H and W of an NHWC tensor, scipy's 'reflect'
    boundary (ducosy_tpu/ops/filters.py:231-236)."""
    if sigma <= 0:
        return x_nhwc
    for axis in (1, 2):
        m = _gaussian_matrix(int(x_nhwc.shape[axis]), float(sigma), truncate)
        x_nhwc = _apply_axis_matrix(x_nhwc, m, axis)
    return x_nhwc


# ------------------------------------------------------------ loss filters
def _toeplitz_zero(n: int, kernel: tuple) -> np.ndarray:
    """(n, n) correlation operator with zero boundary padding of k//2
    (torch conv2d / AvgPool2d count_include_pad semantics)."""
    r = len(kernel) // 2
    m = np.zeros((n, n), np.float64)
    for i in range(n):
        for t, kv in enumerate(kernel):
            j = i - r + t
            if 0 <= j < n:
                m[i, j] += kv
    return m


def _toeplitz_valid(n: int, kernel: tuple) -> np.ndarray:
    """(n - k + 1, n) VALID correlation operator (pytorch_msssim SSIM)."""
    k = len(kernel)
    m = np.zeros((n - k + 1, n), np.float64)
    for i in range(n - k + 1):
        m[i, i:i + k] = kernel
    return m


def _pool_matrix(n: int, k: int) -> np.ndarray:
    """(n // k, n) operator of a k-wide, stride-k average."""
    m = np.zeros((n // k, n), np.float64)
    for i in range(n // k):
        m[i, i * k:(i + 1) * k] = 1.0 / k
    return m


_BUILDERS = {"zero": _toeplitz_zero, "valid": _toeplitz_valid,
             "pool": _pool_matrix}


@lru_cache(maxsize=256)
def _operator(kind: str, n: int, arg, device: torch.device) -> torch.Tensor:
    """The fp32 operator of one axis on ``device``, built once."""
    m = _BUILDERS[kind](n, arg).astype(np.float32)
    return torch.from_numpy(m).to(device)


def apply_hw(x: torch.Tensor, h_op: tuple, w_op: tuple) -> torch.Tensor:
    """A separable filter on an (N, H, W) tensor in fp32: the operator
    (kind, arg) h_op along H, then w_op along W."""
    x = x.to(torch.float32)
    mh = _operator(h_op[0], x.shape[1], h_op[1], x.device)
    mw = _operator(w_op[0], x.shape[2], w_op[1], x.device)
    return mh @ x @ mw.T


def box_blur(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """AvgPool2d(k, stride=1, padding=k//2), count-include-pad
    (ContrastAttentionLoss, modules/trainer.py:60), of (N, H, W)."""
    kern = ("zero", tuple(np.full(kernel_size, 1.0 / kernel_size)))
    return apply_hw(x, kern, kern)


def avg_pool(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """AvgPool2d(k, stride=k) (ContrastRegionLoss, trainer.py:102) of
    (N, H, W)."""
    return apply_hw(x, ("pool", kernel_size), ("pool", kernel_size))


def sobel_edges(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Sobel magnitude sqrt(gx^2 + gy^2 + eps) with zero pad 1
    (ContrastEdgeLoss.get_edges, trainer.py:150-155) of (N, H, W), as
    separable matmuls: gx = smooth_H x diff_W, gy = diff_H x smooth_W."""
    smooth, diff = ("zero", (1.0, 2.0, 1.0)), ("zero", (-1.0, 0.0, 1.0))
    gx = apply_hw(x, smooth, diff)
    gy = apply_hw(x, diff, smooth)
    return torch.sqrt(gx * gx + gy * gy + eps)
