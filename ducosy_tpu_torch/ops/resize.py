"""Antialiased bilinear resize with ``jax.image.resize`` semantics
(ducosy_tpu/ops/resize.py:14-23).

``F.interpolate(mode="bilinear", antialias=True)`` is not the same
operator: jax scales the triangle kernel by the downsampling factor and
renormalizes every output's weights, and drops samples that fall outside
the input. So each axis gets its own (out, in) weight matrix, built in
numpy exactly as ``jax._src.image.scale.compute_weight_mat`` builds it, and
applied with a matmul. The serving path needs it only when a slice is not
``img_size`` square.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=32)
def _linear_weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) weights of jax's 'linear' resize with antialias=True,
    computed in float32 as jax computes them. Callers must not modify the
    cached array."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), f32(1.0) - x / kernel_scale)     # (in, out)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = np.where(inside[None, :], w, 0.0)
    return np.ascontiguousarray(w.T).astype(f32)


def resize_hw(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize the trailing two dims (..., H, W) of a float tensor; axes whose
    size does not change are left untouched, as jax does."""
    h, w = x.shape[-2:]
    dt = x.dtype
    x = x.to(torch.float32)
    if h != out_h:
        mh = torch.from_numpy(_linear_weight_matrix(h, out_h)).to(x.device)
        x = torch.matmul(mh, x)
    if w != out_w:
        mw = torch.from_numpy(_linear_weight_matrix(w, out_w)).to(x.device)
        x = torch.matmul(x, mw.T)
    return x.to(dt)
