"""NHWC building blocks with the reference semantics
(ducosy_tpu/models/layers.py:22-84).

Public functions take and return NHWC tensors, as the JAX package does.
Convolutions go through ``F.conv2d`` on the NCHW view of an NHWC tensor,
which is ``channels_last`` memory, so no copy is made on either side.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPS_INSTANCE_NORM = 1e-5


def instance_norm(x: torch.Tensor, eps: float = EPS_INSTANCE_NORM):
    """Parameter-free InstanceNorm over H, W of an NHWC tensor: fp32
    statistics, biased (centred) variance, no affine; cast back to x's
    dtype (torch nn.InstanceNorm2d defaults)."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
    y = (x32 - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return y.to(x.dtype)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """nn.ReflectionPad2d(pad) on NHWC."""
    if pad == 0:
        return x
    y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    return y.permute(0, 2, 3, 1)


def reflect_pad_adjoint(g: torch.Tensor, pad: int) -> torch.Tensor:
    """Adjoint of ``reflect_pad`` on NHWC: the border of g folds back onto
    the mirrored interior rows and columns
    (ducosy_tpu/ops/pallas/instance_norm.py:362-381). Not differentiable
    itself (it is used inside backward passes)."""
    if pad == 0:
        return g

    def fold(t, dim):
        n = t.shape[dim]
        core = t.narrow(dim, pad, n - 2 * pad).clone()
        h = core.shape[dim]
        core.narrow(dim, 1, pad).add_(t.narrow(dim, 0, pad).flip(dim))
        core.narrow(dim, h - 1 - pad, pad).add_(
            t.narrow(dim, n - pad, pad).flip(dim))
        return core

    return fold(fold(g, 1), 2)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """where(x >= 0, x, slope * x): the JAX package's form, whose gradient
    at 0 is 1 (ducosy_tpu/models/layers.py:87-88)."""
    return torch.where(x >= 0, x, negative_slope * x)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode='nearest') on NHWC."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
        n, 2 * h, 2 * w, c)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias=None, *,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Zero-padded conv of an NHWC tensor with a torch (O, I, kh, kw)
    weight; returns NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1)
