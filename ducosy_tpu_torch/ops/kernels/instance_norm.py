"""K2 and K3: InstanceNorm (+ReLU) (+reflect pad) over H, W of an NHWC
tensor, and its backward.

K2 replaces ``instance_norm_pallas`` (ducosy_tpu/ops/pallas/
instance_norm.py:206, forward with ``relu`` and ``pad``). On the serving
path it normalizes down1 (N, 256, 256, 128) and down2 (N, 128, 128, 256);
the down2 call also writes the trunk's first reflect pad, giving
(N, 130, 130, 256). On the training trunk it is each block's first norm
(ReLU, pad 1).

K3 replaces ``instance_norm_bwd_pallas`` (instance_norm.py:297), the
backward of that training-trunk norm. ``instance_norm_fused`` is the
differentiable op: K2 forward, K3 backward, saving only x and recomputing
the fp32 statistics, as the JAX ``instance_norm_fused`` custom VJP does
(instance_norm.py:406-469).

The kernels (``csrc/instance_norm.cu``, ``csrc/instance_norm_bwd.cu``) are
CUDA C++ and share their statistics code with K1. The ``*_plain``
functions are the same math in plain PyTorch: the TPU package's XLA
composition (fp32 centred statistics, eps 1e-5, no affine) and its
analytic backward (instance_norm.py:456-466).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ducosy_tpu_torch.models.layers import (
    EPS_INSTANCE_NORM,
    instance_norm as _instance_norm,
    reflect_pad,
    reflect_pad_adjoint,
)
from ducosy_tpu_torch.ops.kernels import _build

TILE_M = 128   # pixels per statistics tile (csrc/common.cuh)
TILE_N = 64    # channels per tile; C must be a multiple


def instance_norm_plain(x: torch.Tensor, *, relu: bool = False, pad: int = 0,
                        eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """Plain PyTorch K2: IN (fp32 stats), optional ReLU, reflect pad."""
    y = _instance_norm(x, eps)
    if relu:
        y = torch.relu(y)
    return reflect_pad(y, pad)


@functools.cache
def _lib() -> ctypes.CDLL:
    dll = _build.load_library("instance_norm")
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.ducosy_instance_norm.restype = i
    dll.ducosy_instance_norm.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                         ctypes.c_float, i, p]
    return dll


def _validate(x: torch.Tensor, pad: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm kernel: tensor on {x.device}; the "
                         "kernel takes CUDA tensors (CPU runs the plain path)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"instance_norm kernel: dtype {x.dtype} (float32 or "
                        "bfloat16 only)")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("instance_norm kernel: needs a contiguous NHWC tensor")
    n, h, w, c = x.shape
    if c % TILE_N or c == 0:
        raise ValueError(f"instance_norm kernel: C={c} must be a positive "
                         f"multiple of {TILE_N}")
    if pad not in (0, 1) or (pad and min(h, w) < 2):
        raise ValueError(f"instance_norm kernel: pad={pad} on {h}x{w} "
                         "(pad 0 or 1, reflect needs H, W >= 2)")


def instance_norm(x: torch.Tensor, *, relu: bool = False, pad: int = 0,
                  eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """IN(+ReLU) of an NHWC tensor, reflect-padded by ``pad``: the K2 kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return instance_norm_plain(x, relu=relu, pad=pad, eps=eps)
    _validate(x, pad)
    n, h, w, c = x.shape
    tiles = -(-h * w // TILE_M)
    f32 = dict(dtype=torch.float32, device=x.device)
    out = torch.empty((n, h + 2 * pad, w + 2 * pad, c), dtype=x.dtype,
                      device=x.device)
    pmean = torch.empty((n, tiles, c), **f32)
    pm2 = torch.empty((n, tiles, c), **f32)
    mean = torch.empty((n, c), **f32)
    rstd = torch.empty((n, c), **f32)
    dll = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = dll.ducosy_instance_norm(
            x.data_ptr(), out.data_ptr(), pmean.data_ptr(), pm2.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), n, h, w, c, int(relu), pad,
            float(eps), int(x.dtype == torch.bfloat16), stream)
    _build.check(dll, status, "instance_norm kernel launch")
    instance_norm.launches += 1
    return out


instance_norm.launches = 0


def instance_norm_bwd_plain(x: torch.Tensor, g: torch.Tensor, *,
                            relu: bool = False, pad: int = 0,
                            eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """Plain PyTorch K3: dL/dx of ``instance_norm_plain`` given the
    cotangent g of its (pad-folded) output, in fp32, cast to x's dtype."""
    g32 = reflect_pad_adjoint(g.to(torch.float32), pad)
    x32 = x.to(torch.float32)
    xc = x32 - x32.mean(dim=(1, 2), keepdim=True)
    inv = torch.rsqrt(xc.square().mean(dim=(1, 2), keepdim=True) + eps)
    y = xc * inv                               # pre-ReLU normalized value
    if relu:
        g32 = g32 * (y > 0)
    mg = g32.mean(dim=(1, 2), keepdim=True)
    mgy = (g32 * y).mean(dim=(1, 2), keepdim=True)
    return ((g32 - mg - y * mgy) * inv).to(x.dtype)


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    dll = _build.load_library("instance_norm_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.ducosy_instance_norm_bwd.restype = i
    dll.ducosy_instance_norm_bwd.argtypes = [p] * 11 + [i] * 6 + [
        ctypes.c_float, i, p]
    return dll


def instance_norm_bwd(x: torch.Tensor, g: torch.Tensor, *, relu: bool = False,
                      pad: int = 0,
                      eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """dL/dx of ``instance_norm`` from the saved input x (N, H, W, C) and
    the output cotangent g (N, H+2p, W+2p, C): the K3 kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return instance_norm_bwd_plain(x, g, relu=relu, pad=pad, eps=eps)
    _validate(x, pad)
    n, h, w, c = x.shape
    if g.shape != (n, h + 2 * pad, w + 2 * pad, c) or g.dtype != x.dtype \
            or g.device != x.device or not g.is_contiguous():
        raise ValueError(f"instance_norm_bwd kernel: g {tuple(g.shape)} "
                         f"{g.dtype} on {g.device}; expected a contiguous "
                         f"{(n, h + 2 * pad, w + 2 * pad, c)} {x.dtype} "
                         f"tensor on {x.device}")
    tiles = -(-h * w // TILE_M)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    part = torch.empty((4, n, tiles, c), **f32)
    stats = torch.empty((4, n, c), **f32)
    dll = _bwd_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = dll.ducosy_instance_norm_bwd(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(),
            *(t.data_ptr() for t in part), *(t.data_ptr() for t in stats),
            n, h, w, c, int(relu), pad, float(eps),
            int(x.dtype == torch.bfloat16), stream)
    _build.check(dll, status, "instance_norm_bwd kernel launch")
    instance_norm_bwd.launches += 1
    return dx


instance_norm_bwd.launches = 0


class _InstanceNormFn(torch.autograd.Function):
    """K2 forward, K3 backward; saves only x (the backward recomputes the
    statistics)."""

    @staticmethod
    def forward(ctx, x, relu, pad, eps):
        ctx.save_for_backward(x)
        ctx.cfg = (relu, pad, eps)
        return instance_norm(x, relu=relu, pad=pad, eps=eps)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        relu, pad, eps = ctx.cfg
        dx = instance_norm_bwd(x, g.contiguous(), relu=relu, pad=pad, eps=eps)
        return dx, None, None, None


def instance_norm_fused(x: torch.Tensor, relu: bool = False, pad: int = 0,
                        eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """Differentiable IN(+ReLU)(+reflect pad) of an NHWC tensor: K2 forward
    and K3 backward on the card, the plain versions on the CPU."""
    return _InstanceNormFn.apply(x.contiguous(), relu, pad, eps)
