"""K2 and K3: InstanceNorm (+ReLU) (+reflect pad) over H, W of an NHWC
tensor, and its backward.

K2 replaces ``instance_norm_pallas`` (ducosy_tpu/ops/pallas/
instance_norm.py:206, forward with ``relu`` and ``pad``). On the serving
path it normalizes down1 (N, 256, 256, 128) and down2 (N, 128, 128, 256);
the down2 call also writes the trunk's first reflect pad, giving
(N, 130, 130, 256). On the training trunk it is each block's first norm
(ReLU, pad 1). Its K2p options: ``phases`` pools the statistics over
space-to-depth phase groups (channel = phase * C + c; on no serving path),
and ``instance_norm_int8`` writes shifted-grid int8 for an int8 conv (each
block's first norm of the tail trunk under quantized serving).

K3 replaces ``instance_norm_bwd_pallas`` (instance_norm.py:297), the
backward of that training-trunk norm. ``instance_norm_fused`` is the
differentiable op: K2 forward, K3 backward, saving only x and recomputing
the fp32 statistics, as the JAX ``instance_norm_fused`` custom VJP does
(instance_norm.py:406-469).

The kernels (``csrc/instance_norm.cu``, ``csrc/instance_norm_bwd.cu``) are
CUDA C++ and share their statistics code with K1. The ``*_plain``
functions are the same math in plain PyTorch: the TPU package's XLA
composition (fp32 centred statistics, eps 1e-5, no affine; the int8 write
quantizes the value rounded to the io dtype) and its analytic backward
(instance_norm.py:456-466).
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
from ducosy_tpu_torch.ops.quant import (
    INT8_GRID,
    INT8_NORM_SCALE,
    quantize_shifted,
)

TILE_M = 128   # pixels per statistics tile (csrc/common.cuh)
TILE_N = 64    # channels per tile; C must be a multiple


def _normalize_phases(x: torch.Tensor, phases: int, eps: float):
    """IN of an NHWC tensor in fp32, statistics pooled over (H, W) and, when
    phases > 1, over the phase groups of the packed channel axis (channel =
    phase * C + c), as ``_phase_stats`` (instance_norm.py:333-346)."""
    if phases == 1:
        return _instance_norm(x, eps).to(torch.float32)
    n, h, w, cf = x.shape
    g = x.to(torch.float32).reshape(n, h, w, phases, cf // phases)
    gc = g - g.mean(dim=(1, 2, 3), keepdim=True)
    inv = torch.reciprocal(torch.sqrt(gc.square().mean(dim=(1, 2, 3),
                                                       keepdim=True) + eps))
    return (gc * inv).reshape(n, h, w, cf)


def instance_norm_plain(x: torch.Tensor, *, relu: bool = False, pad: int = 0,
                        phases: int = 1,
                        eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """Plain PyTorch K2: IN (fp32 stats, pooled over ``phases`` groups),
    optional ReLU, rounded to x's dtype, reflect pad (``_xla_forward``,
    instance_norm.py:349-359)."""
    y = _normalize_phases(x, phases, eps)
    if relu:
        y = torch.relu(y)
    return reflect_pad(y.to(x.dtype), pad)


def instance_norm_int8_plain(x: torch.Tensor, *, pad: int = 0,
                             scale: float = INT8_NORM_SCALE, phases: int = 1,
                             eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """Plain PyTorch K2 with ``int8_scale``: IN + ReLU rounded to x's dtype,
    reflect-padded, then the shifted-grid quantize in fp32 (the XLA path of
    ``instance_norm_int8``, instance_norm.py:384-403)."""
    return quantize_shifted(instance_norm_plain(x, relu=True, pad=pad,
                                                phases=phases, eps=eps),
                            scale)


@functools.cache
def _lib() -> ctypes.CDLL:
    dll = _build.load_library("instance_norm")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.ducosy_instance_norm.restype = i
    dll.ducosy_instance_norm.argtypes = [p] * 6 + [i] * 7 + [f, f, i, p]
    return dll


def _validate(x: torch.Tensor, pad: int, phases: int = 1) -> None:
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
    if phases < 1 or c % phases:
        raise ValueError(f"instance_norm kernel: phases={phases} must divide "
                         f"C={c}")


def _launch(x: torch.Tensor, out: torch.Tensor, relu: bool, pad: int,
            phases: int, int8_k: float, eps: float) -> None:
    n, h, w, c = x.shape
    tiles = -(-h * w // TILE_M)
    f32 = dict(dtype=torch.float32, device=x.device)
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
            phases, int8_k, float(eps), int(x.dtype == torch.bfloat16),
            stream)
    _build.check(dll, status, "instance_norm kernel launch")


def instance_norm(x: torch.Tensor, *, relu: bool = False, pad: int = 0,
                  phases: int = 1,
                  eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """IN(+ReLU) of an NHWC tensor, reflect-padded by ``pad``, statistics
    pooled over ``phases`` channel groups: the K2 kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return instance_norm_plain(x, relu=relu, pad=pad, phases=phases,
                                   eps=eps)
    _validate(x, pad, phases)
    n, h, w, c = x.shape
    out = torch.empty((n, h + 2 * pad, w + 2 * pad, c), dtype=x.dtype,
                      device=x.device)
    _launch(x, out, relu, pad, phases, 0.0, eps)
    instance_norm.launches += 1
    return out


instance_norm.launches = 0


def instance_norm_int8(x: torch.Tensor, *, pad: int = 0,
                       scale: float = INT8_NORM_SCALE, phases: int = 1,
                       eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """IN + ReLU of an NHWC tensor, reflect-padded by ``pad``, written int8
    on the shifted grid at the static scale (``instance_norm_int8``,
    instance_norm.py:384): the K2 kernel's int8 write for a CUDA tensor, the
    plain version for a CPU tensor. Counted apart from ``instance_norm``."""
    if x.device.type == "cpu":
        return instance_norm_int8_plain(x, pad=pad, scale=scale,
                                        phases=phases, eps=eps)
    _validate(x, pad, phases)
    n, h, w, c = x.shape
    out = torch.empty((n, h + 2 * pad, w + 2 * pad, c), dtype=torch.int8,
                      device=x.device)
    _launch(x, out, True, pad, phases, INT8_GRID / scale, eps)
    instance_norm_int8.launches += 1
    return out


instance_norm_int8.launches = 0


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
