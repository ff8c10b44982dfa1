"""K2 and K3: InstanceNorm (+ReLU) (+reflect pad) over H, W of an NHWC
tensor, and its backward.

K2 replaces ``instance_norm_pallas`` (ducosy_tpu/ops/pallas/
instance_norm.py:206, forward with ``relu`` and ``pad``). On the serving
path (trunks chain and mega) it is every encoder and decoder norm with
ReLU: the stem and up2 (N, 512, 512, 64), down1 and up1 (N, 256, 256, 128)
and down2 (N, 128, 128, 256), whose call also writes the trunk's first
reflect pad, giving (N, 130, 130, 256). On the training trunk it is each
block's first norm (ReLU, pad 1). Its K2p options: ``phases`` pools the
statistics over space-to-depth phase groups (channel = phase * C + c; on no
serving path), and ``instance_norm_int8`` writes shifted-grid int8 for an
int8 conv (each block's first norm of the tail trunk under quantized
serving).

K2's 3-D route, ``instance_norm3d``, is every norm of the nnU-Net
``PlainConvUNet`` (``models/nnunet.py``): a contiguous channels-last volume
(N, D, H, W, C), C a multiple of 32, taken as (N, D*H, W, C), with an
optional per-channel affine and a LeakyReLU slope applied in the apply
launch. It shares the statistics launch and the plan; its apply is a kernel
of its own, so the 2-D route's launches are the code they were. It is
counted apart, ``instance_norm3d.launches``.

K2 is two launches: a block of the first reduces its tile of pixels x all
channels, and the last block of a sample to finish merges the sample's
tiles; the second normalizes. ``plan`` cuts the batch into the tiles from the
shape and the SM count (a pure function, so the CPU tests hold it).

K3 replaces ``instance_norm_bwd_pallas`` (instance_norm.py:297), the
backward of each training block's first norm. It runs three launches on
K2's plan, each after the first started early by programmatic dependent
launch: K2's own statistics launch, then the masked, folded gradient sums
(the last block of a sample merges them into mean(g) and mean(g*y)), then
the apply; every access is 16 bytes wide. ``probe_bwd`` reaches it by parts,
without programmatic dependent launch, and the original five launches, for
measurement only.

The kernels (``csrc/instance_norm.cu``, ``csrc/instance_norm_bwd.cu``, their
shared statistics launch in ``csrc/in_tiles.cuh``) are CUDA C++. The
``*_plain`` functions are the same math in plain PyTorch: the TPU package's
XLA composition (fp32 centred statistics, eps 1e-5, no affine; the int8
write quantizes the value rounded to the io dtype) and its analytic backward
(instance_norm.py:456-466).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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

TILE_M = 128   # pixels per tile of the original launches (csrc/common.cuh)
TILE_N = 64    # channels per tile; C must be a multiple

# K2's plan (csrc/instance_norm.cu): blocks of IN_THREADS threads, one
# statistics tile a block, as many samples at once as the card has SMs, each
# cut into at most MAX_TILES tiles of at least MIN_TILE pixels.
IN_THREADS = 512
MIN_TILE = 256
MAX_TILES = 128


class Plan(NamedTuple):
    group: int    # samples a pair of launches
    tiles: int    # tiles a sample (partials a channel)
    tile: int     # pixels a tile
    blocks: int   # the SM count


def plan(n: int, h: int, w: int, c: int, itemsize: int, sms: int,
         group_bytes: int | None = None) -> Plan:
    """K2's launch plan for x (n, h, w, c) of ``itemsize``-byte elements on
    a card with ``sms`` SMs. ``group_bytes`` caps a group's input (at least
    one sample): the L2-resident form that the by-parts reading measures
    beside the kernel's."""
    hw, blocks = h * w, sms
    group = min(n, blocks)
    if group_bytes is not None:
        group = max(1, min(group, group_bytes // (hw * c * itemsize)))
    tiles = max(1, min(MAX_TILES, blocks // group, -(-hw // MIN_TILE)))
    tile = -(-hw // tiles)
    return Plan(group, -(-hw // tile), tile, blocks)


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
    dll.ducosy_instance_norm.argtypes = [p] * 7 + [i] * 7 + [f, f] + \
        [i] * 5 + [p]
    dll.ducosy_instance_norm_probe.restype = i
    dll.ducosy_instance_norm_probe.argtypes = [p] * 7 + [i] * 13 + [p]
    dll.ducosy_instance_norm3d.restype = i
    dll.ducosy_instance_norm3d.argtypes = [p] * 9 + [i] * 3 + [f, f] + \
        [i] * 5 + [p]
    return dll


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_plan(x: torch.Tensor) -> Plan:
    """``plan`` for x on its card."""
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    return plan(*x.shape, x.element_size(), _sms(index))


def _validate(x: torch.Tensor, pad: int, phases: int = 1,
              k2: bool = False, g: torch.Tensor | None = None) -> None:
    """Refuse what the kernels do not take, shape first, then the device;
    ``k2`` adds the tile plan's limit on C (one block's 16-byte lanes), ``g``
    K3's cotangent of the (pad-folded) output."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"instance_norm kernel: dtype {x.dtype} (float32 or "
                        "bfloat16 only)")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("instance_norm kernel: needs a contiguous NHWC tensor")
    n, h, w, c = x.shape
    if c % TILE_N or c == 0:
        raise ValueError(f"instance_norm kernel: C={c} must be a positive "
                         f"multiple of {TILE_N}")
    cmax = IN_THREADS * 16 // x.element_size()
    if k2 and c > cmax:
        raise ValueError(f"instance_norm kernel: C={c} above {cmax} for "
                         f"{x.dtype}")
    if pad not in (0, 1) or (pad and min(h, w) < 2):
        raise ValueError(f"instance_norm kernel: pad={pad} on {h}x{w} "
                         "(pad 0 or 1, reflect needs H, W >= 2)")
    if phases < 1 or c % phases:
        raise ValueError(f"instance_norm kernel: phases={phases} must divide "
                         f"C={c}")
    want = (n, h + 2 * pad, w + 2 * pad, c)
    if g is not None and (tuple(g.shape) != want or g.dtype != x.dtype
                          or g.device != x.device or not g.is_contiguous()):
        raise ValueError(f"instance_norm_bwd kernel: g {tuple(g.shape)} "
                         f"{g.dtype} on {g.device}; expected a contiguous "
                         f"{want} {x.dtype} tensor on {x.device}")
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm kernel: tensor on {x.device}; the "
                         "kernel takes CUDA tensors (CPU runs the plain path)")


def _scratch(x: torch.Tensor, tiles: int) -> tuple:
    """Per-tile means and M2s (2, n, tiles, c) and per-sample mean and 1/std
    (2, n, c) in fp32, and an arrival counter a sample (zeroed by the
    call)."""
    n, c = x.shape[0], x.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty((2, n, tiles, c), **f32),
            torch.empty((2, n, c), **f32),
            torch.empty((n,), dtype=torch.int32, device=x.device))


def _launch(x: torch.Tensor, out: torch.Tensor, relu: bool, pad: int,
            phases: int, int8_k: float, eps: float) -> None:
    n, h, w, c = x.shape
    pl = device_plan(x)
    part, stats, done = _scratch(x, pl.tiles)
    dll = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = dll.ducosy_instance_norm(
            x.data_ptr(), out.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
            done.data_ptr(), n, h, w, c, int(relu), pad, phases, int8_k,
            float(eps), pl.group, pl.tiles, pl.tile, pl.blocks,
            int(x.dtype == torch.bfloat16), stream)
    _build.check(dll, status, "instance_norm kernel launch")


def probe(x: torch.Tensor, design: int, parts: int, *, relu: bool = True,
          pad: int = 0, pl: Plan | None = None) -> torch.Tensor:
    """K2 by parts, for measurement only (io-dtype write, phases 1; not
    counted): ``design`` 1 is the kernel above (``parts`` 1 the tile
    statistics, 2 their merge, 4 the apply), 2 the same with each launch
    after the one before it (no programmatic dependent launch), 0 the
    original three launches (1 the 128 x 64 tile statistics, 2 the serial
    finalize, 4 the per-pixel apply). ``pl`` replaces the plan of designs 1
    and 2.
    Returns the output (meaningful with parts 7 only)."""
    _validate(x, pad, k2=True)
    if design not in (0, 1, 2) or not 1 <= parts <= 7:
        raise ValueError(f"instance_norm probe: design {design} parts "
                         f"{parts} (design 0-2, parts 1-7)")
    n, h, w, c = x.shape
    pl = pl or device_plan(x)
    part, stats, done = _scratch(x, pl.tiles if design
                                 else -(-h * w // TILE_M))
    out = torch.empty((n, h + 2 * pad, w + 2 * pad, c), dtype=x.dtype,
                      device=x.device)
    dll = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = dll.ducosy_instance_norm_probe(
            x.data_ptr(), out.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
            done.data_ptr(), n, h, w, c, int(relu), pad, design, parts,
            pl.group, pl.tiles, pl.tile, pl.blocks,
            int(x.dtype == torch.bfloat16), stream)
    _build.check(dll, status, "instance_norm probe launch")
    return out


def instance_norm(x: torch.Tensor, *, relu: bool = False, pad: int = 0,
                  phases: int = 1,
                  eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """IN(+ReLU) of an NHWC tensor, reflect-padded by ``pad``, statistics
    pooled over ``phases`` channel groups: the K2 kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return instance_norm_plain(x, relu=relu, pad=pad, phases=phases,
                                   eps=eps)
    _validate(x, pad, phases, k2=True)
    n, h, w, c = x.shape
    out = torch.empty((n, h + 2 * pad, w + 2 * pad, c), dtype=x.dtype,
                      device=x.device)
    _launch(x, out, relu, pad, phases, 0.0, eps)
    instance_norm.launches += 1
    instance_norm.phase_launches += phases > 1
    return out


instance_norm.launches = 0
instance_norm.phase_launches = 0    # those of them with phases > 1 (K2p)


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
    _validate(x, pad, phases, k2=True)
    n, h, w, c = x.shape
    out = torch.empty((n, h + 2 * pad, w + 2 * pad, c), dtype=torch.int8,
                      device=x.device)
    _launch(x, out, True, pad, phases, INT8_GRID / scale, eps)
    instance_norm_int8.launches += 1
    return out


instance_norm_int8.launches = 0


TILE_3D = 32   # the 3-D route's C must be a multiple


def instance_norm3d_plain(x: torch.Tensor, weight: torch.Tensor | None = None,
                          bias: torch.Tensor | None = None, *,
                          negative_slope: float = 0.0,
                          eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """Plain PyTorch K2 3-D: IN of x (N, D, H, W, C) over D, H, W (fp32
    centred statistics, biased variance), ``* weight + bias`` per channel
    when given, LeakyReLU at ``negative_slope`` (0: ReLU, 1: none), rounded
    to x's dtype once."""
    x32 = x.to(torch.float32)
    xc = x32 - x32.mean(dim=(1, 2, 3), keepdim=True)
    y = xc * torch.rsqrt(xc.square().mean(dim=(1, 2, 3), keepdim=True) + eps)
    if weight is not None:
        y = y * weight.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return torch.where(y > 0, y, y * negative_slope).to(x.dtype)


def _validate3d(x: torch.Tensor, weight, bias) -> None:
    """Refuse what the 3-D route does not take, shape first, then the
    device: a contiguous 5-D float32 or bfloat16 tensor, C a positive
    multiple of 32 up to one block's 16-byte lanes, fp32 (C,) affine
    vectors on x's device."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"instance_norm3d kernel: dtype {x.dtype} (float32 "
                        "or bfloat16 only)")
    if x.dim() != 5 or not x.is_contiguous():
        raise ValueError("instance_norm3d kernel: needs a contiguous NDHWC "
                         "tensor")
    c = x.shape[-1]
    if c % TILE_3D or c == 0:
        raise ValueError(f"instance_norm3d kernel: C={c} must be a positive "
                         f"multiple of {TILE_3D}")
    cmax = IN_THREADS * 16 // x.element_size()
    if c > cmax:
        raise ValueError(f"instance_norm3d kernel: C={c} above {cmax} for "
                         f"{x.dtype}")
    for name, v in (("weight", weight), ("bias", bias)):
        if v is not None and (tuple(v.shape) != (c,) or v.dtype !=
                              torch.float32 or v.device != x.device
                              or not v.is_contiguous()):
            raise ValueError(f"instance_norm3d kernel: {name} "
                             f"{tuple(v.shape)} {v.dtype} on {v.device}; "
                             f"expected a contiguous ({c},) float32 tensor "
                             f"on {x.device}")
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm3d kernel: tensor on {x.device}; the "
                         "kernel takes CUDA tensors (CPU runs the plain path)")


def instance_norm3d(x: torch.Tensor, weight: torch.Tensor | None = None,
                    bias: torch.Tensor | None = None, *,
                    negative_slope: float = 0.0,
                    eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """IN (+affine) (+LeakyReLU) of a channels-last volume x (N, D, H, W,
    C): K2's 3-D route for a CUDA tensor, the plain version for a CPU
    tensor. The kernel sees x as (N, D*H, W, C) on K2's plan."""
    if x.device.type == "cpu":
        return instance_norm3d_plain(x, weight, bias,
                                     negative_slope=negative_slope, eps=eps)
    _validate3d(x, weight, bias)
    n, d, h, w, c = x.shape
    pl = device_plan(x.view(n, d * h, w, c))
    part, stats, done = _scratch(x, pl.tiles)
    out = torch.empty_like(x)
    ptr = lambda v: None if v is None else v.data_ptr()
    dll = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = dll.ducosy_instance_norm3d(
            x.data_ptr(), out.data_ptr(), ptr(weight), ptr(bias),
            part[0].data_ptr(), part[1].data_ptr(), stats[0].data_ptr(),
            stats[1].data_ptr(), done.data_ptr(), n, d * h * w, c,
            float(negative_slope), float(eps), pl.group, pl.tiles, pl.tile,
            pl.blocks, int(x.dtype == torch.bfloat16), stream)
    _build.check(dll, status, "instance_norm3d kernel launch")
    instance_norm3d.launches += 1
    return out


instance_norm3d.launches = 0


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
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.ducosy_instance_norm_bwd.restype = i
    dll.ducosy_instance_norm_bwd.argtypes = [p] * 12 + [i] * 6 + [f] + \
        [i] * 4 + [p]
    dll.ducosy_instance_norm_bwd_probe.restype = i
    dll.ducosy_instance_norm_bwd_probe.argtypes = [p] * 12 + [i] * 6 + [f] + \
        [i] * 6 + [p]
    return dll


def _launch_bwd(x: torch.Tensor, g: torch.Tensor, relu: bool, pad: int,
                eps: float, probe: tuple[int, int] | None = None
                ) -> torch.Tensor:
    """dx from K3 on K2's plan for x, or with ``probe`` = (design, parts)
    through the by-parts entry point. Scratch, fp32: per-tile partials
    (4, n, tiles, c) (the statistics' means and M2s, then sum(g) and
    sum(g*y); design 0 has ceil(h*w / 128) tiles), per-sample mean, 1/std,
    mean(g), mean(g*y) (4, n, c); two arrival counters a sample (zeroed by
    the call)."""
    n, h, w, c = x.shape
    pl = device_plan(x)
    tiles = -(-h * w // TILE_M) if probe and probe[0] == 0 else pl.tiles
    part = x.new_empty((4, n, tiles, c), dtype=torch.float32)
    stats = x.new_empty((4, n, c), dtype=torch.float32)
    done = x.new_empty((2, n), dtype=torch.int32)
    dx = x.new_empty(x.shape)
    dll = _bwd_lib()
    args = (x.data_ptr(), g.data_ptr(), dx.data_ptr(),
            *(t.data_ptr() for t in part), *(t.data_ptr() for t in stats),
            done.data_ptr(), n, h, w, c, int(relu), pad, float(eps),
            pl.group, pl.tiles, pl.tile)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        bf16 = int(x.dtype == torch.bfloat16)
        if probe is None:
            status = dll.ducosy_instance_norm_bwd(*args, bf16, stream)
        else:
            status = dll.ducosy_instance_norm_bwd_probe(*args, *probe, bf16,
                                                        stream)
    _build.check(dll, status, "instance_norm_bwd kernel launch")
    return dx


def instance_norm_bwd(x: torch.Tensor, g: torch.Tensor, *, relu: bool = False,
                      pad: int = 0,
                      eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """dL/dx of ``instance_norm`` from the saved input x (N, H, W, C) and
    the output cotangent g (N, H+2p, W+2p, C): the K3 kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return instance_norm_bwd_plain(x, g, relu=relu, pad=pad, eps=eps)
    _validate(x, pad, k2=True, g=g)
    dx = _launch_bwd(x, g, relu, pad, eps)
    instance_norm_bwd.launches += 1
    return dx


instance_norm_bwd.launches = 0


def probe_bwd(x: torch.Tensor, g: torch.Tensor, design: int, parts: int, *,
              relu: bool = True, pad: int = 1,
              eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """K3 by parts, for measurement only (not counted): ``design`` 1 is the
    kernel (``parts`` 1 the statistics, 2 the gradient sums, each with its
    last-block merge, 4 the apply), 2 the same with each launch after the
    one before it (no programmatic dependent launch), 0 the original five
    launches (1 the 128 x 64 tile statistics and their serial finalize, 2
    the tile gradient sums and their serial merge, 4 the per-pixel apply).
    Returns dx (meaningful with parts 7 only)."""
    _validate(x, pad, k2=True, g=g)
    if design not in (0, 1, 2) or not 1 <= parts <= 7:
        raise ValueError(f"instance_norm_bwd probe: design {design} parts "
                         f"{parts} (design 0-2, parts 1-7)")
    return _launch_bwd(x, g, relu, pad, eps, probe=(design, parts))


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
