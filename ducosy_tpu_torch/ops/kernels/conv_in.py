"""K7 and K8: the two halves of a CBAM residual block, each a 3x3 conv
with a fused epilogue, on a reflect-padded NHWC input.

K7 ``conv3x3_in`` replaces ``conv3x3_in_pallas`` (ducosy_tpu/ops/pallas/
conv_in.py:119):
  act(IN(conv3x3_valid(xp, w))), reflect-padded by ``pad``; with
  ``int8_scale`` the fp32 normalized value is written as shifted-grid int8,
  quantized before the pad (conv_in.py:99-109). An int8 xp needs int8
  weights and runs exact int32 taps (conv_in.py:135-138).
K8 ``conv_block_tail`` replaces ``conv_block_tail_pallas`` (conv_in.py:231):
  x(interior) + CBAM(IN(conv3x3_valid(tp, w))), reflect-padded by ``pad``;
  x is the block's input, reflect-padded by ``x_pad``. With ``in_int8`` tp
  is K7's int8 write and w is int8, quantized per output channel by the
  caller (``ops.quant.quantize_weights_int8`` of the fp32 master weights,
  the grid the TPU wrapper quantizes in-graph, conv_in.py:252).
Conv biases are not inputs of the kernels: each conv feeds an InstanceNorm,
whose mean subtraction cancels a per-channel constant exactly.

The kernels are CUDA C++ (``csrc/conv_in.cu``), built from the launches K1
uses, and run by one of two routes that ``conv_route`` picks from the shape,
the dtype and the device's co-resident block count, never from a failure:
  "resident" (``csrc/conv_resident.cuh``): one cooperative launch; a
    sample's fp32 accumulator stays in the registers of the blocks that
    computed it, across a grid barrier, and the statistics' merge, the gates
    and the reflect-padded write are the conv kernel's epilogue. bf16 or
    int8 input, bf16 io, every tile of a sample on the card at once, and for
    K8 C = 64, 128 or 256.
  "tiled" (``csrc/conv3x3.cuh``, ``common.cuh``, ``cbam_tail.cuh``): the conv
    writes its fp32 accumulator and per-tile partials, and two more launches
    finalize and apply. fp32 and everything that does not fit.
Their scratch (``make_scratch``: the statistics partials, the resident
route's map and barrier words, the tiled route's fp32 accumulator) can be
made once and passed to every call of a trunk. ``conv3x3`` is the tiled conv
launch alone: the fp32 accumulator of the bf16 (wgmma), int8 (wgmma, exact
int32) or fp32 (exact FMA) loop.

The ``*_plain`` functions are the TPU package's XLA compositions
(``_xla_conv_in``, ``_xla_conv_tail``, conv_in.py:501-536) in plain PyTorch,
with optional conv biases. Under the int8 modes they keep the TPU kernel's
rounding points: K7's int8 write quantizes the fp32 normalized value of an
fp32 accumulator; K8's int8 conv is dequantized with ``w_scale`` to the io
dtype before the tail (the kernel needs no scale: the IN absorbs it).

Layouts are the JAX package's: w (3, 3, C, C) HWIO, w1 (C, R), w2 (R, C),
wsa (7, 7, 2, 1) HWIO.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ducosy_tpu_torch.models.layers import (
    EPS_INSTANCE_NORM,
    conv2d,
    instance_norm,
    reflect_pad,
)
from ducosy_tpu_torch.ops.kernels import _build
from ducosy_tpu_torch.ops.kernels.block_tail import (
    SA_KERNEL,
    block_tail_plain,
    hwio_to_oihw,
)
from ducosy_tpu_torch.ops.quant import (
    INT8_GRID,
    INT8_NORM_SCALE,
    INT8_ZERO_POINT,
    conv_int8_static,
    in_relu_int8,
    int_conv,
)

TILE_M = 128   # pixels per conv output / statistics tile (csrc/common.cuh)
TILE_N = 64    # channel granule of the tiles (csrc/common.cuh): C a multiple
_FLOAT = (torch.float32, torch.bfloat16)


def conv3x3_in_plain(xp, w, *, relu: bool = True, pad: int = 1,
                     int8_scale: float | None = None, bias=None,
                     eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """Plain PyTorch K7. Without int8 it is conv -> IN -> act -> pad in xp's
    dtype (``_xla_conv_in``). With ``int8_scale`` the io-dtype operands are
    accumulated in fp32 and the fp32 normalized value is quantized
    (conv_in.py:95-109). An int8 xp takes int8 w: the exact integer conv,
    normalized in fp32, then the int8 write or, without a scale, the value
    cast to int8 as the TPU kernel's ``astype`` (conv_in.py:111)."""
    if int8_scale is not None and not relu:
        raise ValueError("conv3x3_in: int8_scale requires relu=True "
                         "(non-negative outputs)")
    if xp.dtype == torch.int8:
        if w.dtype != torch.int8:
            raise TypeError("conv3x3_in: an int8 input requires int8 weights")
        acc = int_conv(xp, w).to(torch.float32)
        if int8_scale is not None:
            return in_relu_int8(acc, pad=pad, scale=int8_scale, eps=eps)
        y = instance_norm(acc, eps)
        y = torch.relu(y) if relu else y
        return reflect_pad(torch.clamp(torch.trunc(y), -128, 127)
                           .to(torch.int8), pad)
    dt = xp.dtype
    if int8_scale is not None:
        f32 = lambda a: a.to(dt).to(torch.float32)
        t = conv2d(xp.to(torch.float32), f32(hwio_to_oihw(w)),
                   None if bias is None else f32(bias))
        return in_relu_int8(t, pad=pad, scale=int8_scale, eps=eps)
    t = conv2d(xp, hwio_to_oihw(w).to(dt),
               None if bias is None else bias.to(dt))
    t = instance_norm(t, eps)
    return reflect_pad(torch.relu(t) if relu else t, pad)


def conv_block_tail_plain(tp, x, w, w1, w2, wsa, *, pad: int = 1,
                          x_pad: int = 1, in_int8: bool = False, w_scale=None,
                          bias=None, eps: float = EPS_INSTANCE_NORM):
    """Plain PyTorch K8: conv (in x's dtype), then ``block_tail_plain``
    (``_xla_conv_tail``). ``in_int8``: tp is shifted-grid int8 at
    ``INT8_NORM_SCALE`` and w int8 with its per-channel ``w_scale``; the
    exact integer conv is dequantized to x's dtype (conv_in.py:519-531)."""
    dt = x.dtype
    if in_int8:
        if tp.dtype != torch.int8 or w.dtype != torch.int8 or w_scale is None:
            raise ValueError("conv_block_tail in_int8: tp and w must be int8, "
                             "with w_scale")
        y = conv_int8_static(tp, w, w_scale, bias, INT8_NORM_SCALE, dtype=dt,
                             zero_point=INT8_ZERO_POINT)
    else:
        y = conv2d(tp.to(dt), hwio_to_oihw(w).to(dt),
                   None if bias is None else bias.to(dt))
    return block_tail_plain(y, x, w1, w2, wsa, pad=pad, x_pad=x_pad, eps=eps)


def conv3x3_plain(xp, w) -> torch.Tensor:
    """Plain PyTorch ``conv3x3``: the fp32 3x3 VALID conv of the pre-padded
    NHWC xp with HWIO w, (N, H, W, C) fp32. Float operands are rounded to
    xp's dtype and accumulated in fp32 (the conv of ``_xla_conv_in``,
    conv_in.py:501-510, before its IN); int8 xp with int8 w is the exact
    integer conv."""
    if xp.dtype == torch.int8:
        if w.dtype != torch.int8:
            raise TypeError("conv3x3: an int8 input requires int8 weights")
        return int_conv(xp, w).to(torch.float32)
    return conv2d(xp.to(torch.float32),
                  hwio_to_oihw(w).to(xp.dtype).to(torch.float32))


_RESIDENT_TAIL_C = (64, 128, 256)   # K8 resident: one block holds all C
_RESIDENT_TAIL_W = 256              # ... and stages 7 + rows of the gate map
BARRIER_WORDS = 256                 # >= any device's co-resident blocks


def _sample_blocks(h: int, w: int, c: int) -> int:
    """Blocks of the conv kernel that one sample takes: its 128-pixel tiles
    times its channel blocks (BN the widest of 256, 128, 64 that divides C)."""
    bn = 256 if c % 256 == 0 else 128 if c % 128 == 0 else TILE_N
    return -(-h * w // TILE_M) * (c // bn)


def conv_route(h: int, w: int, c: int, dtype, blocks_resident: int, *,
               tail: bool = False) -> str:
    """The route of a K7 (or, with ``tail``, K8) call whose conv output is
    (h, w, c): "resident" or "tiled". ``dtype`` is the conv input's (for K8
    with fp32 io: float32); ``blocks_resident`` how many blocks of the
    resident kernels the device holds at once (``resident_blocks``).
    Resident needs a tensor-core dtype, all of a sample's blocks on the card
    at once and, for K8, one block that holds every channel and a width of
    at most 256 (the spatial gate's window rows live in shared memory)."""
    if dtype not in (torch.bfloat16, torch.int8):
        return "tiled"
    if tail and (c not in _RESIDENT_TAIL_C or w > _RESIDENT_TAIL_W):
        return "tiled"
    return "resident" if _sample_blocks(h, w, c) <= blocks_resident \
        else "tiled"


def sample_groups(n: int, h: int, w: int, c: int, dtype,
                  blocks_resident: int, *, tail: bool = False) -> int:
    """How many samples a resident launch holds side by side (each group of
    blocks walks every ``groups``-th sample); 0 on the tiled route."""
    if conv_route(h, w, c, dtype, blocks_resident, tail=tail) == "tiled":
        return 0
    return min(n, blocks_resident // _sample_blocks(h, w, c), BARRIER_WORDS)


class Scratch(NamedTuple):
    """Device scratch of K7 / K8 calls on (n, h, w, c)."""
    acc: torch.Tensor | None  # (n, h*w, c) fp32 conv accumulator (tiled)
    partials: torch.Tensor    # (3, n, tiles, c) per-tile mean, M2, max
    stats: torch.Tensor       # (3, n, c) mean, 1/std, channel gate (tiled)
    map: torch.Tensor         # (n, h, w, 2) channel mean / max of t (resident)
    barrier: torch.Tensor     # (BARRIER_WORDS,) int64 arrival counts, zeroed


def make_scratch(n: int, h: int, w: int, c: int, device, dtype=None,
                 blocks_resident: int | None = None) -> Scratch:
    """Scratch for K7/K8 calls whose conv output is (n, h, w, c); a trunk
    makes it once and passes it to every call. With ``dtype`` (the calls'
    io dtype) the fp32 accumulator is left out where both K7 and K8 take
    the resident route at that shape; without, the scratch serves any call.
    ``blocks_resident`` defaults to the device's (0 for the CPU)."""
    f32 = dict(dtype=torch.float32, device=device)
    tiles = -(-h * w // TILE_M)
    if blocks_resident is None:
        blocks_resident = resident_blocks(device)
    tiled = dtype is None or "tiled" in (
        conv_route(h, w, c, dtype, blocks_resident),
        conv_route(h, w, c, dtype, blocks_resident, tail=True))
    return Scratch(torch.empty((n, h * w, c), **f32) if tiled else None,
                   torch.empty((3, n, tiles, c), **f32),
                   torch.empty((3, n, c), **f32),
                   torch.empty((n, h, w, 2), **f32),
                   torch.zeros(BARRIER_WORDS, dtype=torch.int64,
                               device=device))


@functools.cache
def _lib() -> ctypes.CDLL:
    dll = _build.load_library("conv_in")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.ducosy_conv3x3_in.restype = i
    dll.ducosy_conv3x3_in.argtypes = [p] * 9 + [i] * 6 + [f, f, i, i, p]
    dll.ducosy_conv_block_tail.restype = i
    dll.ducosy_conv_block_tail.argtypes = [p] * 16 + [i] * 7 + [f, i, i, i, p]
    dll.ducosy_conv3x3.restype = i
    dll.ducosy_conv3x3.argtypes = [p] * 6 + [i] * 5 + [p]
    dll.ducosy_conv3x3_probe.restype = i
    dll.ducosy_conv3x3_probe.argtypes = [p] * 6 + [i] * 5 + [p]
    dll.ducosy_resident_probe.restype = i
    dll.ducosy_resident_probe.argtypes = [p] * 15 + [i] * 8 + [p]
    dll.ducosy_resident_blocks.restype = i
    dll.ducosy_resident_blocks.argtypes = [ctypes.POINTER(i)]
    dll.ducosy_conv_tile_geometry.restype = None
    dll.ducosy_conv_tile_geometry.argtypes = [ctypes.POINTER(i)] * 2
    return dll


@functools.cache
def _resident_blocks(index: int) -> int:
    dll, blocks = _lib(), ctypes.c_int()
    with torch.cuda.device(index):
        status = dll.ducosy_resident_blocks(ctypes.byref(blocks))
    _build.check(dll, status, "resident_blocks query")
    return blocks.value


def resident_blocks(device) -> int:
    """How many blocks of the resident kernels ``device`` holds at once: its
    SM count times the occupancy the runtime reports for them (132 x 1 on an
    H100 SXM), asked once per device; 0 for the CPU. Builds the library."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _resident_blocks(index)


def tile_geometry() -> tuple[int, int]:
    """(TILE_M, TILE_N) as the built library has them; builds it if needed."""
    m, n = ctypes.c_int(), ctypes.c_int()
    _lib().ducosy_conv_tile_geometry(ctypes.byref(m), ctypes.byref(n))
    return m.value, n.value


def _check_input(what, xp, w, pad) -> None:
    """The conv input xp (N, H+2, W+2, C) and its weights w, as the kernels
    take them: contiguous, C -> C channels, int8 with int8, on a CUDA device
    (checked last: the rest can be held without a card)."""
    if xp.dtype not in _FLOAT + (torch.int8,):
        raise TypeError(f"{what} kernel: dtype {xp.dtype} (float32, bfloat16 "
                        "or int8 only)")
    if (xp.dtype == torch.int8) != (w.dtype == torch.int8):
        raise TypeError(f"{what} kernel: input {xp.dtype} with weights "
                        f"{w.dtype} (int8 takes int8, and only int8)")
    if xp.dim() != 4 or not xp.is_contiguous() or xp.data_ptr() % 16:
        raise ValueError(f"{what} kernel: needs a contiguous, 16-byte aligned "
                         "NHWC input")
    n, hp, wp, c = xp.shape
    if tuple(w.shape) != (3, 3, c, c) or w.device != xp.device:
        raise ValueError(f"{what} kernel: w is {tuple(w.shape)} on {w.device},"
                         f" expected {(3, 3, c, c)} on {xp.device}")
    if c % TILE_N or not 0 < c <= 1024:
        raise ValueError(f"{what} kernel: C={c} (a multiple of {TILE_N} up to "
                         "1024)")
    if min(hp, wp) < 4 or pad not in (0, 1):
        raise ValueError(f"{what} kernel: input {hp}x{wp}, pad={pad} (needs "
                         "H, W >= 2 inside the pad, pad 0 or 1)")
    if xp.device.type != "cuda":
        raise ValueError(f"{what} kernel: input on {xp.device}; the kernel "
                         "takes CUDA tensors (CPU runs the plain path)")


def _check_scratch(what, scratch, n, h, w, c, dev, tiled: bool) -> Scratch:
    """``scratch`` (made here if None) for a call on (n, h, w, c); a call on
    the tiled route needs its accumulator."""
    if scratch is None:
        return make_scratch(n, h, w, c, dev, None if tiled else torch.bfloat16)
    if scratch.partials.shape[1:] != (n, -(-h * w // TILE_M), c) \
            or scratch.map.shape != (n, h, w, 2) \
            or scratch.partials.device != dev:
        raise ValueError(f"{what} kernel: scratch for map "
                         f"{tuple(scratch.map.shape)}, C="
                         f"{scratch.partials.shape[-1]} on "
                         f"{scratch.partials.device}, expected "
                         f"{(n, h, w, 2)}, C={c} on {dev}")
    if tiled and scratch.acc is None:
        raise ValueError(f"{what} kernel: this call takes the tiled route and "
                         "the scratch was made without an accumulator")
    return scratch


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def kernel_weights(w, dt) -> torch.Tensor:
    """HWIO w (..., 3, 3, Cin, Cout) in the conv kernels' layouts, (..., 9,
    C, C): the tensor-core loop reads both operands with the input channels
    contiguous, so bf16 (and int8, whatever ``dt``) is (tap, Cout, Cin); the
    fp32 FMA loop reads (tap, Cin, Cout)."""
    c = w.shape[-1]
    w = w.reshape(*w.shape[:-4], 9, c, c)
    if w.dtype == torch.int8:
        return w.transpose(-1, -2).contiguous()
    if dt == torch.bfloat16:
        return w.to(dt).transpose(-1, -2).contiguous()
    return w.to(dt).contiguous()


_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def conv3x3(xp, w, *, scratch: Scratch | None = None) -> Scratch:
    """The 3x3 VALID conv of the pre-padded xp (N, H+2, W+2, C) with HWIO w
    alone, as K1, K7 and K8 launch it: returns the scratch whose ``acc`` holds
    the fp32 accumulator (N, H*W, C) and whose ``partials`` hold the per-tile
    (mean, M2, max). The kernel for a CUDA tensor; for a CPU tensor the plain
    version's accumulator with partials computed tile by tile.
    ``conv3x3.launches`` counts every launch of the shared conv kernel, those
    inside K1, K7 and K8 too."""
    if xp.device.type == "cpu":
        y = conv3x3_plain(xp, w)
        n, h, wd, c = y.shape
        sc = make_scratch(n, h, wd, c, xp.device)
        sc.acc.copy_(y.reshape(n, h * wd, c))
        for t, rows in enumerate(sc.acc.split(TILE_M, dim=1)):
            mean = rows.mean(dim=1)
            sc.partials[0][:, t] = mean
            sc.partials[1][:, t] = (rows - mean[:, None]).square().sum(dim=1)
            sc.partials[2][:, t] = rows.amax(dim=1)
        return sc
    sc = _launch_conv("conv3x3", xp, w, scratch, _KIND[xp.dtype])
    conv3x3.launches += 1
    return sc


conv3x3.launches = 0


def _launch_conv(what, xp, w, scratch, last: int) -> Scratch:
    """Validate and launch the entry point ``ducosy_<what>`` of the bare
    conv; ``last`` is its last integer argument."""
    _check_input(what, xp, w, 1)
    n, hp, wp, c = xp.shape
    sc = _check_scratch(what, scratch, n, hp - 2, wp - 2, c, xp.device, True)
    wk = kernel_weights(w, xp.dtype)
    dll = _lib()
    with torch.cuda.device(xp.device):
        status = getattr(dll, f"ducosy_{what}")(
            xp.data_ptr(), wk.data_ptr(), sc.acc.data_ptr(),
            *(t.data_ptr() for t in sc.partials), n, hp - 2, wp - 2, c, last,
            torch.cuda.current_stream(xp.device).cuda_stream)
    _build.check(dll, status, f"{what} kernel launch")
    return sc


def conv3x3_probe(xp, w, parts: int, scratch: Scratch) -> None:
    """Timing probe of the bf16 conv loop with parts compiled out: ``parts``
    sums 1 (the accumulator's store), 2 (the statistics) and 4 (the MMAs;
    without them the ring's loads run alone); 7 is ``conv3x3``. bf16 CUDA xp
    with C a multiple of 256; what a missing part would write is not written
    to ``scratch``. Counts no launch."""
    if xp.dtype != torch.bfloat16 or xp.shape[-1] % 256 or \
            parts not in (0, 4, 5, 6, 7):
        raise ValueError(f"conv3x3_probe: {xp.dtype}, C={xp.shape[-1]}, "
                         f"parts={parts} (bfloat16, C a multiple of 256, "
                         "parts 0, 4, 5, 6 or 7)")
    _launch_conv("conv3x3_probe", xp, w, scratch, parts)


def probe_weights(w, w1, w2, wsa) -> tuple:
    """The weights of a K7/K8 call as ``resident_probe`` takes them, laid out
    once (bf16 w as (tap, Cout, Cin); fp32 MLP; the 7x7 taps as avg | max):
    the probe times kernels of some tens of microseconds, which a per-call
    layout would bury."""
    return (kernel_weights(w, torch.bfloat16), w1.float().contiguous(),
            w2.float().contiguous(),
            wsa.reshape(SA_KERNEL * SA_KERNEL, 2).T.float().contiguous())


def resident_probe(xp, weights: tuple, parts: int, tail: bool,
                   scratch: Scratch) -> torch.Tensor:
    """Timing probe of the bf16 resident kernels at C = 256 with parts
    compiled out: ``parts`` sums 1 (ring, MMAs and partials), 2 (barriers,
    merges and channel gate) and 4 (the epilogue from the registers); 7 is
    the whole kernel. ``weights`` from ``probe_weights``. ``tail``: K8's
    kernel with xp as both tp and x, else K7's. Only at 7 is the output
    K7's or K8's. Counts no launch."""
    wk, w1f, w2f, wsa2 = weights
    if xp.dim() != 4 or xp.dtype != torch.bfloat16 or xp.shape[-1] != 256 \
            or not xp.is_contiguous() or parts not in range(1, 8) \
            or tuple(wk.shape) != (9, 256, 256) or wk.dtype != xp.dtype:
        raise ValueError(f"resident_probe: {xp.dtype} {tuple(xp.shape)}, "
                         f"parts={parts} (contiguous bfloat16 NHWC, C = 256, "
                         "parts 1-7, weights from probe_weights)")
    if xp.device.type != "cuda":
        raise ValueError(f"resident_probe: input on {xp.device}; the kernel "
                         "takes CUDA tensors")
    n, hp, wp, c = xp.shape
    h, wd = hp - 2, wp - 2
    groups = sample_groups(n, h, wd, c, xp.dtype,
                           resident_blocks(xp.device), tail=tail)
    if not groups:
        raise ValueError(f"resident_probe: {h} x {wd} x {c} is not on the "
                         "resident route on this device")
    sc = _check_scratch("resident_probe", scratch, n, h, wd, c, xp.device,
                        False)
    out = torch.empty_like(xp)
    dll = _lib()
    with torch.cuda.device(xp.device):
        status = dll.ducosy_resident_probe(
            xp.data_ptr(), xp.data_ptr(), wk.data_ptr(), w1f.data_ptr(),
            w2f.data_ptr(), wsa2.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in sc.partials),
            *(t.data_ptr() for t in sc.stats), sc.map.data_ptr(),
            sc.barrier.data_ptr(), n, h, wd, c, w1f.shape[-1], parts,
            int(tail), groups,
            torch.cuda.current_stream(xp.device).cuda_stream)
    _build.check(dll, status, "resident_probe launch")
    return out


def launch_conv3x3_in(xp, w, *, relu, pad, int8_scale, eps, scratch):
    """Validate, allocate and launch K7; counts nothing (the public wrappers
    of K7 and of its prototype count their own launches)."""
    _check_input("conv3x3_in", xp, w, pad)
    if int8_scale is not None and not relu:
        raise ValueError("conv3x3_in: int8_scale requires relu=True "
                         "(non-negative outputs)")
    n, hp, wp, c = xp.shape
    h, wd = hp - 2, wp - 2
    dev = xp.device
    groups = sample_groups(n, h, wd, c, xp.dtype, resident_blocks(dev))
    sc = _check_scratch("conv3x3_in", scratch, n, h, wd, c, dev, not groups)
    wk = kernel_weights(w, xp.dtype)
    out = torch.empty((n, h + 2 * pad, wd + 2 * pad, c), device=dev,
                      dtype=xp.dtype if int8_scale is None else torch.int8)
    dll = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = dll.ducosy_conv3x3_in(
            xp.data_ptr(), wk.data_ptr(), out.data_ptr(), _ptr(sc.acc),
            sc.partials[0].data_ptr(), sc.partials[1].data_ptr(),
            sc.stats[0].data_ptr(), sc.stats[1].data_ptr(),
            sc.barrier.data_ptr(), n, h, wd, c, pad, int(relu), float(eps),
            0.0 if int8_scale is None else INT8_GRID / int8_scale,
            _KIND[xp.dtype], groups, stream)
    _build.check(dll, status, "conv3x3_in kernel launch")
    conv3x3.launches += 1
    launch_conv3x3_in.route = "resident" if groups else "tiled"
    return out


launch_conv3x3_in.route = None    # the route of the last K7 launch


def conv3x3_in(xp, w, *, relu: bool = True, pad: int = 1,
               int8_scale: float | None = None,
               eps: float = EPS_INSTANCE_NORM,
               scratch: Scratch | None = None) -> torch.Tensor:
    """act(IN(conv3x3_valid(xp, w))) of the pre-padded xp (N, H+2, W+2, C),
    reflect-padded by ``pad``; shifted-grid int8 with ``int8_scale``. The K7
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if xp.device.type == "cpu":
        return conv3x3_in_plain(xp, w, relu=relu, pad=pad,
                                int8_scale=int8_scale, eps=eps)
    out = launch_conv3x3_in(xp, w, relu=relu, pad=pad, int8_scale=int8_scale,
                            eps=eps, scratch=scratch)
    conv3x3_in.launches += 1
    return out


conv3x3_in.launches = 0


def launch_conv_block_tail(tp, x, w, w1, w2, wsa, *, pad, x_pad, in_int8,
                           eps, scratch):
    """Validate, allocate and launch K8; counts nothing."""
    _check_input("conv_block_tail", tp, w, pad)
    n, hp, wp, c = tp.shape
    h, wd = hp - 2, wp - 2
    dev, dt = tp.device, x.dtype
    if in_int8 != (tp.dtype == torch.int8):
        raise TypeError(f"conv_block_tail kernel: tp {tp.dtype} with "
                        f"in_int8={in_int8} (int8 exactly when in_int8)")
    if dt not in _FLOAT or (not in_int8 and tp.dtype != dt):
        raise TypeError(f"conv_block_tail kernel: x {dt}, tp {tp.dtype} (x "
                        "float32 or bfloat16; tp the same, or int8)")
    r = w1.shape[-1]
    want = {"w1": (c, r), "w2": (r, c), "wsa": (SA_KERNEL, SA_KERNEL, 2, 1)}
    for name, t in zip(want, (w1, w2, wsa)):
        if tuple(t.shape) != want[name] or t.device != dev:
            raise ValueError(f"conv_block_tail kernel: {name} is "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{want[name]} on {dev}")
    xshape = (n, h + 2 * x_pad, wd + 2 * x_pad, c)
    if x_pad not in (0, 1) or tuple(x.shape) != xshape or x.device != dev \
            or not x.is_contiguous():
        raise ValueError(f"conv_block_tail kernel: x {tuple(x.shape)} on "
                         f"{x.device}, expected a contiguous {xshape} tensor "
                         f"on {dev} (x_pad 0 or 1)")
    if not 0 < r <= c:
        raise ValueError(f"conv_block_tail kernel: R={r} (0 < R <= C={c})")
    groups = sample_groups(
        n, h, wd, c, torch.float32 if dt == torch.float32 else tp.dtype,
        resident_blocks(dev), tail=True)
    sc = _check_scratch("conv_block_tail", scratch, n, h, wd, c, dev,
                        not groups)
    wk = kernel_weights(w, dt)
    w1f = w1.to(torch.float32).contiguous()
    w2f = w2.to(torch.float32).contiguous()
    # spatial-gate taps as (avg taps | max taps), tap = di * 7 + dj
    wsa2 = wsa.reshape(SA_KERNEL * SA_KERNEL, 2).T.to(torch.float32) \
        .contiguous()
    out = torch.empty((n, h + 2 * pad, wd + 2 * pad, c), dtype=dt, device=dev)
    dll = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = dll.ducosy_conv_block_tail(
            tp.data_ptr(), x.data_ptr(), wk.data_ptr(), w1f.data_ptr(),
            w2f.data_ptr(), wsa2.data_ptr(), out.data_ptr(),
            _ptr(sc.acc), *(t.data_ptr() for t in sc.partials),
            *(t.data_ptr() for t in sc.stats), sc.map.data_ptr(),
            sc.barrier.data_ptr(), n, h, wd, c, r, pad, x_pad, float(eps),
            int(in_int8), int(dt == torch.bfloat16), groups, stream)
    _build.check(dll, status, "conv_block_tail kernel launch")
    conv3x3.launches += 1
    launch_conv_block_tail.route = "resident" if groups else "tiled"
    return out


launch_conv_block_tail.route = None    # the route of the last K8 launch


def conv_block_tail(tp, x, w, w1, w2, wsa, *, pad: int = 1, x_pad: int = 1,
                    in_int8: bool = False, w_scale=None,
                    eps: float = EPS_INSTANCE_NORM,
                    scratch: Scratch | None = None) -> torch.Tensor:
    """x(interior) + CBAM(IN(conv3x3_valid(tp, w))), reflect-padded by
    ``pad``, in x's dtype: the K8 kernel for a CUDA tensor, the plain
    version for a CPU tensor. ``in_int8``: tp and w are int8; ``w_scale``
    (C,) is read by the plain version only."""
    if tp.device.type == "cpu":
        return conv_block_tail_plain(tp, x, w, w1, w2, wsa, pad=pad,
                                     x_pad=x_pad, in_int8=in_int8,
                                     w_scale=w_scale, eps=eps)
    out = launch_conv_block_tail(tp, x, w, w1, w2, wsa, pad=pad, x_pad=x_pad,
                                 in_int8=in_int8, eps=eps, scratch=scratch)
    conv_block_tail.launches += 1
    return out


conv_block_tail.launches = 0
