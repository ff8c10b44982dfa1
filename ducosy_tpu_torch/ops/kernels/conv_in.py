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
uses (``csrc/conv3x3.cuh``, ``common.cuh``, ``cbam_tail.cuh``). Their
scratch (the fp32 accumulator and the statistics partials) can be made once
with ``make_scratch`` and passed to every call of a trunk. ``conv3x3`` is
the conv launch they and K1 share, alone: the fp32 accumulator of the bf16
(wgmma), int8 (wgmma, exact int32) or fp32 (exact FMA) loop.

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


class Scratch(NamedTuple):
    """Device scratch of one K7 or K8 call on (n, h, w, c)."""
    acc: torch.Tensor        # (n, h*w, c) fp32 conv accumulator
    partials: torch.Tensor   # (3, n, tiles, c) per-tile mean, M2, max
    stats: torch.Tensor      # (3, n, c) mean, 1/std, channel gate


def make_scratch(n: int, h: int, w: int, c: int, device) -> Scratch:
    """Scratch for K7/K8 calls whose conv output is (n, h, w, c); a trunk
    makes it once and passes it to every call."""
    f32 = dict(dtype=torch.float32, device=device)
    tiles = -(-h * w // TILE_M)
    return Scratch(torch.empty((n, h * w, c), **f32),
                   torch.empty((3, n, tiles, c), **f32),
                   torch.empty((3, n, c), **f32))


@functools.cache
def _lib() -> ctypes.CDLL:
    dll = _build.load_library("conv_in")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.ducosy_conv3x3_in.restype = i
    dll.ducosy_conv3x3_in.argtypes = [p] * 8 + [i] * 6 + [f, f, i, p]
    dll.ducosy_conv_block_tail.restype = i
    dll.ducosy_conv_block_tail.argtypes = [p] * 14 + [i] * 7 + [f, i, i, p]
    dll.ducosy_conv3x3.restype = i
    dll.ducosy_conv3x3.argtypes = [p] * 6 + [i] * 5 + [p]
    dll.ducosy_conv3x3_probe.restype = i
    dll.ducosy_conv3x3_probe.argtypes = [p] * 6 + [i] * 5 + [p]
    dll.ducosy_conv_tile_geometry.restype = None
    dll.ducosy_conv_tile_geometry.argtypes = [ctypes.POINTER(i)] * 2
    return dll


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


def _check_scratch(what, scratch, n, h, w, c, dev) -> Scratch:
    if scratch is None:
        return make_scratch(n, h, w, c, dev)
    if scratch.acc.shape != (n, h * w, c) or scratch.acc.device != dev:
        raise ValueError(f"{what} kernel: scratch for "
                         f"{tuple(scratch.acc.shape)} on {scratch.acc.device},"
                         f" expected {(n, h * w, c)} on {dev}")
    return scratch


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
    sc = _check_scratch(what, scratch, n, hp - 2, wp - 2, c, xp.device)
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
    sc = _check_scratch("conv3x3_in", scratch, n, h, wd, c, dev)
    wk = kernel_weights(w, xp.dtype)
    out = torch.empty((n, h + 2 * pad, wd + 2 * pad, c), device=dev,
                      dtype=xp.dtype if int8_scale is None else torch.int8)
    dll = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = dll.ducosy_conv3x3_in(
            xp.data_ptr(), wk.data_ptr(), out.data_ptr(), sc.acc.data_ptr(),
            sc.partials[0].data_ptr(), sc.partials[1].data_ptr(),
            sc.stats[0].data_ptr(), sc.stats[1].data_ptr(), n, h, wd, c, pad,
            int(relu), float(eps),
            0.0 if int8_scale is None else INT8_GRID / int8_scale,
            _KIND[xp.dtype], stream)
    _build.check(dll, status, "conv3x3_in kernel launch")
    conv3x3.launches += 1
    return out


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
    sc = _check_scratch("conv_block_tail", scratch, n, h, wd, c, dev)
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
            sc.acc.data_ptr(), *(t.data_ptr() for t in sc.partials),
            *(t.data_ptr() for t in sc.stats), n, h, wd, c, r, pad, x_pad,
            float(eps), int(in_int8), int(dt == torch.bfloat16), stream)
    _build.check(dll, status, "conv_block_tail kernel launch")
    conv3x3.launches += 1
    return out


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
