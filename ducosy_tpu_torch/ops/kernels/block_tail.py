"""K4 and K5: the residual-block tail x + CBAM(IN(h)) and its backward.

K4 replaces ``block_tail_pallas`` (ducosy_tpu/ops/pallas/cbam_block.py:108),
the forward of ``block_tail_fused`` on the training trunk
(models/fused.py:695-698): h is conv2's output (N, H, W, C), x the block
input reflect-padded by ``x_pad`` (only its interior joins the skip), and
the result is reflect-padded by ``pad`` for the next block.

K5 replaces ``block_tail_bwd_pallas`` (cbam_block.py:272), the VJP that
recomputes the forward from h and returns (dh, dx, dw1, dw2, dwsa).

Both run by one of two routes that ``tail_route`` picks from the shape, the
dtype and the device's co-resident block count, never from a failure:
  "resident" (bf16, C = 64, 128 or 256, W <= 256, every 128-pixel tile of a
    sample on the card at once): one cooperative launch each. K4 is K8's
    epilogue (csrc/tail_resident.cuh) on h loaded from device memory; K5
    keeps each block's tiles of h and of the folded cotangent in shared
    memory, runs the 7x7 spatial-gate adjoint inside the block from the map
    rows within reach, and writes dh and dx itself (csrc/block_tail_bwd.cu).
  "tiled" (everything else: fp32, C = 192, wide or large images): the
    original launches. K5 is two passes with the 7x7 adjoint between them in plain
    PyTorch on the (N, H, W) maps, as the JAX package runs it in XLA
    (cbam_block.py:314-327), and dx folded here in fp32.
A refused cooperative launch raises; nothing drops to the other route or to
a plain version.

``block_tail_fused`` is the differentiable op: K4 forward, K5 backward on
the card; on the CPU ``block_tail_plain`` (the XLA composition
``_xla_block_tail``, cbam_block.py:472) and ``block_tail_bwd_plain`` (the
analytic adjoint ``_analytic_tail_bwd``, :372-469, with the equal split of
the gradient among tied maxima in both max pools).

Layouts are the JAX package's: w1 (C, R), w2 (R, C), wsa (7, 7, 2, 1) HWIO.
The kernels are CUDA C++ (``csrc/block_tail.cu``, ``csrc/block_tail_bwd.cu``)
and share their tail code with K1 (``csrc/cbam_tail.cuh``) and K8
(``csrc/tail_resident.cuh``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

from ducosy_tpu_torch.models.layers import (
    EPS_INSTANCE_NORM,
    reflect_pad,
    reflect_pad_adjoint,
)
from ducosy_tpu_torch.ops.kernels import _build

TILE_M = 128   # pixels per statistics tile (csrc/common.cuh)
TILE_N = 64    # channels per tile; C must be a multiple
SA_KERNEL = 7  # CBAM spatial-attention kernel size


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def _normalize(h: torch.Tensor, eps: float):
    """IN of h in fp32 (centred statistics), rounded to h's dtype once, and
    the fp32 1/std: the y of the forward, which K4 and K5 compute alike."""
    h32 = h.to(torch.float32)
    hc = h32 - h32.mean(dim=(1, 2), keepdim=True)
    inv = torch.reciprocal(torch.sqrt(hc.square().mean(dim=(1, 2),
                                                       keepdim=True) + eps))
    return (hc * inv).to(h.dtype), inv


def _channel_gate(y, w1, w2):
    """Pools, the shared C -> R -> C MLP and the sigmoid: (avg, mx, pre,
    hid, gate_c), all fp32; pre and hid are (N, 2, R), avg branch first."""
    avg = y.to(torch.float32).mean(dim=(1, 2))                   # (N, C)
    mx = y.amax(dim=(1, 2)).to(torch.float32)                    # (N, C)
    pre = torch.stack([avg, mx], dim=1) @ w1.to(torch.float32)   # (N, 2, R)
    hid = torch.relu(pre)
    gates = hid @ w2.to(torch.float32)                           # (N, 2, C)
    return avg, mx, pre, hid, torch.sigmoid(gates[:, 0] + gates[:, 1])


def _spatial_stat(t):
    """(N, 2, H, W) fp32 channel mean and max of t."""
    return torch.stack([t.to(torch.float32).mean(dim=-1),
                        t.amax(dim=-1).to(torch.float32)], dim=1)


def block_tail_plain(h, x, w1, w2, wsa, *, pad: int, x_pad: int,
                     eps: float = EPS_INSTANCE_NORM):
    """x(interior) + CBAM(IN(h)), reflect-padded by ``pad``
    (cbam_block.py:472 ``_xla_block_tail``). h: (N, H, W, C) conv output;
    x: the block input, reflect-padded by ``x_pad``."""
    if x_pad:
        x = x[:, x_pad:-x_pad, x_pad:-x_pad, :]
    y, _ = _normalize(h, eps)
    return reflect_pad(x + cbam_plain(y, w1, w2, wsa), pad)


def cbam_plain(y, w1, w2, wsa):
    """The CBAM gates of a normalized NHWC y (modules/model.py:6-52): the
    channel gate, then the 7x7 spatial gate, in plain PyTorch."""
    gate_c = _channel_gate(y, w1, w2)[-1]
    t = y * gate_c.to(y.dtype)[:, None, None, :]
    z = F.conv2d(_spatial_stat(t), hwio_to_oihw(wsa.to(torch.float32)),
                 padding=SA_KERNEL // 2)
    gate_s = torch.sigmoid(z).permute(0, 2, 3, 1).to(t.dtype)
    return t * gate_s


def _spatial_adjoint(stat, dgs, wsa):
    """The 7x7 spatial-gate adjoint on (N, H, W) maps, plain PyTorch (the
    JAX package runs it in XLA between the kernels, cbam_block.py:314-327).
    stat (N, 2, H, W) fp32, dgs (N, 1, H, W) = sum_c g*t. Returns gs
    (N, 1, H, W), dstat (N, 2, H, W) and dwsa (7, 7, 2, 1)."""
    wt = hwio_to_oihw(wsa.to(torch.float32))
    pad = SA_KERNEL // 2
    gs = torch.sigmoid(F.conv2d(stat, wt, padding=pad))
    dz = dgs * gs * (1.0 - gs)
    dstat = conv2d_input(stat.shape, wt, dz, padding=pad)
    dwsa = conv2d_weight(stat, wt.shape, dz, padding=pad)
    return gs, dstat, dwsa.permute(2, 3, 1, 0)


def _embed(g, x_pad: int):
    """The skip's cotangent: the folded g with a zero border of x_pad."""
    return F.pad(g, (0, 0, x_pad, x_pad, x_pad, x_pad)) if x_pad else g


def block_tail_bwd_plain(h, g, w1, w2, wsa, *, pad: int, x_pad: int,
                         eps: float = EPS_INSTANCE_NORM, x_dtype=None):
    """Plain PyTorch K5: the analytic VJP of ``block_tail_plain``
    (``_analytic_tail_bwd``, cbam_block.py:372-469) given the output
    cotangent g (N, H+2pad, W+2pad, C). Returns (dh, dx, dw1, dw2, dwsa).

    As in the reference, the big (N, H, W, C) intermediates stay in h's
    dtype and every reduction accumulates fp32; the gradient of each max
    pool is split equally among tied maxima. y is recomputed as the forward
    computes it (``_normalize``), so the tie masks are the forward's. dx
    is g folded in fp32, as the K5 wrapper (block_tail_bwd_pallas) has it,
    where _analytic_tail_bwd folds in g's dtype: the same in fp32."""
    io = h.dtype
    n, hh, ww, c = h.shape
    count = hh * ww
    w1f, w2f = w1.to(torch.float32), w2.to(torch.float32)
    g_out = g
    g = reflect_pad_adjoint(g.to(io), pad)                     # (N, H, W, C)

    y, inv = _normalize(h, eps)
    avg, mx, pre, hid, gate_c = _channel_gate(y, w1, w2)
    t = y * gate_c.to(io)[:, None, None, :]
    stat = _spatial_stat(t)                                    # (N, 2, H, W)
    dgs = (g * t).to(torch.float32).sum(dim=-1)[:, None]       # (N, 1, H, W)
    gs, dstat, dwsa = _spatial_adjoint(stat, dgs, wsa)
    nhwc = lambda a: a.permute(0, 2, 3, 1)                     # (N, H, W, k)

    # spatial gate and its channel max pool (ties split equally)
    sa_max = nhwc(stat[:, 1:])
    mmask = (t.to(torch.float32) == sa_max).to(io)
    mcnt = mmask.to(torch.float32).sum(dim=-1, keepdim=True)
    dstat = nhwc(dstat)
    dt = (g * nhwc(gs).to(io) + (dstat[..., :1] / c).to(io)
          + mmask * (dstat[..., 1:] / mcnt).to(io))

    # channel gate: shared bottleneck MLP, per-branch ReLU masks
    dgc = (dt * y).to(torch.float32).sum(dim=(1, 2))           # (N, C)
    da = dgc * gate_c * (1.0 - gate_c)
    dhid = (da @ w2f.T)[:, None, :] * (pre > 0)                # (N, 2, R)
    dpool = dhid @ w1f.T                                       # (N, 2, C)
    dw1 = avg.T @ dhid[:, 0] + mx.T @ dhid[:, 1]
    dw2 = (hid[:, 0] + hid[:, 1]).T @ da
    ymask = (y.to(torch.float32) == mx[:, None, None, :]).to(io)
    ycnt = ymask.to(torch.float32).sum(dim=(1, 2), keepdim=True)
    dy = (dt * gate_c.to(io)[:, None, None, :]
          + (dpool[:, 0] / count).to(io)[:, None, None, :]
          + ymask * (dpool[:, 1][:, None, None, :] / ycnt).to(io))

    # InstanceNorm adjoint (layernorm-style analytic expression)
    mg = dy.to(torch.float32).sum(dim=(1, 2), keepdim=True) / count
    mgy = (dy * y).to(torch.float32).sum(dim=(1, 2), keepdim=True) / count
    dh = ((dy - mg.to(io)) - y * mgy.to(io)) * inv.to(io)
    # the skip's cotangent, folded in fp32 and rounded once as the TPU
    # wrapper of K5 computes it (cbam_block.py:366-368)
    dx = _embed(reflect_pad_adjoint(g_out.to(torch.float32), pad), x_pad)
    return (dh.to(io), dx.to(x_dtype or io), dw1.to(w1.dtype),
            dw2.to(w2.dtype), dwsa.to(wsa.dtype))


# ---- routes and scratch

def tail_route(h: int, w: int, c: int, dtype, resident_blocks: int) -> str:
    """The route of a K4 or K5 call on h (n, h, w, c): "resident" or
    "tiled", from the shape, the dtype and how many blocks of the resident
    kernel the device holds at once (``resident_blocks``), never from a
    failure. Resident is K8's epilogue without the conv: bf16, one block
    holding every channel of its 128 pixels (C = 64, 128 or 256), a width
    whose 7x7 map rows fit in shared memory (<= 256), and every tile of a
    sample on the card at once."""
    from ducosy_tpu_torch.ops.kernels import conv_in   # imports this module

    if dtype != torch.bfloat16 or c not in conv_in._RESIDENT_TAIL_C \
            or w > conv_in._RESIDENT_TAIL_W:
        return "tiled"
    return "resident" if conv_in._sample_blocks(h, w, c) <= resident_blocks \
        else "tiled"


def tail_groups(n: int, h: int, w: int, c: int, dtype,
                resident_blocks: int) -> int:
    """How many samples a resident launch holds side by side (each group of
    blocks walks every ``groups``-th sample); 0 on the tiled route."""
    from ducosy_tpu_torch.ops.kernels import conv_in

    if tail_route(h, w, c, dtype, resident_blocks) == "tiled":
        return 0
    return min(n, resident_blocks // conv_in._sample_blocks(h, w, c),
               conv_in.BARRIER_WORDS)


class TailScratch(NamedTuple):
    """Device scratch of one K4 or K5 call on h (n, h, w, c), fp32 but the
    barrier words. Forward, both routes: per-tile (mean, M2, max) and per
    channel (mean, 1/std, gate) or (mean, 1/std, max). Backward, tiled:
    the same partials and (mean, 1/std, max y, gate), maps (n, 4, h, w)
    (sa_avg, sa_max, dgs, mcnt); resident: partials also of sum dt, sum
    dt*y and [y == max y], per channel also the merged sums and da, maps
    (2, n, h*w, 2) ((sa_avg, sa_max), (dgs, mcnt)) and dwsa's per-tile
    partials (n, tiles, 98)."""
    partials: torch.Tensor        # (3 or 6, n, tiles, c)
    stats: torch.Tensor           # (3, 4 or 7, n, c)
    maps: torch.Tensor | None     # per pixel; None for the tiled forward
    pdwsa: torch.Tensor | None    # (n, tiles, 98), resident backward
    barrier: torch.Tensor | None  # (groups,) int64, zeroed; resident only


def tail_scratch(n: int, h: int, w: int, c: int, device, *, resident: bool,
                 backward: bool, groups: int = 1) -> TailScratch:
    """The scratch of a K4 (``backward`` False) or K5 call on (n, h, w, c),
    per route; a resident call's ``groups`` barrier words are zeroed (each
    counts up for ever and serves one tile count: a scratch serves calls
    of one shape)."""
    f32 = dict(dtype=torch.float32, device=device)
    tiles = -(-h * w // TILE_M)
    k = 6 if resident and backward else 3
    vec = 7 if resident and backward else 4 if backward else 3
    if not backward:
        maps = torch.empty((n, h * w, 2), **f32) if resident else None
    else:
        maps = torch.empty((2, n, h * w, 2) if resident else (n, 4, h, w),
                           **f32)
    return TailScratch(
        torch.empty((k, n, tiles, c), **f32), torch.empty((vec, n, c), **f32),
        maps,
        torch.empty((n, tiles, 2 * SA_KERNEL ** 2), **f32)
        if resident and backward else None,
        torch.zeros(groups, dtype=torch.int64, device=device)
        if resident else None)


@functools.cache
def _lib() -> ctypes.CDLL:
    dll = _build.load_library("block_tail")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.ducosy_block_tail.restype = i
    dll.ducosy_block_tail.argtypes = [p] * 12 + [i] * 7 + [f, i, i, p]
    dll.ducosy_block_tail_resident.restype = i
    dll.ducosy_block_tail_resident.argtypes = [p] * 14 + [i] * 7 + [
        f, i, i, p]
    dll.ducosy_block_tail_resident_blocks.restype = i
    dll.ducosy_block_tail_resident_blocks.argtypes = [ctypes.POINTER(i)]
    return dll


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    dll = _build.load_library("block_tail_bwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.ducosy_block_tail_bwd_stats.restype = i
    dll.ducosy_block_tail_bwd_stats.argtypes = [p] * 12 + [i] * 6 + [f, i, p]
    dll.ducosy_block_tail_bwd_apply.restype = i
    dll.ducosy_block_tail_bwd_apply.argtypes = [p] * 16 + [i] * 8 + [p]
    dll.ducosy_block_tail_bwd_resident.restype = i
    dll.ducosy_block_tail_bwd_resident.argtypes = [p] * 14 + [i] * 7 + [
        f, i, i, p]
    dll.ducosy_block_tail_bwd_resident_blocks.restype = i
    dll.ducosy_block_tail_bwd_resident_blocks.argtypes = [ctypes.POINTER(i)]
    return dll


@functools.cache
def _resident_blocks(index: int, backward: bool) -> int:
    dll, blocks = (_bwd_lib() if backward else _lib()), ctypes.c_int()
    entry = dll.ducosy_block_tail_bwd_resident_blocks if backward \
        else dll.ducosy_block_tail_resident_blocks
    with torch.cuda.device(index):
        status = entry(ctypes.byref(blocks))
    _build.check(dll, status, "block_tail resident_blocks query")
    return blocks.value


def resident_blocks(device, backward: bool = False) -> int:
    """How many blocks of K4's (``backward``: K5's) resident kernel
    ``device`` holds at once: its SM count times the occupancy the runtime
    reports (132 x 1 on an H100 SXM), asked once per device; 0 for the CPU.
    Builds the library."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _resident_blocks(index, backward)


def _validate(what, h, other, other_pad, w1, w2, wsa, pad) -> None:
    if h.device.type != "cuda":
        raise ValueError(f"{what} kernel: tensor on {h.device}; the kernel "
                         "takes CUDA tensors (CPU runs the plain path)")
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} kernel: dtype {h.dtype} (float32 or "
                        "bfloat16 only)")
    if h.dim() != 4 or not h.is_contiguous():
        raise ValueError(f"{what} kernel: h must be a contiguous NHWC tensor")
    n, hh, ww, c = h.shape
    r = w1.shape[-1]
    want = {"w1": (c, r), "w2": (r, c), "wsa": (SA_KERNEL, SA_KERNEL, 2, 1)}
    for name, t in zip(want, (w1, w2, wsa)):
        if tuple(t.shape) != want[name] or t.device != h.device:
            raise ValueError(f"{what} kernel: {name} is {tuple(t.shape)} on "
                             f"{t.device}, expected {want[name]} on "
                             f"{h.device}")
    shape = (n, hh + 2 * other_pad, ww + 2 * other_pad, c)
    if tuple(other.shape) != shape or other.dtype != h.dtype or \
            other.device != h.device or not other.is_contiguous():
        raise ValueError(f"{what} kernel: second input {tuple(other.shape)} "
                         f"{other.dtype}; expected a contiguous {shape} "
                         f"{h.dtype} tensor on {h.device}")
    if c % TILE_N or not 0 < c <= 1024 or not 0 < r <= c:
        raise ValueError(f"{what} kernel: C={c}, R={r} (C a multiple of "
                         f"{TILE_N} up to 1024, 0 < R <= C)")
    if pad not in (0, 1) or other_pad not in (0, 1) or min(hh, ww) < 2:
        raise ValueError(f"{what} kernel: {hh}x{ww}, pads {pad}, "
                         f"{other_pad} (pads 0 or 1, H, W >= 2)")
    if h.data_ptr() % 16 or other.data_ptr() % 16:
        raise ValueError(f"{what} kernel: inputs must be 16-byte aligned")


def _weights(w1, w2, wsa):
    """The MLP in fp32 and the spatial-gate taps as (avg taps | max taps),
    tap = di * 7 + dj, as the kernels read them."""
    return (w1.to(torch.float32).contiguous(),
            w2.to(torch.float32).contiguous(),
            wsa.reshape(SA_KERNEL * SA_KERNEL, 2).T.to(torch.float32)
            .contiguous())


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _route(h, backward: bool) -> tuple[str, int]:
    """(route, groups) of a K4/K5 call on h."""
    n, hh, ww, c = h.shape
    groups = tail_groups(n, hh, ww, c, h.dtype,
                         resident_blocks(h.device, backward))
    return ("resident" if groups else "tiled"), groups


def launch_block_tail(h, x, w1, w2, wsa, *, pad: int, x_pad: int, eps: float,
                      parts: int = 7, scratch: TailScratch | None = None):
    """Validate, route, allocate and launch K4; counts nothing. ``parts``
    other than 7 (with a ``scratch`` made once, for timing) runs the
    launches of the tiled route that it sums (1 tile statistics, 2 channel
    gate, 4 spatial tail) or the resident kernel at C = 256 with parts
    compiled out (1 the load and tile partials, 2 the barriers, merges and
    gate, 4 the rest of the epilogue): the output is then not K4's."""
    _validate("block_tail", h, x, x_pad, w1, w2, wsa, pad)
    n, hh, ww, c = h.shape
    route, groups = _route(h, False)
    sc = scratch or tail_scratch(n, hh, ww, c, h.device,
                                 resident=bool(groups), backward=False,
                                 groups=max(groups, 1))
    out = torch.empty((n, hh + 2 * pad, ww + 2 * pad, c), dtype=h.dtype,
                      device=h.device)
    w = _weights(w1, w2, wsa)
    dll = _lib()
    with torch.cuda.device(h.device):
        if groups:
            status = dll.ducosy_block_tail_resident(
                h.data_ptr(), x.data_ptr(), *_ptrs(w), out.data_ptr(),
                *_ptrs(sc.partials), *_ptrs(sc.stats), sc.maps.data_ptr(),
                sc.barrier.data_ptr(), n, hh, ww, c, w1.shape[-1], pad,
                x_pad, float(eps), groups, parts, _stream(h.device))
        else:
            status = dll.ducosy_block_tail(
                h.data_ptr(), x.data_ptr(), *_ptrs(w), out.data_ptr(),
                *_ptrs(sc.partials), *_ptrs(sc.stats), n, hh, ww, c,
                w1.shape[-1], pad, x_pad, float(eps),
                int(h.dtype == torch.bfloat16), parts, _stream(h.device))
    _build.check(dll, status, f"block_tail ({route}) kernel launch")
    launch_block_tail.route = route
    return out


launch_block_tail.route = None    # the route of the last K4 launch


def block_tail(h, x, w1, w2, wsa, *, pad: int, x_pad: int,
               eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """x(interior) + CBAM(IN(h)), reflect-padded by ``pad``: the K4 kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if h.device.type == "cpu":
        return block_tail_plain(h, x, w1, w2, wsa, pad=pad, x_pad=x_pad,
                                eps=eps)
    out = launch_block_tail(h, x, w1, w2, wsa, pad=pad, x_pad=x_pad, eps=eps)
    block_tail.launches += 1
    return out


block_tail.launches = 0

# The parts of the tiled K5 that ``launch_block_tail_bwd`` can run alone
# (timing only): the stats pass, the 7x7 adjoint in PyTorch between the
# passes, the tile sums with the gate adjoint, the apply, the dx fold.
BWD_STATS, BWD_ADJOINT, BWD_SUMS, BWD_APPLY, BWD_FOLD = 1, 2, 4, 8, 16
BWD_TILED_ALL = 31
# The parts of the resident K5 (csrc/block_tail_bwd.cu, K5_*): 1 the copies
# in and out, 2 the grid barriers and merges, 4 the statistics, gate and
# maps, 8 the 7x7 adjoint, 16 the tile sums and gate adjoint, 32 dh; its
# probe takes 1, 3, 5, 9, 17, 33 and 61 at C = 256 (the rest compiled out).
RESIDENT_BWD_ALL = 63


def launch_block_tail_bwd(h, g, w1, w2, wsa, *, pad: int, x_pad: int,
                          eps: float, x_dtype=None, parts: int | None = None,
                          scratch: TailScratch | None = None):
    """Validate, route, allocate and launch K5; counts nothing. Returns
    (dh, dx, dw1, dw2, dwsa). ``parts`` (with a ``scratch`` made once, for
    timing; the outputs are then not K5's): on the tiled route a sum of the
    BWD_* flags, on the resident route at C = 256 one of the sets of K5_*
    parts the kernel's probe takes (listed above RESIDENT_BWD_ALL)."""
    _validate("block_tail_bwd", h, g, pad, w1, w2, wsa, pad)
    n, hh, ww, c = h.shape
    r = w1.shape[-1]
    route, groups = _route(h, True)
    if groups and x_dtype not in (None, h.dtype):
        raise TypeError(f"block_tail_bwd kernel: x {x_dtype} with h "
                        f"{h.dtype}: the resident kernel writes dx in h's "
                        "dtype")
    sc = scratch or tail_scratch(n, hh, ww, c, h.device,
                                 resident=bool(groups), backward=True,
                                 groups=max(groups, 1))
    f32 = dict(dtype=torch.float32, device=h.device)
    w1f, w2f, wsa2 = _weights(w1, w2, wsa)
    dh = torch.empty_like(h)
    dw1 = torch.empty((n, c, r), **f32)
    dw2 = torch.empty((n, r, c), **f32)
    dll = _bwd_lib()
    stream = _stream(h.device)
    if groups:
        dx = torch.empty((n, hh + 2 * x_pad, ww + 2 * x_pad, c),
                         dtype=h.dtype, device=h.device)
        with torch.cuda.device(h.device):
            status = dll.ducosy_block_tail_bwd_resident(
                h.data_ptr(), g.data_ptr(), w1f.data_ptr(), w2f.data_ptr(),
                wsa2.data_ptr(), dh.data_ptr(), dx.data_ptr(),
                dw1.data_ptr(), dw2.data_ptr(), sc.pdwsa.data_ptr(),
                sc.partials.data_ptr(), sc.stats.data_ptr(),
                sc.maps.data_ptr(), sc.barrier.data_ptr(), n, hh, ww, c, r,
                pad, x_pad, float(eps), groups,
                RESIDENT_BWD_ALL if parts is None else parts,
                stream)
        _build.check(dll, status, "block_tail_bwd (resident) kernel launch")
        # dwsa's per-tile partials (avg taps | max taps) back to HWIO
        dwsa = sc.pdwsa.sum(dim=(0, 1)).reshape(2, SA_KERNEL, SA_KERNEL) \
            .permute(1, 2, 0)[..., None]
    else:
        parts = BWD_TILED_ALL if parts is None else parts
        bf16 = int(h.dtype == torch.bfloat16)
        part, vec, maps = sc.partials, sc.stats, sc.maps
        with torch.cuda.device(h.device):
            if parts & BWD_STATS:
                status = dll.ducosy_block_tail_bwd_stats(
                    h.data_ptr(), g.data_ptr(), w1f.data_ptr(),
                    w2f.data_ptr(), *_ptrs(part), *_ptrs(vec),
                    maps.data_ptr(), n, hh, ww, c, r, pad, float(eps), bf16,
                    stream)
                _build.check(dll, status, "block_tail_bwd stats launch")
            if parts & BWD_ADJOINT:
                gs, dstat, dwsa = _spatial_adjoint(maps[:, :2], maps[:, 2:3],
                                                   wsa)
                maps2 = torch.cat([gs, dstat, maps[:, 1:2], maps[:, 3:4]],
                                  dim=1)
            else:
                dwsa = wsa
                maps2 = torch.empty((n, 5, hh, ww), **f32)
            vec2 = torch.empty((n, 3, c), **f32)   # mean dy, mean dy*y, coef
            apply = (1 if parts & BWD_SUMS else 0) | \
                (2 if parts & BWD_APPLY else 0)
            if apply:
                status = dll.ducosy_block_tail_bwd_apply(
                    h.data_ptr(), g.data_ptr(), w1f.data_ptr(),
                    w2f.data_ptr(), *_ptrs(vec), maps2.data_ptr(),
                    *_ptrs(part), vec2.data_ptr(), dh.data_ptr(),
                    dw1.data_ptr(), dw2.data_ptr(), n, hh, ww, c, r, pad,
                    bf16, apply, stream)
                _build.check(dll, status, "block_tail_bwd apply launch")
        dx = None
        if parts & BWD_FOLD:
            gf = reflect_pad_adjoint(g.to(torch.float32), pad)
            dx = _embed(gf, x_pad).to(x_dtype or h.dtype)
    launch_block_tail_bwd.route = route
    return (dh, dx, dw1.sum(dim=0).to(w1.dtype), dw2.sum(dim=0).to(w2.dtype),
            dwsa.to(wsa.dtype))


launch_block_tail_bwd.route = None    # the route of the last K5 launch


def block_tail_bwd(h, g, w1, w2, wsa, *, pad: int, x_pad: int,
                   eps: float = EPS_INSTANCE_NORM, x_dtype=None):
    """(dh, dx, dw1, dw2, dwsa) of ``block_tail`` from the saved h and the
    output cotangent g: the K5 kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if h.device.type == "cpu":
        return block_tail_bwd_plain(h, g, w1, w2, wsa, pad=pad, x_pad=x_pad,
                                    eps=eps, x_dtype=x_dtype)
    out = launch_block_tail_bwd(h, g, w1, w2, wsa, pad=pad, x_pad=x_pad,
                                eps=eps, x_dtype=x_dtype)
    block_tail_bwd.launches += 1
    return out


block_tail_bwd.launches = 0


class _BlockTailFn(torch.autograd.Function):
    """K4 forward, K5 backward. Saves h and the weights; the backward
    recomputes the tail from h (x enters only through its interior, whose
    cotangent is the folded g)."""

    @staticmethod
    def forward(ctx, h, x, w1, w2, wsa, pad, x_pad, eps):
        ctx.save_for_backward(h, w1, w2, wsa)
        ctx.cfg = (pad, x_pad, eps, x.dtype)
        return block_tail(h, x, w1, w2, wsa, pad=pad, x_pad=x_pad, eps=eps)

    @staticmethod
    def backward(ctx, g):
        h, w1, w2, wsa = ctx.saved_tensors
        pad, x_pad, eps, x_dtype = ctx.cfg
        grads = block_tail_bwd(h, g.contiguous(), w1, w2, wsa, pad=pad,
                               x_pad=x_pad, eps=eps, x_dtype=x_dtype)
        return (*grads, None, None, None)


def block_tail_fused(h, x, w1, w2, wsa, pad: int = 0, x_pad: int = 0,
                     eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """Differentiable x + CBAM(IN(h)) (cbam_block.py:504): K4 forward and
    K5 backward on the card, the plain versions on the CPU."""
    return _BlockTailFn.apply(h.contiguous(), x.contiguous(), w1, w2, wsa,
                              pad, x_pad, eps)
