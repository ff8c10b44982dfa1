"""K4 and K5: the residual-block tail x + CBAM(IN(h)) and its backward.

K4 replaces ``block_tail_pallas`` (ducosy_tpu/ops/pallas/cbam_block.py:108),
the forward of ``block_tail_fused`` on the training trunk
(models/fused.py:695-698): h is conv2's output (N, H, W, C), x the block
input reflect-padded by ``x_pad`` (only its interior joins the skip), and
the result is reflect-padded by ``pad`` for the next block.

K5 replaces ``block_tail_bwd_pallas`` (cbam_block.py:272), the two-pass
VJP that recomputes the forward from h. Between its passes the 7x7
spatial-gate adjoint runs in plain PyTorch on the (N, H, W) maps, as the
JAX package runs it in XLA (cbam_block.py:314-327).

``block_tail_fused`` is the differentiable op: K4 forward, K5 backward on
the card; on the CPU ``block_tail_plain`` (the XLA composition
``_xla_block_tail``, cbam_block.py:472) and ``block_tail_bwd_plain`` (the
analytic adjoint ``_analytic_tail_bwd``, :372-469, with the equal split of
the gradient among tied maxima in both max pools).

Layouts are the JAX package's: w1 (C, R), w2 (R, C), wsa (7, 7, 2, 1) HWIO.
The kernels are CUDA C++ (``csrc/block_tail.cu``, ``csrc/block_tail_bwd.cu``)
and share their tail code with K1 (``csrc/cbam_tail.cuh``).
"""
from __future__ import annotations

import ctypes
import functools

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
    gate_c = _channel_gate(y, w1, w2)[-1]
    t = y * gate_c.to(y.dtype)[:, None, None, :]
    z = F.conv2d(_spatial_stat(t), hwio_to_oihw(wsa.to(torch.float32)),
                 padding=SA_KERNEL // 2)
    gate_s = torch.sigmoid(z).permute(0, 2, 3, 1).to(t.dtype)
    return reflect_pad(x + t * gate_s, pad)


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


@functools.cache
def _lib() -> ctypes.CDLL:
    dll = _build.load_library("block_tail")
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.ducosy_block_tail.restype = i
    dll.ducosy_block_tail.argtypes = [p] * 12 + [i] * 7 + [
        ctypes.c_float, i, p]
    return dll


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    dll = _build.load_library("block_tail_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.ducosy_block_tail_bwd_stats.restype = i
    dll.ducosy_block_tail_bwd_stats.argtypes = [p] * 12 + [i] * 6 + [
        ctypes.c_float, i, p]
    dll.ducosy_block_tail_bwd_apply.restype = i
    dll.ducosy_block_tail_bwd_apply.argtypes = [p] * 16 + [i] * 7 + [p]
    return dll


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


def block_tail(h, x, w1, w2, wsa, *, pad: int, x_pad: int,
               eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """x(interior) + CBAM(IN(h)), reflect-padded by ``pad``: the K4 kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if h.device.type == "cpu":
        return block_tail_plain(h, x, w1, w2, wsa, pad=pad, x_pad=x_pad,
                                eps=eps)
    _validate("block_tail", h, x, x_pad, w1, w2, wsa, pad)
    n, hh, ww, c = h.shape
    r = w1.shape[-1]
    tiles = -(-hh * ww // TILE_M)
    f32 = dict(dtype=torch.float32, device=h.device)
    out = torch.empty((n, hh + 2 * pad, ww + 2 * pad, c), dtype=h.dtype,
                      device=h.device)
    part = torch.empty((3, n, tiles, c), **f32)
    vec = torch.empty((3, n, c), **f32)
    w1f = w1.to(torch.float32).contiguous()
    w2f = w2.to(torch.float32).contiguous()
    # spatial-gate taps as (avg taps | max taps), tap = di * 7 + dj
    wsa2 = wsa.reshape(SA_KERNEL * SA_KERNEL, 2).T.to(torch.float32) \
        .contiguous()
    dll = _lib()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        status = dll.ducosy_block_tail(
            h.data_ptr(), x.data_ptr(), w1f.data_ptr(), w2f.data_ptr(),
            wsa2.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in part),
            *(t.data_ptr() for t in vec), n, hh, ww, c, r, pad, x_pad,
            float(eps), int(h.dtype == torch.bfloat16), stream)
    _build.check(dll, status, "block_tail kernel launch")
    block_tail.launches += 1
    return out


block_tail.launches = 0


def block_tail_bwd(h, g, w1, w2, wsa, *, pad: int, x_pad: int,
                   eps: float = EPS_INSTANCE_NORM, x_dtype=None):
    """(dh, dx, dw1, dw2, dwsa) of ``block_tail`` from the saved h and the
    output cotangent g: the K5 kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if h.device.type == "cpu":
        return block_tail_bwd_plain(h, g, w1, w2, wsa, pad=pad, x_pad=x_pad,
                                    eps=eps, x_dtype=x_dtype)
    _validate("block_tail_bwd", h, g, pad, w1, w2, wsa, pad)
    n, hh, ww, c = h.shape
    r = w1.shape[-1]
    tiles = -(-hh * ww // TILE_M)
    f32 = dict(dtype=torch.float32, device=h.device)
    w1f = w1.to(torch.float32).contiguous()
    w2f = w2.to(torch.float32).contiguous()
    part = torch.empty((3, n, tiles, c), **f32)
    vec = torch.empty((4, n, c), **f32)       # mean, rstd, max y, gate_c
    maps = torch.empty((n, 4, hh, ww), **f32)  # sa_avg, sa_max, dgs, mcnt
    bf16 = int(h.dtype == torch.bfloat16)
    dll = _bwd_lib()
    ptr = lambda ts: (t.data_ptr() for t in ts)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        status = dll.ducosy_block_tail_bwd_stats(
            h.data_ptr(), g.data_ptr(), w1f.data_ptr(), w2f.data_ptr(),
            *ptr(part), *ptr(vec), maps.data_ptr(), n, hh, ww, c, r, pad,
            float(eps), bf16, stream)
        _build.check(dll, status, "block_tail_bwd stats launch")
        gs, dstat, dwsa = _spatial_adjoint(maps[:, :2], maps[:, 2:3], wsa)
        maps2 = torch.cat([gs, dstat, maps[:, 1:2], maps[:, 3:4]], dim=1)
        dh = torch.empty_like(h)
        dw1 = torch.empty((n, c, r), **f32)
        dw2 = torch.empty((n, r, c), **f32)
        vec2 = torch.empty((n, 3, c), **f32)   # mean dy, mean dy*y, coef
        status = dll.ducosy_block_tail_bwd_apply(
            h.data_ptr(), g.data_ptr(), w1f.data_ptr(), w2f.data_ptr(),
            *ptr(vec), maps2.data_ptr(), *ptr(part), vec2.data_ptr(),
            dh.data_ptr(), dw1.data_ptr(), dw2.data_ptr(), n, hh, ww, c, r,
            pad, bf16, stream)
        _build.check(dll, status, "block_tail_bwd apply launch")
    block_tail_bwd.launches += 1
    gf = reflect_pad_adjoint(g.to(torch.float32), pad)
    return (dh, _embed(gf, x_pad).to(x_dtype or h.dtype),
            dw1.sum(dim=0).to(w1.dtype), dw2.sum(dim=0).to(w2.dtype),
            dwsa.to(wsa.dtype))


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
