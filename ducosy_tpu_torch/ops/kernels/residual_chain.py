"""K1: a chain of k CBAM residual blocks on a reflect-padded NHWC carry.

Replaces ``residual_chain_pallas`` (ducosy_tpu/ops/pallas/conv_in.py:399)
with ``quant=False``; at k=1 it is ``residual_block_pallas`` (K6, :308).
Each block (modules/model.py:68-87):
  conv1 3x3 VALID -> IN -> ReLU -> reflect-pad 1 -> conv2 3x3 -> IN ->
  CBAM channel gate -> spatial gate -> + skip (carry interior) ->
  reflect pad (1 inside the chain, ``pad`` after the last block).
Conv biases are not inputs: each conv feeds an InstanceNorm, whose mean
subtraction cancels a per-channel constant exactly.

The kernel is CUDA C++ (``csrc/residual_chain.cu``); the carry is far
larger than a Hopper block's shared memory, so each block runs as six
launches that split every whole-image reduction into per-tile partials and
a later apply step (see the source note there). ``residual_chain_plain``
is the TPU package's XLA composition (conv_in.py:501-536 with
cbam_block.py:472, ``block_tail_plain`` of block_tail.py) in plain
PyTorch, with optional conv biases.

Weights use the JAX layouts, as ``residual_chain_pallas`` takes them:
was/wbs (k, 3, 3, C, C) HWIO; w1s (k, C, R); w2s (k, R, C);
wsas (k, 7, 7, 2, 1) HWIO.
"""
from __future__ import annotations

import ctypes
import functools

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

TILE_M = 128   # pixels per conv output / statistics tile (csrc/common.cuh)
TILE_N = 64    # output channels per conv tile; C must be a multiple


def residual_chain_plain(xp, was, wbs, w1s, w2s, wsas, *, pad: int = 1,
                         eps: float = EPS_INSTANCE_NORM, b1s=None, b2s=None):
    """Plain PyTorch K1: per-block conv -> IN+ReLU+pad -> conv -> tail.
    ``b1s``/``b2s`` (k, C) are optional conv biases (the reference module
    has them; IN cancels them up to rounding)."""
    k = was.shape[0]
    dt = xp.dtype
    for j in range(k):
        b1 = None if b1s is None else b1s[j].to(dt)
        b2 = None if b2s is None else b2s[j].to(dt)
        t = conv2d(xp, hwio_to_oihw(was[j]).to(dt), b1)
        t = reflect_pad(torch.relu(instance_norm(t, eps)), 1)
        y = conv2d(t, hwio_to_oihw(wbs[j]).to(dt), b2)
        xp = block_tail_plain(y, xp, w1s[j], w2s[j], wsas[j],
                              pad=pad if j == k - 1 else 1, x_pad=1, eps=eps)
    return xp


@functools.cache
def _lib() -> ctypes.CDLL:
    dll = _build.load_library("residual_chain")
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.ducosy_residual_block.restype = i
    dll.ducosy_residual_block.argtypes = [p] * 15 + [i] * 6 + [
        ctypes.c_float, i, p]
    return dll


def _validate(xp, was, wbs, w1s, w2s, wsas, pad) -> None:
    if xp.device.type != "cuda":
        raise ValueError(f"residual_chain kernel: carry on {xp.device}; the "
                         "kernel takes CUDA tensors (CPU runs the plain path)")
    if xp.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"residual_chain kernel: dtype {xp.dtype} (float32 "
                        "or bfloat16 only)")
    if xp.dim() != 4 or not xp.is_contiguous() or xp.data_ptr() % 16:
        raise ValueError("residual_chain kernel: needs a contiguous, 16-byte "
                         "aligned NHWC carry")
    n, hp, wp, c = xp.shape
    k = was.shape[0]
    r = w1s.shape[-1]
    want = {"was": (k, 3, 3, c, c), "wbs": (k, 3, 3, c, c),
            "w1s": (k, c, r), "w2s": (k, r, c),
            "wsas": (k, SA_KERNEL, SA_KERNEL, 2, 1)}
    for name, t in zip(want, (was, wbs, w1s, w2s, wsas)):
        if tuple(t.shape) != want[name] or t.device != xp.device:
            raise ValueError(f"residual_chain kernel: {name} is "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{want[name]} on {xp.device}")
    if c % TILE_N or not 0 < c <= 1024 or not 0 < r <= c:
        raise ValueError(f"residual_chain kernel: C={c}, R={r} (C a multiple "
                         f"of {TILE_N} up to 1024, 0 < R <= C)")
    if min(hp, wp) < 4 or pad not in (0, 1):
        raise ValueError(f"residual_chain kernel: carry {hp}x{wp}, pad={pad} "
                         "(needs H, W >= 2 inside the pad, pad 0 or 1)")


def residual_chain(xp, was, wbs, w1s, w2s, wsas, *, pad: int = 1,
                   eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """k residual blocks on the reflect-padded carry xp (N, H+2, W+2, C);
    returns (N, H+2*pad, W+2*pad, C). The K1 kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if xp.device.type == "cpu":
        return residual_chain_plain(xp, was, wbs, w1s, w2s, wsas, pad=pad,
                                    eps=eps)
    _validate(xp, was, wbs, w1s, w2s, wsas, pad)
    n, hp, wp, c = xp.shape
    h, w = hp - 2, wp - 2
    k, r = was.shape[0], w1s.shape[-1]
    dt, dev = xp.dtype, xp.device
    tiles = -(-h * w // TILE_M)
    f32 = dict(dtype=torch.float32, device=dev)
    # weights in the kernel's layouts: conv (tap, Cin, Cout) in the io
    # dtype; spatial gate (avg taps | max taps); MLP in fp32
    wa = was.reshape(k, 9 * c, c).to(dt).contiguous()
    wb = wbs.reshape(k, 9 * c, c).to(dt).contiguous()
    w1 = w1s.to(torch.float32).contiguous()
    w2 = w2s.to(torch.float32).contiguous()
    wsa = wsas.reshape(k, SA_KERNEL * SA_KERNEL, 2).transpose(1, 2) \
        .to(torch.float32).contiguous()
    acc = torch.empty((n, h * w, c), **f32)
    tp = torch.empty((n, hp, wp, c), dtype=dt, device=dev)
    partials = torch.empty((3, n, tiles, c), **f32)
    stats = torch.empty((3, n, c), **f32)
    dll = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for j in range(k):
            p = pad if j == k - 1 else 1
            out = torch.empty((n, h + 2 * p, w + 2 * p, c), dtype=dt,
                              device=dev)
            status = dll.ducosy_residual_block(
                xp.data_ptr(), wa[j].data_ptr(), wb[j].data_ptr(),
                w1[j].data_ptr(), w2[j].data_ptr(), wsa[j].data_ptr(),
                out.data_ptr(), acc.data_ptr(), tp.data_ptr(),
                partials[0].data_ptr(), partials[1].data_ptr(),
                partials[2].data_ptr(), stats[0].data_ptr(),
                stats[1].data_ptr(), stats[2].data_ptr(),
                n, h, w, c, r, p, float(eps), int(dt == torch.bfloat16),
                stream)
            _build.check(dll, status, f"residual_chain block {j} launch")
            xp = out
    residual_chain.launches += 1
    return xp


residual_chain.launches = 0
