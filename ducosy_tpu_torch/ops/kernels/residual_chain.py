"""K1: a chain of k CBAM residual blocks on a reflect-padded NHWC carry.

Replaces ``residual_chain_pallas`` (ducosy_tpu/ops/pallas/conv_in.py:399)
with ``quant=False`` and ``quant=True`` (K1q); at k=1 it is
``residual_block_pallas`` (K6, :308).
Each block (modules/model.py:68-87):
  conv1 3x3 VALID -> IN -> ReLU -> reflect-pad 1 -> conv2 3x3 -> IN ->
  CBAM channel gate -> spatial gate -> + skip (carry interior) ->
  reflect pad (1 inside the chain, ``pad`` after the last block).
Conv biases are not inputs: each conv feeds an InstanceNorm, whose mean
subtraction cancels a per-channel constant exactly.

The kernel is CUDA C++ (``csrc/residual_chain.cu``): each block is K7's
launch (conv1 + IN + ReLU + pad into t) then K8's (conv2 + CBAM tail + skip +
pad), each half by the route ``conv_in.conv_route`` gives it: two
cooperative launches a block where a sample's tiles fit on the card at once
(bf16), with the fp32 accumulator held in registers, else six launches that
send it through device memory (see the source note there).
``residual_chain_plain`` is the TPU package's XLA composition
(conv_in.py:501-536) in plain PyTorch, with optional conv biases: per block
``conv3x3_in_plain`` then ``conv_block_tail_plain`` of
ops/kernels/conv_in.py.

K1q (``quant=True``, conv_in.py:366-369, :380-386): the intermediate t is
written int8 on the shifted grid and conv2 runs int8 x int8 -> int32. The
caller passes conv2's weights already quantized (``ops.quant.
quantize_weights_int8`` of the fp32 master weights, once, at build time) as
int8 ``wbs`` with their per-channel scales ``wb_scales``; the kernel needs
no scale (the tail's IN absorbs it), the plain version dequantizes with it.

Weights use the JAX layouts, as ``residual_chain_pallas`` takes them:
was/wbs (k, 3, 3, C, C) HWIO; w1s (k, C, R); w2s (k, R, C);
wsas (k, 7, 7, 2, 1) HWIO.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ducosy_tpu_torch.models.layers import EPS_INSTANCE_NORM
from ducosy_tpu_torch.ops.kernels import _build
from ducosy_tpu_torch.ops.kernels.block_tail import SA_KERNEL
from ducosy_tpu_torch.ops.kernels.conv_in import (  # noqa: F401 (TILE_M)
    TILE_M,
    TILE_N,
    conv3x3,
    conv3x3_in_plain,
    conv_block_tail_plain,
    kernel_weights,
    make_scratch,
    resident_blocks,
    sample_groups,
)
from ducosy_tpu_torch.ops.quant import INT8_GRID, INT8_NORM_SCALE


def quant_intermediate_plain(xp, wa, b1=None, *,
                             eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """K1q's t of one block in plain PyTorch: conv1 (HWIO wa, io-dtype
    operands) accumulated in fp32, IN + ReLU + reflect pad 1, shifted-grid
    int8 of the fp32 value (conv_in.py:379-389)."""
    return conv3x3_in_plain(xp, wa, pad=1, int8_scale=INT8_NORM_SCALE,
                            bias=b1, eps=eps)


def residual_chain_plain(xp, was, wbs, w1s, w2s, wsas, *, pad: int = 1,
                         eps: float = EPS_INSTANCE_NORM, b1s=None, b2s=None,
                         quant: bool = False, wb_scales=None):
    """Plain PyTorch K1: per-block conv -> IN+ReLU+pad -> conv -> tail.
    ``b1s``/``b2s`` (k, C) are optional conv biases (the reference module
    has them; IN cancels them up to rounding).

    ``quant``: the JAX CPU composition of K1q, ``_xla_conv_in(int8_scale)``
    then ``_xla_conv_tail(in_int8_scale)`` (conv_in.py:501-536), at the TPU
    kernel's rounding points: conv1's fp32 accumulator is normalized and
    quantized in fp32 (conv_in.py:379-386), the int8 conv2 is dequantized
    with ``wb_scales`` (k, C) to the io dtype before the tail. At fp32 the
    two are the same computation."""
    k = was.shape[0]
    if quant and (wbs.dtype != torch.int8 or wb_scales is None):
        raise ValueError("residual_chain quant: wbs must be int8 with "
                         "wb_scales")
    for j in range(k):
        t = conv3x3_in_plain(
            xp, was[j], pad=1, eps=eps, bias=None if b1s is None else b1s[j],
            int8_scale=INT8_NORM_SCALE if quant else None)
        xp = conv_block_tail_plain(
            t, xp, wbs[j], w1s[j], w2s[j], wsas[j],
            pad=pad if j == k - 1 else 1, x_pad=1, in_int8=quant,
            w_scale=wb_scales[j] if quant else None,
            bias=None if b2s is None else b2s[j], eps=eps)
    return xp


@functools.cache
def _lib() -> ctypes.CDLL:
    dll = _build.load_library("residual_chain")
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.ducosy_residual_block.restype = i
    dll.ducosy_residual_block.argtypes = [p] * 17 + [i] * 6 + [
        ctypes.c_float, ctypes.c_float, i, i, i, p]
    return dll


def _validate(xp, was, wbs, w1s, w2s, wsas, pad, quant) -> None:
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
    if quant != (wbs.dtype == torch.int8):
        raise TypeError(f"residual_chain kernel: wbs {wbs.dtype} with "
                        f"quant={quant} (int8 exactly when quant)")
    if c % TILE_N or not 0 < c <= 1024 or not 0 < r <= c:
        raise ValueError(f"residual_chain kernel: C={c}, R={r} (C a multiple "
                         f"of {TILE_N} up to 1024, 0 < R <= C)")
    if min(hp, wp) < 4 or pad not in (0, 1):
        raise ValueError(f"residual_chain kernel: carry {hp}x{wp}, pad={pad} "
                         "(needs H, W >= 2 inside the pad, pad 0 or 1)")
    if xp.device.type != "cuda":
        raise ValueError(f"residual_chain kernel: carry on {xp.device}; the "
                         "kernel takes CUDA tensors (CPU runs the plain path)")


def residual_chain(xp, was, wbs, w1s, w2s, wsas, *, pad: int = 1,
                   eps: float = EPS_INSTANCE_NORM, quant: bool = False,
                   wb_scales=None, tp=None) -> torch.Tensor:
    """k residual blocks on the reflect-padded carry xp (N, H+2, W+2, C);
    returns (N, H+2*pad, W+2*pad, C). The K1 kernel (K1q with ``quant``)
    for a CUDA tensor, the plain version for a CPU tensor. ``tp``, shaped
    like xp (int8 under ``quant``), is the kernel's scratch for each
    block's intermediate t: pass one to read the last block's t."""
    if xp.device.type == "cpu":
        return residual_chain_plain(xp, was, wbs, w1s, w2s, wsas, pad=pad,
                                    eps=eps, quant=quant, wb_scales=wb_scales)
    _validate(xp, was, wbs, w1s, w2s, wsas, pad, quant)
    n, hp, wp, c = xp.shape
    h, w = hp - 2, wp - 2
    k, r = was.shape[0], w1s.shape[-1]
    dt, dev = xp.dtype, xp.device
    # weights in the kernel's layouts: the convs' as kernel_weights lays
    # them out (bf16 and K1q's int8 conv2 (tap, Cout, Cin), fp32 (tap, Cin,
    # Cout)); spatial gate (avg taps | max taps); MLP in fp32
    wa, wb = kernel_weights(was, dt), kernel_weights(wbs, dt)
    w1 = w1s.to(torch.float32).contiguous()
    w2 = w2s.to(torch.float32).contiguous()
    wsa = wsas.reshape(k, SA_KERNEL * SA_KERNEL, 2).transpose(1, 2) \
        .to(torch.float32).contiguous()
    tp_dtype = torch.int8 if quant else dt
    if tp is None:
        tp = torch.empty((n, hp, wp, c), dtype=tp_dtype, device=dev)
    elif tp.shape != xp.shape or tp.dtype != tp_dtype or \
            tp.device != dev or not tp.is_contiguous():
        raise ValueError(f"residual_chain kernel: tp {tuple(tp.shape)} "
                         f"{tp.dtype}, expected a contiguous "
                         f"{tuple(xp.shape)} {tp_dtype} tensor on {dev}")
    # each half of a block by its own route (ops/kernels/conv_in.py:
    # conv_route); the fp32 accumulator exists only where one is tiled
    blocks = resident_blocks(dev)
    groups_in = sample_groups(n, h, w, c, dt, blocks)
    groups_tail = sample_groups(n, h, w, c, dt, blocks, tail=True)
    sc = make_scratch(n, h, w, c, dev, dt, blocks)
    int8_k = INT8_GRID / INT8_NORM_SCALE if quant else 0.0
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
                out.data_ptr(), 0 if sc.acc is None else sc.acc.data_ptr(),
                tp.data_ptr(), *(t.data_ptr() for t in sc.partials),
                *(t.data_ptr() for t in sc.stats), sc.map.data_ptr(),
                sc.barrier.data_ptr(), n, h, w, c, r, p, float(eps), int8_k,
                int(dt == torch.bfloat16), groups_in, groups_tail, stream)
            _build.check(dll, status, f"residual_chain block {j} launch")
            conv3x3.launches += 2            # conv1 and conv2 of the block
            xp = out
    residual_chain.route = "resident" if groups_in and groups_tail else \
        "tiled" if not (groups_in or groups_tail) else "mixed"
    residual_chain.launches += 1
    return xp


residual_chain.launches = 0
residual_chain.route = None    # the route of the last K1 call's blocks
