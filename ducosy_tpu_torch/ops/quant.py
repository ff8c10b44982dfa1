"""Quantized serving's int8 grids, weight quantization and the plain int8
convs (ducosy_tpu/ops/pallas/instance_norm.py:27-65,
ducosy_tpu/models/fused.py:115-172, :243-275).

Two activation grids:
  symmetric  q = clip(round(x * 127 / S), -127, 127): the stem input at
             S = 1.0 (``quantize_static``, fused.py:115-121);
  shifted    q = trunc(min(y * 255 / S + 0.5, 255)) - 128 for a ReLU'd
             y >= 0, S = ``INT8_NORM_SCALE``: every other int8 activation.
             -128 is the exact code of 0, so a zero pad on this grid is a
             -128 pad. The math runs in fp32 on whatever value the caller
             hands in: K1q and ``in_relu_int8`` quantize the fp32 normalized
             value, K2's int8 write the value rounded to the io dtype
             (ops/kernels/instance_norm.py).
Weights are symmetric per output channel: ws = max|w| / 127, wq =
round(w / ws) (half to even, as ``jnp.round``), quantized once from the
fp32 master weights.

The int8 convs here are library convs, as the JAX package left them to
XLA's int8 conv with an int32 accumulator: an im2col of the int8 tensor
and ``torch._int_mm`` (cuBLASLt's int8 GEMM on a card), whose int32 sums
are exact (|sum| <= 3136 x 127 x 128 < 2^31 for the head). An fp32 conv
would not do: the worst trunk conv sums 2304 taps of 127 x 128, ~3.7e7 >
2^24.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ducosy_tpu_torch.models.layers import EPS_INSTANCE_NORM, reflect_pad

INT8_GRID = 255.0
INT8_ZERO_POINT = 128
# The static post-IN+ReLU activation scale, read from the same variable as
# the JAX package (instance_norm.py:55) so both quantize on one grid.
INT8_NORM_SCALE = float(os.environ.get("DUCOSY_INT8_SCALE", "12.0"))
QUANT_MODES = (None, "trunk", "full")


def check_quant(quant):
    """Raise ValueError unless ``quant`` is None, "trunk" or "full"."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be None, 'trunk' or 'full': {quant!r}")
    return quant


def quantize_weights_int8(w: torch.Tensor, dims=(0, 1, 2)):
    """Symmetric per-output-channel int8 weights of an HWIO kernel (output
    channel last): (wq int8, ws fp32) with ws = max|w| / 127 over ``dims``."""
    w32 = w.to(torch.float32)
    ws = torch.clamp_min(w32.abs().amax(dim=dims), 1e-12) / 127.0
    return torch.round(w32 / ws).to(torch.int8).contiguous(), ws


def quantize_static(x: torch.Tensor, act_scale: float) -> torch.Tensor:
    """The symmetric int8 grid at a static scale (fused.py:115-121)."""
    q = torch.round(x.to(torch.float32) * (127.0 / act_scale))
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


def quantize_shifted(y: torch.Tensor, scale: float = INT8_NORM_SCALE):
    """The shifted grid of a non-negative value, in fp32: trunc(min(y * 255/S
    + 0.5, 255)) - 128. The trunc runs on the non-negative value, before the
    shift, so it rounds half up."""
    k = torch.tensor(INT8_GRID / scale, dtype=torch.float32, device=y.device)
    q = torch.clamp_max(y.to(torch.float32) * k + 0.5, INT8_GRID)
    return (q.to(torch.int32) - INT8_ZERO_POINT).to(torch.int8)


def in_relu_int8(x: torch.Tensor, *, pad: int = 0,
                 scale: float = INT8_NORM_SCALE, phases: int = 1,
                 eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """IN (fp32 centred statistics) + ReLU of an NHWC tensor, reflect-padded
    by ``pad``, on the shifted grid, quantized from the fp32 value:
    ``packed_in_relu_int8`` (fused.py:154-172, statistics pooled over the
    ``phases`` groups of a packed channel axis, channel = phase * C + c)
    and K1q's write of its intermediate (conv_in.py:380-386)."""
    n, h, w, cf = x.shape
    x32 = x.to(torch.float32)
    dims = (1, 2)
    if phases > 1:
        x32, dims = x32.reshape(n, h, w, phases, cf // phases), (1, 2, 3)
    xc = x32 - x32.mean(dim=dims, keepdim=True)
    y = torch.relu(xc * torch.rsqrt(xc.square().mean(dim=dims, keepdim=True)
                                    + eps))
    return quantize_shifted(reflect_pad(y.reshape(n, h, w, cf), pad), scale)


def pad_shifted(x8: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad an NHWC shifted-grid tensor by ``pad``: the fill is -128."""
    return F.pad(x8, (0, 0, pad, pad, pad, pad), value=-INT8_ZERO_POINT)


def int_conv(x8: torch.Tensor, wq: torch.Tensor, stride: int = 1):
    """The exact int32 VALID conv of int8 NHWC x8 with int8 HWIO wq: an
    im2col by strided slices of the int8 tensor, then ``torch._int_mm``
    (int8 x int8 -> int32). K and Cout are zero-padded to multiples of 8,
    as ``_int_mm`` needs, and the batch runs in slices that keep the im2col
    near 1 GiB."""
    n, h, w, c = x8.shape
    kh, kw, _, cout = wq.shape
    ho, wo = (h - kh) // stride + 1, (w - kw) // stride + 1
    k = kh * kw * c
    kp, cp = -(-k // 8) * 8, max(8, -(-cout // 8) * 8)
    wm = torch.zeros((kp, cp), dtype=torch.int8, device=x8.device)
    wm[:k, :cout] = wq.reshape(k, cout)
    per = max(1, (1 << 30) // (ho * wo * kp))
    out = []
    for lo in range(0, n, per):
        xs = x8[lo:lo + per]
        cols = [xs[:, i:i + stride * (ho - 1) + 1:stride,
                   j:j + stride * (wo - 1) + 1:stride] for i in range(kh)
                for j in range(kw)]
        if kp > k:
            cols.append(xs.new_zeros(xs.shape[:1] + (ho, wo, kp - k)))
        a = torch.cat(cols, dim=-1).reshape(-1, kp)
        out.append(torch._int_mm(a, wm)[:, :cout].reshape(-1, ho, wo, cout))
    return torch.cat(out)


def dequantize(acc: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, bias,
               act_scale: float, *, dtype, zero_point: int = 0):
    """The conv epilogue of ``_conv_int8_static`` (fused.py:140-151): the
    exact accumulator to fp32, plus zero_point * sum(wq) per output channel,
    times ws * S / grid, plus the bias, cast to ``dtype``."""
    acc = acc.to(torch.float32)
    grid = INT8_GRID if zero_point else 127.0
    if zero_point:
        acc = acc + zero_point * wq.to(torch.float32).sum(dim=(0, 1, 2))
    y = acc * (ws * (act_scale / grid))
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(dtype)


def conv_int8_static(x8, wq, ws, bias, act_scale: float, *, stride: int = 1,
                     dtype, zero_point: int = 0) -> torch.Tensor:
    """int8 activations at a static scale x int8 per-channel weights, exact
    integer accumulation, dequantized in the epilogue (fused.py:124-151).
    x8 (N, H, W, Cin) is already padded (with -128 on the shifted grid:
    the 128 * sum(wq) term is exact only when every tap sees a shifted
    value); wq (kh, kw, Cin, Cout) int8, ws (Cout,) fp32."""
    return dequantize(int_conv(x8, wq, stride), wq, ws, bias, act_scale,
                      dtype=dtype, zero_point=zero_point)


def conv_int8_dynamic(x, wq, ws, bias) -> torch.Tensor:
    """``_conv_int8`` (fused.py:86-112), the XLA trunk's int8 conv: each
    sample's activations quantized symmetrically at that sample's own amax
    (scale max(amax, 1e-12) / 127 over H, W, C; round half to even, as
    ``jnp.round``), per-output-channel int8 weights ``wq`` (kh, kw, Cin,
    Cout) with fp32 scales ``ws``, the exact int32 VALID conv of the
    pre-padded x, dequantized in fp32 before the bias, cast to x's dtype.
    The scale is per sample, never over the batch."""
    x32 = x.to(torch.float32)
    xs = torch.clamp_min(x32.abs().amax(dim=(1, 2, 3), keepdim=True),
                         1e-12) / 127.0
    xq = torch.round(x32 / xs).to(torch.int8)
    y = int_conv(xq, wq).to(torch.float32) * (xs * ws.reshape(1, 1, 1, -1))
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


def subpixel_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO 3x3 kernel -> (2, 2, Cin, 4*Cout) phase kernels of nearest-up(2)
    + zero-pad 1 + 3x3 conv, phase (p, q) in output block 2p + q
    (``subpixel_kernel``, fused.py:243-256). Taps are summed in fp32 in the
    order ``up2_packed_kernel`` (fused.py:398-416) sums them, row-major from
    zero, so the quantized weights are those of the packed forward."""
    w = w.to(torch.float32)
    cin, cout = w.shape[2], w.shape[3]
    out = torch.zeros((2, 2, cin, 4 * cout), dtype=torch.float32,
                      device=w.device)
    for p in range(2):
        for q in range(2):
            blk = out[..., (2 * p + q) * cout:(2 * p + q + 1) * cout]
            for dr in range(3):
                for dc in range(3):
                    a = (p + dr - 1) // 2 + 1 - p
                    b = (q + dc - 1) // 2 + 1 - q
                    blk[a, b] += w[dr, dc]
    return out


def upsample_conv_int8(x8, wq, ws, act_scale: float, *, dtype):
    """nearest-up(2) + zero-pad 1 + 3x3 conv of a shifted-grid int8 NHWC x8
    as four 2x2 phase convs (``upsample_conv_subpixel``, fused.py:259-275)
    with ``subpixel_weights`` quantized per (phase, output channel): returns
    (N, 2H, 2W, Cout) in ``dtype``, without the bias."""
    n, h, w, _ = x8.shape
    cout = wq.shape[-1] // 4
    c4 = dequantize(int_conv(pad_shifted(x8, 1), wq), wq, ws, None,
                    act_scale, dtype=dtype, zero_point=INT8_ZERO_POINT)
    ph = [c4[:, p:p + h, q:q + w, (2 * p + q) * cout:(2 * p + q + 1) * cout]
          for p in range(2) for q in range(2)]
    top = torch.stack(ph[:2], dim=3)
    bot = torch.stack(ph[2:], dim=3)
    return torch.stack([top, bot], dim=2).reshape(n, 2 * h, 2 * w, cout)
