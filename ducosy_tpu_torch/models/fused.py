"""The packed (space-to-depth) and fused generator forwards
(ducosy_tpu/models/fused.py), on NHWC tensors.

Both compute the function of ``models.generator.Generator`` on the same
parameters, reorganized:

  stem    the 7x7 conv from 1-3 channels as one 4x4 conv on the s2d(2)
          input producing all four output phases (``s2d_conv_kernel``,
          fused.py:198-240);
  up1/up2 nearest-upsample x2 + 3x3 conv as 2x2 sub-pixel phase convs that
          never build the 4x activation (``subpixel_kernel``, :243-276);
  packed  ``generator_apply_packed`` (:476-750): one s2d at the input, the
          encoder in packed-4 layout until down1 consumes it, the trunk in
          true layout, the decoder packed-4 then packed-16, the head's
          reflect pad as phase gathers (``packed16_reflect_pad3``), one
          depth-to-space of the (N, H/4, W/4, 16) output;
  fused   ``generator_apply_fused`` (:279-328): the s2d stem and sub-pixel
          up-convs in true layout, K2 (ReLU, pad 1) and K4 in the trunk.

Layouts: packed channels are phase-major, channel = (row phase * f + col
phase) * C + c. Weight transforms work on HWIO tensors, as the JAX code
does, and return HWIO; each output entry is its taps summed in the JAX
loop's order (``_assemble``), so the transforms are exact in fp32. The
convs that consume them are plain convs outside any Pallas kernel in JAX,
so they are ``F.conv2d`` here (``layers.conv2d``, NHWC as channels_last).
``PackedWeights`` lays the transformed weights out once: at load for
serving, once a generator a step for training (differentiably, in fp32,
each forward casting, ``cast_packed``); a module passed to
``generator_apply_packed`` is laid out in that call. Each layout is the
span and counter ``fused.pack_weights`` (``trace.py``); the transforms'
index tables are uploaded once a device (``fused.table_uploads``).

Trunks of the packed forward (true layout, 128^2 x 4 base at 512^2):
  "xla"       plain convs with biases, plain norms, the plain CBAM tail or
              h + IN(t) without CBAM; under quant both convs are
              ``conv_int8_dynamic`` (``_conv_int8``, :86-112);
  "pallas"    conv1 (bias) -> K2 (ReLU, pad 1) -> conv2 (bias) -> K4 on the
              padded carry (x_pad 1), each through its differentiable
              wrapper; under quant conv1 -> K2's int8 write (pad 1) -> the
              static int8 conv2 (zero point 128) -> K4 (:670-698);
  "mega"      K7 -> K8 a block (K7's int8 write, K8's int8 taps under quant);
  "mono"      K1 at k = 1 (K6) a block;
  "chain{k}"  K1 on groups of k blocks, the last group's pad 0 (the port's
              K1 takes any k);
  "auto"      "pallas" on a CUDA tensor, "xla" on a CPU tensor (the JAX
              function's ``pallas_available()``).
The kernel trunks need CBAM; a generator without it runs "xla" whatever the
trunk (fused.py:540). With ``encoder_fused`` (serving) and a kernel trunk,
the packed stem and up1 norms run K2 with ``phases`` 4, the up2 norm K2 with
``phases`` 16, down1's K2 with pad 0 and down2's K2 with pad 1 (the trunk's
first pad); without it (the training step, ducosy_tpu/train/step.py:
101-102) the packed norms stay plain and down2 gets a standalone pad. The
JAX package keeps its phase-grouped norms on XLA above ``_PHASE_FUSE_CAP``
(fused.py:58-69), a cap on a TPU kernel's VMEM window that holds every
channel of a sample; K2 tiles H x W and has no such window, which is why
the module forward already runs its stem, up1 and up2 norms on K2
(models/generator.py:17-21). The port ignores the cap.

Quantized modes (``quant``): "trunk" quantizes the trunk convs as above;
"full" also runs the stem (symmetric grid at scale 1.0), down1, down2, up2
and head as static int8 convs with -128 fills (:525-535, 587-601, 725-738),
their norms quantizing the fp32 value in plain PyTorch (``in_relu_int8``,
K2's int8 write quantizes the io-rounded one); up1 stays in the compute
dtype. The int8 weights are quantized per output channel of the transformed
kernels from the fp32 values.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ducosy_tpu_torch import trace
from ducosy_tpu_torch.models.convert import state_dict_blocks, \
    state_dict_has_cbam
from ducosy_tpu_torch.models.layers import (
    conv2d,
    instance_norm,
    reflect_pad,
)
from ducosy_tpu_torch.ops.kernels import block_tail as k4
from ducosy_tpu_torch.ops.kernels import conv_in as k7
from ducosy_tpu_torch.ops.kernels import instance_norm as k2
from ducosy_tpu_torch.ops.kernels import residual_chain as k1
from ducosy_tpu_torch.ops.kernels.block_tail import cbam_plain
from ducosy_tpu_torch.ops.kernels.instance_norm import instance_norm_plain
from ducosy_tpu_torch.ops.quant import (
    INT8_NORM_SCALE,
    INT8_ZERO_POINT,
    check_quant,
    conv_int8_dynamic,
    conv_int8_static,
    in_relu_int8,
    quantize_static,
    quantize_weights_int8,
)

# -------------------------------------------------------- layout helpers
def _s2d2(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C); channel order (pr, qr, c)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)


def _d2s2(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 4C) -> (N, 2H, 2W, C); channel order (p, q, o)."""
    return _d2s(x, 2)


def _d2s(x: torch.Tensor, f: int) -> torch.Tensor:
    """(N, H, W, f*f*C) packed -> (N, f*H, f*W, C) true grid."""
    n, h, w, cf = x.shape
    c = cf // (f * f)
    x = x.reshape(n, h, w, f, f, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, f * h, f * w, c)


# ----------------------------------------------------- weight transforms
def _table(entries, n_blocks: int) -> np.ndarray:
    """(n_blocks, terms) tap indices from (block, tap) pairs in the JAX
    loop's order; -1 pads a block with fewer terms (the zero tap)."""
    terms = [[] for _ in range(n_blocks)]
    for block, tap in entries:
        terms[block].append(tap)
    width = max(1, max(len(t) for t in terms))
    return np.array([t + [-1] * (width - len(t)) for t in terms], np.int64)


_indices: dict = {}   # (id(table), fill, device) -> (table, its index)


def _index(table: np.ndarray, fill: int, device) -> torch.Tensor:
    """A (cached) table as an index tensor on ``device``, its -1 entries
    ``fill``: built and uploaded once a table and device (the counter
    ``fused.table_uploads``), so a layout copies nothing from the host and
    never waits on the stream (as ``ops/filters.py``'s ``_operator``)."""
    key = (id(table), fill, device)
    hit = _indices.get(key)
    if hit is None:
        trace.count("fused.table_uploads")
        idx = torch.from_numpy(np.where(table < 0, fill, table)).to(device)
        hit = _indices[key] = (table, idx)   # the table keeps its id alive
    return hit[1]


def _assemble(taps: torch.Tensor, table: np.ndarray, kd: int, a: int,
              b: int) -> torch.Tensor:
    """The (kd, kd, a*Cin, b*Cout) HWIO kernel whose (d, e, i, j) block is
    the sum of its table row's taps (T, Cin, Cout), accumulated in the
    row's order from the first term, as ``zeros.at[].add`` in that order
    accumulates (0 + t0 = t0 exactly). Differentiable."""
    t, cin, cout = taps.shape
    ext = torch.cat([taps, taps.new_zeros((1, cin, cout))])
    idx = _index(table, t, taps.device)
    acc = ext[idx[:, 0]]
    for j in range(1, table.shape[1]):
        acc = acc + ext[idx[:, j]]
    return acc.reshape(kd, kd, a, b, cin, cout).permute(0, 1, 2, 4, 3, 5) \
        .reshape(kd, kd, a * cin, b * cout)


def _block(d: int, e: int, i: int, j: int, kd: int, a: int, b: int) -> int:
    return ((d * kd + e) * a + i) * b + j


@functools.cache
def _s2d_table(k: int) -> np.ndarray:
    kd, out = (k + 1) // 2, []
    for p in range(2):
        for q in range(2):
            for pr in range(2):
                for qr in range(2):
                    for d in range(kd):
                        u = 2 * d + pr - p
                        if not 0 <= u < k:
                            continue
                        for e in range(kd):
                            v = 2 * e + qr - q
                            if 0 <= v < k:
                                out.append((_block(d, e, pr * 2 + qr,
                                                   p * 2 + q, kd, 4, 4),
                                            u * k + v))
    return _table(out, kd * kd * 16)


def s2d_conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """k x k (k odd) HWIO kernel -> the ((k+1)/2, ., 4Cin, 4Cout) kernel of
    the same conv on the s2d(2) input, all four output phases at once
    (fused.py:198-222)."""
    k, _, cin, cout = w.shape
    kd = (k + 1) // 2
    return _assemble(w.reshape(k * k, cin, cout), _s2d_table(k), kd, 4, 4)


def stem_s2d(x, kernel, bias, *, ref_pad: int, dtype) -> torch.Tensor:
    """ReflectionPad(p) + k x k VALID conv on the s2d(2) grid
    (fused.py:225-240); kernel HWIO."""
    k = kernel.shape[0]
    xp = reflect_pad(x.to(dtype), ref_pad)
    if xp.shape[1] % 2:   # the extra high row/col is never tapped
        xp = F.pad(xp, (0, 0, 0, 1, 0, 1))
    y = _conv(_s2d2(xp), _oihw(s2d_conv_kernel(kernel), dtype))
    h_out = (x.shape[1] + 2 * ref_pad - k + 1) // 2
    w_out = (x.shape[2] + 2 * ref_pad - k + 1) // 2
    y = _d2s2(y[:, :h_out, :w_out])
    return y + bias.to(y.dtype)


def subpixel_kernel(w: torch.Tensor) -> torch.Tensor:
    """3x3 HWIO kernel -> (2, 2, Cin, 4Cout) phase kernels equivalent to
    nearest-upsample(2) + zero-pad(1) + VALID 3x3 conv (fused.py:243-256),
    summed in the JAX order (rows, then columns)."""
    r0 = torch.stack([w[0], w[1] + w[2]])
    r1 = torch.stack([w[0] + w[1], w[2]])

    def cols(rw):
        c0 = torch.stack([rw[:, 0], rw[:, 1] + rw[:, 2]], dim=1)
        c1 = torch.stack([rw[:, 0] + rw[:, 1], rw[:, 2]], dim=1)
        return c0, c1

    k00, k01 = cols(r0)
    k10, k11 = cols(r1)
    return torch.cat([k00, k01, k10, k11], dim=-1)


def upsample_conv_subpixel(x, kernel, bias, *, dtype) -> torch.Tensor:
    """nearest-upsample x2 + SAME 3x3 conv without the 4x activation
    (fused.py:259-275); kernel HWIO."""
    n, h, w, _ = x.shape
    cout = kernel.shape[-1]
    wsub = subpixel_kernel(kernel.to(torch.float32))
    c4 = _conv(F.pad(x.to(dtype), (0, 0, 1, 1, 1, 1)), _oihw(wsub, dtype))
    ph = [c4[:, p:p + h, q:q + w, (2 * p + q) * cout:(2 * p + q + 1) * cout]
          for p in range(2) for q in range(2)]
    top = torch.stack(ph[:2], dim=3)
    bot = torch.stack(ph[2:], dim=3)
    out = torch.stack([top, bot], dim=2).reshape(n, 2 * h, 2 * w, cout)
    return out + bias.to(out.dtype)


@functools.cache
def _down_table() -> np.ndarray:
    out = []
    for pr in range(2):
        for qr in range(2):
            for d in range(2):
                u = 2 * d + pr - 1
                if not 0 <= u < 3:
                    continue
                for e in range(2):
                    v = 2 * e + qr - 1
                    if 0 <= v < 3:
                        out.append((_block(d, e, pr * 2 + qr, 0, 2, 4, 1),
                                    u * 3 + v))
    return _table(out, 16)


def down_conv_packed_kernel(w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 zero-pad-1 conv on a packed-4 input: (2, 2, 4Cin, Cout);
    the input takes one zero packed row/col on the low side only
    (fused.py:362-380)."""
    _, _, cin, cout = w.shape
    return _assemble(w.reshape(9, cin, cout), _down_table(), 2, 4, 1)


@functools.cache
def _up_table() -> np.ndarray:
    # tap (a * 2 + b) * 4 + phase of the sub-pixel kernel goes to window
    # offset (p + a, q + b), output phase p * 2 + q
    out = []
    for p in range(2):
        for q in range(2):
            for a in range(2):
                for b in range(2):
                    out.append((_block(p + a, q + b, 0, p * 2 + q, 3, 1, 4),
                                (a * 2 + b) * 4 + p * 2 + q))
    return _table(out, 36)


def up_packed_kernel(w: torch.Tensor) -> torch.Tensor:
    """nearest-up(2) + zero-pad-1 + 3x3 conv with the output left packed-4:
    (3, 3, Cin, 4Cout), the four sub-pixel phase kernels at their offsets in
    one 3x3 window (fused.py:383-395)."""
    _, _, cin, cout = w.shape
    sub = subpixel_kernel(w).reshape(2, 2, cin, 4, cout)
    taps = sub.permute(0, 1, 3, 2, 4).reshape(16, cin, cout)
    return _assemble(taps, _up_table(), 3, 1, 4)


@functools.cache
def _up2_table() -> np.ndarray:
    out = []
    for t in range(4):
        for s in range(4):
            for dr in range(3):
                for dc in range(3):
                    fr, fc = (t + dr - 1) // 2, (s + dc - 1) // 2
                    d, alpha = fr // 2 + 1, fr % 2
                    e, beta = fc // 2 + 1, fc % 2
                    out.append((_block(d, e, alpha * 2 + beta, t * 4 + s,
                                       3, 4, 16), dr * 3 + dc))
    return _table(out, 9 * 64)


def up2_packed_kernel(w: torch.Tensor) -> torch.Tensor:
    """nearest-up(2) + zero-pad-1 + 3x3 conv from a packed-4 input to a
    packed-16 output: (3, 3, 4Cin, 16Cout) (fused.py:398-416)."""
    _, _, cin, cout = w.shape
    return _assemble(w.reshape(9, cin, cout), _up2_table(), 3, 4, 16)


@functools.cache
def _head_table(k: int) -> np.ndarray:
    out = []
    for t in range(4):
        for s in range(4):
            for u in range(k):
                for v in range(k):
                    fr, fc = (t + u - 3) // 4, (s + v - 3) // 4
                    d, alpha = fr + 1, (t + u - 3) % 4
                    e, beta = fc + 1, (s + v - 3) % 4
                    out.append((_block(d, e, alpha * 4 + beta, t * 4 + s,
                                       3, 16, 16), u * k + v))
    return _table(out, 9 * 256)


def head_packed_kernel(w: torch.Tensor) -> torch.Tensor:
    """7x7 conv (reflect-padded separately) with input and output packed-16:
    (3, 3, 16Cin, 16Cout) (fused.py:419-436)."""
    k, _, cin, cout = w.shape
    return _assemble(w.reshape(k * k, cin, cout), _head_table(k), 3, 16, 16)


def packed16_edge(border: torch.Tensor, c: int, axis: int, side: str,
                  fill=0) -> torch.Tensor:
    """The packed row (``axis`` 1) or column (2) that ``packed16_reflect_pad3``
    puts before ("pre": true lines -4..-1) or after ("post": H..H+3) a
    packed-16 tensor whose first or last packed line is ``border``: a phase
    permutation of it, the never-tapped outermost true line ``fill``."""
    dim = -3 if axis == 1 else -2
    perm = [None, 3, 2, 1] if side == "pre" else [2, 1, 0, None]
    b = border.reshape(border.shape[:-1] + (4, 4, c))
    parts = [torch.full_like(b.select(dim, 0), fill) if k_ is None
             else b.select(dim, k_) for k_ in perm]
    return torch.stack(parts, dim=dim).reshape(border.shape)


def packed16_reflect_pad3(x: torch.Tensor, c: int, fill=0) -> torch.Tensor:
    """True-grid ReflectionPad2d(3) of a packed-16 tensor: one packed
    row/col a side whose phase channels are the reflected true rows/cols
    (a phase permutation of the adjacent packed row/col); the never-tapped
    outermost true line is ``fill`` (-128 on the shifted int8 grid, the
    exact code of 0) (fused.py:439-473)."""
    for axis in (1, 2):
        first = x.narrow(axis, 0, 1)
        last = x.narrow(axis, x.shape[axis] - 1, 1)
        x = torch.cat([packed16_edge(first, c, axis, "pre", fill), x,
                       packed16_edge(last, c, axis, "post", fill)], dim=axis)
    return x


# ---------------------------------------------------------------- norms
def packed_in_relu(x: torch.Tensor, groups: int,
                   relu: bool = True) -> torch.Tensor:
    """IN(+ReLU) over the true grid of a packed tensor, statistics pooled
    over (H, W, phase groups), in plain PyTorch (fused.py:348-359)."""
    return instance_norm_plain(x, relu=relu, phases=groups)


def packed_in_relu_int8(x: torch.Tensor, groups: int,
                        scale: float = INT8_NORM_SCALE) -> torch.Tensor:
    """``packed_in_relu`` written on the shifted int8 grid from the fp32
    value (fused.py:154-172)."""
    return in_relu_int8(x, scale=scale, phases=groups)


def _in_relu(t: torch.Tensor) -> torch.Tensor:
    """``_instance_norm_xla(t, relu=True)`` (fused.py:175-181)."""
    return torch.relu(instance_norm(t))


# ---------------------------------------------------------------- weights
def _oihw(w_hwio: torch.Tensor, dtype) -> torch.Tensor:
    return w_hwio.permute(3, 2, 0, 1).to(dtype)


def _conv(x, w_oihw, bias=None, *, stride: int = 1, padding: int = 0):
    """VALID (or zero-padded) conv of NHWC x with an OIHW weight in x's
    dtype, plus the bias in that dtype (``_conv``, fused.py:72-83)."""
    return conv2d(x, w_oihw, None if bias is None else bias.to(x.dtype),
                  stride=stride, padding=padding)


class PackedWeights(NamedTuple):
    """A generator's weights as the packed forward takes them: convs OIHW
    in the compute dtype (under ``quant="full"`` the stem, down1, down2,
    up2 and head have only their int8 version), biases fp32 (the packed
    ones tiled over the phases), the trunk as HWIO stacks in the kernels'
    JAX layouts, and the int8 (wq, ws) pairs of ``quant``."""
    blocks: int
    use_cbam: bool
    channels: int        # the head's input channels (co2)
    dtype: torch.dtype
    quant: str | None
    convs: Dict[str, torch.Tensor]
    biases: Dict[str, torch.Tensor]
    trunk: tuple         # (was, wbs, w1s, w2s, wsas) HWIO stacks, or ()
    int8: Dict[str, tuple]


def _param_dict(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return {k: v if isinstance(v, torch.Tensor) else
            torch.from_numpy(np.array(v)) for k, v in params.items()}


def packed_weights(params, *, dtype, quant: str | None = None,
                   memory_format=torch.contiguous_format) -> PackedWeights:
    """The transformed weights of a ``Generator`` (module or reference-layout
    state dict): differentiable from a module's parameters (training) or,
    once, for serving, where ``memory_format=torch.channels_last`` lays the
    conv weights out for cuDNN's NHWC convs."""
    sd = _param_dict(params)
    r, use_cbam = state_dict_blocks(sd), state_dict_has_cbam(sd)
    f32 = lambda key: sd[key].to(torch.float32)
    hwio = lambda key: f32(key).permute(2, 3, 1, 0)
    full = check_quant(quant) == "full"
    ui, u2, hd = 11 + r, 15 + r, 19 + r
    hw = {"stem": s2d_conv_kernel(hwio("model.1.weight")),
          "d1": down_conv_packed_kernel(hwio("model.4.weight")),
          "d2": hwio("model.7.weight"),
          "u1": up_packed_kernel(hwio(f"model.{ui}.weight")),
          "u2": up2_packed_kernel(hwio(f"model.{u2}.weight")),
          "hd": head_packed_kernel(hwio(f"model.{hd}.weight"))}
    int8 = {}
    if full:
        int8 = {k: quantize_weights_int8(hw.pop(k).detach())
                for k in ("stem", "d1", "d2", "u2", "hd")}
    lay = lambda w: _oihw(w, dtype).contiguous(memory_format=memory_format)
    convs = {k: lay(v) for k, v in hw.items()}
    biases = {"stem": f32("model.1.bias").repeat(4),
              "d1": f32("model.4.bias"), "d2": f32("model.7.bias"),
              "u1": f32(f"model.{ui}.bias").repeat(4),
              "u2": f32(f"model.{u2}.bias").repeat(16),
              "hd": f32(f"model.{hd}.bias").repeat(16)}
    for i in range(r):
        base = f"model.{10 + i}.block"
        for j, name in ((1, "c1"), (5, "c2")):
            convs[f"{name}_{i}"] = lay(hwio(f"{base}.{j}.weight"))
            biases[f"{name}_{i}"] = f32(f"{base}.{j}.bias")
    trunk = ()
    if r:
        stack = lambda fn: torch.stack([fn(f"model.{10 + i}")
                                        for i in range(r)])
        trunk = (stack(lambda b: hwio(f"{b}.block.1.weight")),
                 stack(lambda b: hwio(f"{b}.block.5.weight")))
        if use_cbam:
            ca = ".cbam.channel_attention.fc"
            trunk += (
                stack(lambda b: f32(f"{b}{ca}.0.weight")[:, :, 0, 0].T),
                stack(lambda b: f32(f"{b}{ca}.2.weight")[:, :, 0, 0].T),
                stack(lambda b: hwio(f"{b}.cbam.spatial_attention.conv"
                                     ".weight")))
        if quant:
            for name, w in (("c1", trunk[0]), ("c2", trunk[1])):
                q = [quantize_weights_int8(w[i].detach()) for i in range(r)]
                int8[name] = tuple(torch.stack(t) for t in zip(*q))
    return PackedWeights(r, use_cbam, int(sd[f"model.{hd}.weight"].shape[1]),
                         dtype, quant, convs, biases, trunk, int8)


def lay_out(params, *, dtype, quant: str | None = None) -> PackedWeights:
    """``packed_weights`` of a module or state dict inside the span and
    counter ``fused.pack_weights``: once a forward when a module is passed
    to ``generator_apply_packed``, once a generator a training step."""
    trace.count("fused.pack_weights")
    with trace.span("fused.pack_weights"):
        return packed_weights(params, dtype=dtype, quant=quant)


def cast_packed(pw: PackedWeights, dtype) -> PackedWeights:
    """``pw`` with its convs in ``dtype``, differentiably. The training step
    lays its generators out in fp32 and each forward casts: the forwards'
    weight gradients then meet, and sum, in fp32 at the shared layout."""
    if pw.dtype == dtype:
        return pw
    return pw._replace(dtype=dtype, convs={k: v.to(dtype)
                                           for k, v in pw.convs.items()})


# ------------------------------------------------------------------ trunks
def trunk_plain(h, blocks, *, fused_norm: bool = False, int8=None):
    """The reference blocks on the unpadded carry h, each conv with its
    bias, in plain PyTorch: x + [CBAM](IN(conv2(pad(ReLU(IN(conv1(pad(x)))))))
    (ducosy_tpu/models/generator.py:88-108, fused.py:700-714). ``blocks``:
    per block (conv1 OIHW, its bias, conv2 OIHW, its bias), then (fc1,
    fc2, wsa) for CBAM. ``int8``: the (wq, ws) stacks of conv1 and conv2,
    both convs by per-sample dynamic requant (``_conv_int8``).
    ``fused_norm``: the norms through K2 forward and K3 backward (ReLU pad 0,
    then no ReLU), the JAX ``Generator(fused_norm=True)``."""
    if fused_norm:
        norm = lambda t, relu: k2.instance_norm_fused(t, relu)
    else:
        norm = lambda t, relu: _in_relu(t) if relu else instance_norm(t)
    for i, (c1, b1, c2, b2, *gates) in enumerate(blocks):
        if int8:
            conv = lambda t, j, b: conv_int8_dynamic(t, int8[j][0][i],
                                                     int8[j][1][i], b)
        else:
            conv = lambda t, j, b: _conv(t, (c1, c2)[j], b)
        t = conv(reflect_pad(h, 1), 0, b1)
        t = norm(conv(reflect_pad(norm(t, True), 1), 1, b2), False)
        h = h + (cbam_plain(t, *gates) if gates else t)
    return h


def trunk_pallas(hp, blocks, int8=None):
    """conv1 -> K2 (ReLU, pad 1) or, with ``int8`` (conv2's (wq, ws)
    stacks), its int8 write -> conv2 -> K4 on the padded carry, the last
    block without its pad (fused.py:670-698). ``blocks``: per block (conv1
    OIHW, its bias, conv2 OIHW, its bias, fc1 (C, R), fc2 (R, C), wsa
    HWIO)."""
    r = len(blocks)
    for i, (c1, b1, c2, b2, w1, w2, wsa) in enumerate(blocks):
        t = _conv(hp, c1, b1)
        if int8:
            t8 = k2.instance_norm_int8(t.contiguous(), pad=1)
            t = conv_int8_static(t8, int8[0][i], int8[1][i], b2,
                                 INT8_NORM_SCALE, dtype=hp.dtype,
                                 zero_point=INT8_ZERO_POINT)
        else:
            t = _conv(k2.instance_norm_fused(t, relu=True, pad=1), c2, b2)
        hp = k4.block_tail_fused(t, hp, w1, w2, wsa,
                                 pad=0 if i == r - 1 else 1, x_pad=1)
    return hp


def trunk_mega(hp, stacks, int8=None):
    """K7 then K8 a block on the padded carry with one scratch; with
    ``int8`` (conv2's (wq, ws) stacks) K7 writes int8 and K8's taps are
    int8 (fused.py:654-669). ``stacks``: (was, wbs, w1s, w2s, wsas) in the
    kernels' JAX layouts."""
    was, wbs, w1s, w2s, wsas = stacks
    r = was.shape[0]
    ws = [None] * r
    if int8:
        wbs, ws = int8
    n, hh, ww, c = hp.shape
    # per route: no fp32 accumulator where K7 and K8 run resident
    scratch = k7.make_scratch(n, hh - 2, ww - 2, c, hp.device, hp.dtype) \
        if hp.device.type == "cuda" else None
    scale = INT8_NORM_SCALE if int8 else None
    for i in range(r):
        t = k7.conv3x3_in(hp, was[i], pad=1, scratch=scratch,
                          int8_scale=scale)
        hp = k7.conv_block_tail(t, hp, wbs[i], w1s[i], w2s[i], wsas[i],
                                pad=0 if i == r - 1 else 1, x_pad=1,
                                in_int8=bool(int8), w_scale=ws[i],
                                scratch=scratch)
    return hp


def trunk_chain(hp, stacks, k: int, int8=None):
    """K1 (K1q with ``int8``, conv2's (wq, ws) stacks) on groups of k
    blocks of the padded carry, the last group without its pad
    (fused.py:624-639)."""
    r = stacks[0].shape[0]
    for lo in range(0, r, k):
        hi = min(lo + k, r)
        was, wbs, w1s, w2s, wsas = (t[lo:hi] for t in stacks)
        kw = {}
        if int8:
            wbs, kw = int8[0][lo:hi], dict(quant=True,
                                           wb_scales=int8[1][lo:hi])
        hp = k1.residual_chain(hp, was, wbs, w1s, w2s, wsas,
                               pad=0 if hi == r else 1, **kw)
    return hp


def resolve_trunk(trunk: str, blocks: int, device) -> tuple[str, int]:
    """(kind, k) of a packed trunk name: "auto" by the device ("pallas" on
    a card, "xla" on the CPU); "chain{k}" with 1 <= k <= blocks ("chain" is
    chain1); "mono" is chain1 on K1 (K6)."""
    if trunk == "auto":
        trunk = "pallas" if torch.device(device).type == "cuda" else "xla"
    if isinstance(trunk, str) and trunk.startswith("chain"):
        k = int(trunk[5:] or 1)
        if not 1 <= k <= blocks:
            raise ValueError(f"chain length out of range: {trunk!r}")
        return "chain", k
    if trunk not in ("xla", "pallas", "mega", "mono"):
        raise ValueError(
            f"trunk must be auto/xla/pallas/mega/mono/chain{{k}}: {trunk!r}")
    return trunk, 1


# ------------------------------------------------------------ the forwards
def generator_apply_packed(params, x: torch.Tensor, *,
                           num_residual_blocks: int | None = None,
                           use_cbam: bool | None = None, dtype=None,
                           trunk: str = "auto", encoder_fused: bool = True,
                           trunk_int8: bool = False,
                           quant: str | None = None) -> torch.Tensor:
    """The generator forward in packed layout outside the trunk
    (fused.py:476-750): NHWC (N, H, W, in_ch) -> (N, H, W, 1) fp32 tanh, H
    and W divisible by 4. ``params`` is a ``Generator`` (its parameters,
    differentiably), its state dict, or ``PackedWeights`` (laid out once);
    depth and CBAM come from it, and ``num_residual_blocks`` / ``use_cbam``,
    the JAX signature's, must agree when given. ``dtype`` defaults to a
    module's compute dtype (else fp32) or the layout's own; the convs
    compute in it (a layout in another dtype is cast, ``cast_packed``)."""
    if quant is None and trunk_int8:
        quant = "trunk"
    check_quant(quant)
    if isinstance(params, PackedWeights):
        pw = cast_packed(params, dtype or params.dtype)
    else:
        pw = lay_out(params, quant=quant, dtype=dtype or getattr(
            params, "compute_dtype", None) or torch.float32)
    if pw.quant != quant and quant is not None:
        raise ValueError(f"weights laid out for quant={pw.quant!r}, called "
                         f"with quant={quant!r}")
    for name, want, got in (("num_residual_blocks", num_residual_blocks,
                             pw.blocks), ("use_cbam", use_cbam,
                                          pw.use_cbam)):
        if want is not None and want != got:
            raise ValueError(f"{name}={want} but the parameters have {got}")
    kind, chain_k = resolve_trunk(trunk, pw.blocks, x.device)
    trunk_int8, full = quant in ("trunk", "full"), quant == "full"
    dt, r = pw.dtype, pw.blocks
    if x.shape[1] % 4 or x.shape[2] % 4:
        raise ValueError(f"packed forward: H, W {tuple(x.shape[1:3])} must "
                         "divide by 4")
    kernel_trunk = kind != "xla" and pw.use_cbam
    enc_fused = kernel_trunk and encoder_fused

    def phase_norm(t, groups):
        if enc_fused:
            return k2.instance_norm(t.contiguous(), relu=True, phases=groups)
        return packed_in_relu(t, groups)

    # ---- encoder (packed-4 until down1 consumes it)
    x = x.to(dt)
    xp = reflect_pad(x, 3)
    if xp.shape[1] % 2:
        xp = F.pad(xp, (0, 0, 0, 1, 0, 1))
    s = _s2d2(xp)
    h_out = (x.shape[1] + 6 - 7 + 1) // 2
    if full:
        h = conv_int8_static(quantize_static(s, 1.0), *pw.int8["stem"], None,
                             1.0, dtype=dt)
        h = h[:, :h_out, :h_out] + pw.biases["stem"].to(dt)
        h8 = F.pad(packed_in_relu_int8(h, 4), (0, 0, 1, 0, 1, 0),
                   value=-INT8_ZERO_POINT)
        h = conv_int8_static(h8, *pw.int8["d1"], pw.biases["d1"],
                             INT8_NORM_SCALE, dtype=dt,
                             zero_point=INT8_ZERO_POINT)
        h8 = F.pad(packed_in_relu_int8(h, 1), (0, 0, 1, 1, 1, 1),
                   value=-INT8_ZERO_POINT)
        h = conv_int8_static(h8, *pw.int8["d2"], pw.biases["d2"],
                             INT8_NORM_SCALE, stride=2, dtype=dt,
                             zero_point=INT8_ZERO_POINT)
    else:
        h = _conv(s, pw.convs["stem"], pw.biases["stem"])[:, :h_out, :h_out]
        h = phase_norm(h, 4)                           # true H x W x base
        h = _conv(F.pad(h, (0, 0, 1, 0, 1, 0)), pw.convs["d1"],
                  pw.biases["d1"])
        h = k2.instance_norm(h.contiguous(), relu=True) if enc_fused \
            else _in_relu(h)                           # H/2 x 2 base
        h = _conv(h, pw.convs["d2"], pw.biases["d2"], stride=2, padding=1)

    # ---- trunk
    if kernel_trunk:
        hp = k2.instance_norm(h.contiguous(), relu=True, pad=1) if enc_fused \
            else reflect_pad(_in_relu(h), 1)
        int8 = pw.int8["c2"] if trunk_int8 else None
        if kind == "pallas":
            h = trunk_pallas(hp, [
                (pw.convs[f"c1_{i}"], pw.biases[f"c1_{i}"],
                 pw.convs[f"c2_{i}"], pw.biases[f"c2_{i}"],
                 *(t[i] for t in pw.trunk[2:])) for i in range(r)], int8)
        elif kind == "mega":
            h = trunk_mega(hp, pw.trunk, int8)
        else:
            h = trunk_chain(hp, pw.trunk, chain_k, int8)
    else:
        h = trunk_plain(_in_relu(h), [
            (pw.convs[f"c1_{i}"], pw.biases[f"c1_{i}"], pw.convs[f"c2_{i}"],
             pw.biases[f"c2_{i}"], *(t[i] for t in pw.trunk[2:]))
            for i in range(r)],
            int8=(pw.int8["c1"], pw.int8["c2"]) if trunk_int8 else None)

    # ---- decoder: packed-4 -> packed-16, no d2s until the very end
    h = _conv(F.pad(h, (0, 0, 1, 1, 1, 1)), pw.convs["u1"], pw.biases["u1"])
    if full:
        h8 = F.pad(packed_in_relu_int8(h, 4), (0, 0, 1, 1, 1, 1),
                   value=-INT8_ZERO_POINT)
        h = conv_int8_static(h8, *pw.int8["u2"], None, INT8_NORM_SCALE,
                             dtype=dt, zero_point=INT8_ZERO_POINT)
        h = h + pw.biases["u2"].to(dt)
        h8 = packed16_reflect_pad3(packed_in_relu_int8(h, 16), pw.channels,
                                   fill=-INT8_ZERO_POINT)
        h = conv_int8_static(h8, *pw.int8["hd"], None, INT8_NORM_SCALE,
                             dtype=torch.float32, zero_point=INT8_ZERO_POINT)
        h = h + pw.biases["hd"]
    else:
        h = phase_norm(h, 4)                           # packed-4 of H/2
        h = _conv(F.pad(h, (0, 0, 1, 1, 1, 1)), pw.convs["u2"],
                  pw.biases["u2"])
        h = phase_norm(h, 16)                          # packed-16 of H
        h = _conv(packed16_reflect_pad3(h, pw.channels), pw.convs["hd"],
                  pw.biases["hd"])
    return _d2s(torch.tanh(h.to(torch.float32)), 4)


def generator_apply_fused(params, x: torch.Tensor, *,
                          num_residual_blocks: int | None = None,
                          use_cbam: bool | None = None, dtype=None,
                          use_pallas: bool = True) -> torch.Tensor:
    """The true-layout reorganized forward (fused.py:279-328): the s2d stem,
    plain encoder norms and stride-2 convs, the trunk with K2 (ReLU, pad 1)
    between the convs when ``use_pallas`` (else the plain norm and pad), K4
    after them with CBAM (their plain versions on a CPU tensor), the
    sub-pixel up-convs, the head."""
    sd = _param_dict(params)
    r, cbam = state_dict_blocks(sd), state_dict_has_cbam(sd)
    for name, want, got in (("num_residual_blocks", num_residual_blocks, r),
                            ("use_cbam", use_cbam, cbam)):
        if want is not None and want != got:
            raise ValueError(f"{name}={want} but the parameters have {got}")
    dt = dtype or getattr(params, "compute_dtype", None) or torch.float32
    f32 = lambda key: sd[key].to(torch.float32)
    hwio = lambda key: f32(key).permute(2, 3, 1, 0)
    conv = lambda t, key, **kw: _conv(t, _oihw(hwio(f"{key}.weight"), dt),
                                      f32(f"{key}.bias"), **kw)
    h = stem_s2d(x, hwio("model.1.weight"), f32("model.1.bias"), ref_pad=3,
                 dtype=dt)
    h = _in_relu(h)
    h = _in_relu(conv(h, "model.4", stride=2, padding=1))
    h = _in_relu(conv(h, "model.7", stride=2, padding=1))
    for i in range(r):
        b = f"model.{10 + i}"
        t = conv(reflect_pad(h, 1), f"{b}.block.1")
        t = k2.instance_norm_fused(t, relu=True, pad=1) if use_pallas \
            else reflect_pad(_in_relu(t), 1)
        t = conv(t, f"{b}.block.5")
        if cbam:
            ca = f"{b}.cbam.channel_attention.fc"
            w1 = f32(f"{ca}.0.weight")[:, :, 0, 0].T
            w2 = f32(f"{ca}.2.weight")[:, :, 0, 0].T
            wsa = hwio(f"{b}.cbam.spatial_attention.conv.weight")
            h = k4.block_tail_fused(t, h, w1, w2, wsa)
        else:
            h = h + instance_norm(t)
    for idx in (11 + r, 15 + r):
        h = upsample_conv_subpixel(h, hwio(f"model.{idx}.weight"),
                                   f32(f"model.{idx}.bias"), dtype=dt)
        h = _in_relu(h)
    h = conv(reflect_pad(h, 3), f"model.{19 + r}")
    return torch.tanh(h.to(torch.float32))


class PackedGenerator:
    """One generator's packed forward for serving: the weights laid out once
    on the device in the compute dtype (int8 ones quantized from the fp32
    values), called like the module: (N, H, W, in_ch) -> (N, H, W, 1)."""

    def __init__(self, sd, *, dtype, device, trunk: str = "auto",
                 quant: str | None = None):
        with torch.no_grad():
            pw = packed_weights(sd, dtype=dtype, quant=quant,
                                memory_format=torch.channels_last)
            move = lambda t: t.to(device)
            self.weights = pw._replace(
                convs={k: move(v) for k, v in pw.convs.items()},
                biases={k: move(v) for k, v in pw.biases.items()},
                trunk=tuple(move(t) for t in pw.trunk),
                int8={k: tuple(move(t) for t in v)
                      for k, v in pw.int8.items()})
        self.trunk, self.quant = trunk, quant
        self.num_residual_blocks = pw.blocks
        self.use_cbam = pw.use_cbam
        resolve_trunk(trunk, pw.blocks, device)    # refuse a bad name now

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return generator_apply_packed(self.weights, x, trunk=self.trunk,
                                      quant=self.quant)
