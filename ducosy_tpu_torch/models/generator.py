"""ResNet-9 + CBAM generator (ducosy_tpu/models/generator.py:42-161).

The module tree reproduces the reference ``nn.Sequential``
(modules/model.py:94-113), so ``state_dict()`` has the released ``.pth``
key layout (``model.N.*``, see models/convert.py) and a released
checkpoint loads with ``load_state_dict``. The forward is written out
rather than run through the Sequential: it takes and returns NHWC, keeps
InstanceNorm statistics in fp32 under bf16, and routes the serving path's
two TPU-kernel sites to the hand-written kernels:

  trunk="chain"  down1 norm -> K2; down2 norm + the trunk's first reflect
                 pad -> K2 (pad 1); the residual trunk -> K1 in groups of
                 3 blocks (one block per call below 3 blocks), the last
                 group without a trailing pad — the JAX serving engine's
                 "chain3" placement (models/fused.py:603-639,
                 infer/engine.py:200-206). Stem, up1, up2 and head stay
                 plain convs and norms, as the JAX package left them to XLA.
  trunk="mega"   the encoder norms as under "chain"; each residual block is
                 two kernels, K7 (conv1 + IN + ReLU + pad 1) then K8 (conv2 +
                 IN + CBAM + skip + pad 1, pad 0 on the last block), with one
                 scratch for the whole trunk: the JAX packed forward's
                 trunk="mega" (models/fused.py:616-623, :654-669). Serving
                 only, as "chain".
  trunk="tail"   the training trunk, the JAX trunk="pallas" placement with
                 encoder_fused off (models/fused.py:615-623, :688-698):
                 down2's norm is plain with a standalone reflect pad; each
                 block runs conv1 (with bias), the differentiable K2/K3 norm
                 (ReLU, pad 1), conv2 (with bias) and the differentiable
                 K4/K5 tail on the padded carry (x_pad 1, pad 1, pad 0 on
                 the last block).
  trunk="plain"  no kernel wrapper anywhere: the reference module math
                 with every conv bias, in plain PyTorch.

``quant`` (inference only) is quantized serving on this true layout, the
JAX packed forward's ``quant`` modes (models/fused.py:510-519) without its
space-to-depth packing:
  "trunk"  each block's conv2 runs int8 x int8 on its shifted-grid int8
           input: K1q under trunk="chain" (the JAX engine's chain3); K7's
           int8 write and K8's int8 taps under trunk="mega"; under
           trunk="tail" conv1 (with bias), K2's int8 write (pad 1), the
           int8 conv2 (with bias, zero point 128) and K4, as the JAX
           trunk="pallas" under quant (fused.py:670-698); under
           trunk="plain" the plain versions of the chain's math with biases.
  "full"   also the stem (symmetric grid at scale 1.0), down1, down2, up2
           (four sub-pixel phase convs, weights quantized per phase and
           output channel) and the head at static scales, with -128 pads
           on the shifted grid (fused.py:529-534, 587-601, 725-738). up1
           stays in the compute dtype; the down2 norm + pad stays K2.
The int8 weights and their fp32 scales are quantized once, from the
parameters as loaded (the fp32 master weights), by ``quantize_weights``;
they follow the module's device and never its dtype.

Parameters keep their dtype (fp32 in training) and the forward computes in
``compute_dtype`` (bf16 on the card), as Flax ``dtype=bf16`` does with
fp32 params; by default the compute dtype is the parameters' dtype.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ducosy_tpu_torch.models.layers import (
    conv2d,
    instance_norm,
    reflect_pad,
    upsample_nearest_2x,
)
from ducosy_tpu_torch.ops.kernels import block_tail as k4
from ducosy_tpu_torch.ops.kernels import conv_in as k7
from ducosy_tpu_torch.ops.kernels import instance_norm as k2
from ducosy_tpu_torch.ops.kernels import residual_chain as k1
from ducosy_tpu_torch.ops.quant import (
    INT8_NORM_SCALE,
    INT8_ZERO_POINT,
    check_quant,
    conv_int8_static,
    in_relu_int8,
    pad_shifted,
    quantize_static,
    quantize_weights_int8,
    subpixel_weights,
    upsample_conv_int8,
)

CHAIN_K = 3  # residual blocks per K1 call on the serving path
TRUNKS = ("chain", "mega", "tail", "plain")


class _ChannelAttention(nn.Module):
    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(nn.Conv2d(c, c // reduction, 1, bias=False),
                                nn.ReLU(),
                                nn.Conv2d(c // reduction, c, 1, bias=False))


class _SpatialAttention(nn.Module):
    def __init__(self, k: int = 7):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, k, padding=k // 2, bias=False)


class _CBAM(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.channel_attention = _ChannelAttention(c)
        self.spatial_attention = _SpatialAttention()


class ResidualBlock(nn.Module):
    """Parameter holder with the reference block's key layout
    (``block.1``/``block.5`` convs, ``cbam.*``)."""

    def __init__(self, c: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(c, c, 3), nn.InstanceNorm2d(c),
            nn.ReLU(), nn.ReflectionPad2d(1), nn.Conv2d(c, c, 3),
            nn.InstanceNorm2d(c))
        self.cbam = _CBAM(c)


class Generator(nn.Module):
    """NCCT -> CECT slice translator: NHWC (N, H, W, in_ch) in [-1, 1] ->
    (N, H, W, 1) fp32 tanh output. ``compute_dtype`` None computes in the
    parameters' dtype (``.to(torch.bfloat16)`` for bf16 serving)."""

    def __init__(self, input_channels: int = 1, num_residual_blocks: int = 9,
                 base_channels: int = 64, trunk: str = "chain",
                 compute_dtype: torch.dtype | None = None,
                 quant: str | None = None):
        super().__init__()
        if trunk not in TRUNKS:
            raise ValueError(f"trunk must be one of {TRUNKS}: {trunk!r}")
        self.trunk = trunk
        self.quant = check_quant(quant)
        self.qweights: Dict[str, tuple] = {}
        self.compute_dtype = compute_dtype
        self.num_residual_blocks = r = num_residual_blocks
        b, c = base_channels, 4 * base_channels
        self.model = nn.Sequential(
            nn.ReflectionPad2d(3), nn.Conv2d(input_channels, b, 7),
            nn.InstanceNorm2d(b), nn.ReLU(),
            nn.Conv2d(b, 2 * b, 3, stride=2, padding=1),
            nn.InstanceNorm2d(2 * b), nn.ReLU(),
            nn.Conv2d(2 * b, c, 3, stride=2, padding=1),
            nn.InstanceNorm2d(c), nn.ReLU(),
            *[ResidualBlock(c) for _ in range(r)],
            nn.Upsample(scale_factor=2), nn.Conv2d(c, 2 * b, 3, padding=1),
            nn.InstanceNorm2d(2 * b), nn.ReLU(),
            nn.Upsample(scale_factor=2), nn.Conv2d(2 * b, b, 3, padding=1),
            nn.InstanceNorm2d(b), nn.ReLU(),
            nn.ReflectionPad2d(3), nn.Conv2d(b, 1, 7), nn.Tanh())

    @classmethod
    def from_state_dict(cls, sd: Dict[str, torch.Tensor], trunk: str = "chain",
                        compute_dtype: torch.dtype | None = None,
                        quant: str | None = None):
        """Build a generator shaped like ``sd`` (reference key layout) and
        load it strictly. Depth and width come from the state dict itself;
        values may be tensors or numpy arrays. With ``quant``, the int8
        weights are quantized from the loaded values."""
        sd = {k: v if isinstance(v, torch.Tensor) else
              torch.from_numpy(np.array(v)) for k, v in sd.items()}
        stem = sd["model.1.weight"]
        r = len({k.split(".")[1] for k in sd if ".block.1.weight" in k})
        if r and not any(".cbam." in k for k in sd):
            raise NotImplementedError(
                "residual blocks without CBAM are not ported (ROADMAP.md "
                "Queue 1, item 2); the released checkpoints all use CBAM")
        gen = cls(int(stem.shape[1]), r, int(stem.shape[0]), trunk,
                  compute_dtype, quant)
        gen.load_state_dict(sd)
        if quant:
            gen.quantize_weights()
        return gen

    def quantize_weights(self) -> None:
        """Quantize the int8 weights of ``self.quant`` from the parameters
        as they are now (call it before casting the module to bf16):
        symmetric per-output-channel int8 of the HWIO kernels (the up2
        kernel as its sub-pixel phase kernels), with fp32 scales."""
        m, r = self.model, self.num_residual_blocks
        hwio = lambda mod: mod.weight.detach().permute(2, 3, 1, 0)
        q = {"conv2": [quantize_weights_int8(hwio(m[10 + i].block[5]))
                       for i in range(r)]}
        q["conv2"] = tuple(torch.stack(t) for t in zip(*q["conv2"]))
        if self.quant == "full":
            for name, i in (("stem", 1), ("down1", 4), ("down2", 7),
                            ("head", 19 + r)):
                q[name] = quantize_weights_int8(hwio(m[i]))
            q["up2"] = quantize_weights_int8(subpixel_weights(hwio(m[15 + r])))
        self.qweights = q

    def _apply(self, fn, recurse=True):
        # .to()/.cuda() move the int8 weights and their fp32 scales with the
        # parameters; a dtype cast (.to(bf16)) must not round the scales
        super()._apply(fn, recurse)
        dev = self.model[1].weight.device
        self.qweights = {k: tuple(t.to(dev) for t in v)
                         for k, v in self.qweights.items()}
        return self

    def _trunk_weights(self, lo: int, hi: int):
        """JAX-layout stacks for blocks lo..hi-1: conv HWIO (k,3,3,C,C) x2,
        fc1 (k,C,R), fc2 (k,R,C), spatial (k,7,7,2,1), conv biases (k,C) x2."""
        blocks = [self.model[10 + i] for i in range(lo, hi)]
        hwio = lambda w: w.permute(2, 3, 1, 0)

        def stack(fn):
            return torch.stack([fn(b) for b in blocks])

        return (stack(lambda b: hwio(b.block[1].weight)),
                stack(lambda b: hwio(b.block[5].weight)),
                stack(lambda b: b.cbam.channel_attention.fc[0].weight[:, :, 0, 0].T),
                stack(lambda b: b.cbam.channel_attention.fc[2].weight[:, :, 0, 0].T),
                stack(lambda b: hwio(b.cbam.spatial_attention.conv.weight)),
                stack(lambda b: b.block[1].bias),
                stack(lambda b: b.block[5].bias))

    def _trunk_tail(self, hp: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """The training trunk on the reflect-padded carry hp; under quant,
        K2's int8 write feeds an int8 conv2."""
        r = self.num_residual_blocks
        for i in range(r):
            blk = self.model[10 + i]
            c1, c2 = blk.block[1], blk.block[5]
            fc = blk.cbam.channel_attention.fc
            t = conv2d(hp, c1.weight.to(dt), c1.bias.to(dt))
            if self.quant:
                wq, ws = self.qweights["conv2"]
                t8 = k2.instance_norm_int8(t.contiguous(), pad=1)
                t = conv_int8_static(t8, wq[i], ws[i], c2.bias,
                                     INT8_NORM_SCALE, dtype=dt,
                                     zero_point=INT8_ZERO_POINT)
            else:
                t = k2.instance_norm_fused(t, relu=True, pad=1)
                t = conv2d(t, c2.weight.to(dt), c2.bias.to(dt))
            hp = k4.block_tail_fused(
                t, hp, fc[0].weight[:, :, 0, 0].T, fc[2].weight[:, :, 0, 0].T,
                blk.cbam.spatial_attention.conv.weight.permute(2, 3, 1, 0),
                pad=0 if i == r - 1 else 1, x_pad=1)
        return hp

    def _trunk_mega(self, hp: torch.Tensor) -> torch.Tensor:
        """K7 then K8 per block on the reflect-padded carry hp; under quant,
        K7 writes int8 and K8's taps run on the build-time int8 conv2."""
        r, quant = self.num_residual_blocks, bool(self.quant)
        was, wbs, w1s, w2s, wsas = self._trunk_weights(0, r)[:5]
        ws = [None] * r
        if quant:
            wbs, ws = self.qweights["conv2"]
        n, hh, ww, c = hp.shape
        scratch = k7.make_scratch(n, hh - 2, ww - 2, c, hp.device) \
            if hp.device.type == "cuda" else None
        for i in range(r):
            t = k7.conv3x3_in(hp, was[i], pad=1, scratch=scratch,
                              int8_scale=INT8_NORM_SCALE if quant else None)
            hp = k7.conv_block_tail(t, hp, wbs[i], w1s[i], w2s[i], wsas[i],
                                    pad=0 if i == r - 1 else 1, x_pad=1,
                                    in_int8=quant, w_scale=ws[i],
                                    scratch=scratch)
        return hp

    def _conv8(self, name: str, x8: torch.Tensor, act_scale: float, bias,
               dt: torch.dtype, **kw) -> torch.Tensor:
        return conv_int8_static(x8, *self.qweights[name], bias, act_scale,
                                dtype=dt, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m, r = self.model, self.num_residual_blocks
        chain, mega, quant = self.trunk == "chain", self.trunk == "mega", \
            self.quant
        full = quant == "full"
        if (chain or mega or quant) and torch.is_grad_enabled() \
                and m[1].weight.requires_grad:
            raise RuntimeError("trunk='chain', trunk='mega' and the quant "
                               "modes have no backward (serving only): train "
                               "with trunk='tail' or 'plain' and quant=None")
        if quant and not self.qweights:
            raise RuntimeError("quant is set but quantize_weights() was not "
                               "called (Generator.from_state_dict calls it)")
        dt = self.compute_dtype or m[1].weight.dtype
        conv = lambda h, mod, **kw: conv2d(h, mod.weight.to(dt),
                                           mod.bias.to(dt), **kw)
        h = reflect_pad(x.to(dt), 3)
        if full:
            h = self._conv8("stem", quantize_static(h, 1.0), 1.0, None, dt) \
                + m[1].bias.to(dt)
            # the stem and down1 norms write the shifted grid; -128 pads
            for name, i in (("down1", 4), ("down2", 7)):
                h = self._conv8(name, pad_shifted(in_relu_int8(h), 1),
                                INT8_NORM_SCALE, m[i].bias, dt, stride=2,
                                zero_point=INT8_ZERO_POINT)
        else:
            h = conv(h, m[1])
            h = torch.relu(instance_norm(h))
            h = conv(h, m[4], stride=2, padding=1)
            if chain or mega:
                h = k2.instance_norm(h.contiguous(), relu=True, pad=0)
            else:
                h = torch.relu(instance_norm(h))
            h = conv(h, m[7], stride=2, padding=1)
        if chain or mega:
            # the down2 norm also writes the trunk's first reflect pad
            h = k2.instance_norm(h.contiguous(), relu=True, pad=1)
        if mega:
            h = self._trunk_mega(h)
        elif chain:
            step = CHAIN_K if r >= CHAIN_K else 1
            for lo in range(0, r, step):
                hi = min(lo + step, r)
                was, wbs, w1s, w2s, wsas = self._trunk_weights(lo, hi)[:5]
                qkw = {}
                if quant:
                    wq, ws = self.qweights["conv2"]
                    wbs, qkw = wq[lo:hi], dict(quant=True,
                                               wb_scales=ws[lo:hi])
                h = k1.residual_chain(h, was, wbs, w1s, w2s, wsas,
                                      pad=0 if hi == r else 1, **qkw)
        else:
            h = reflect_pad(torch.relu(instance_norm(h)), 1)
            if self.trunk == "tail":
                h = self._trunk_tail(h, dt)
            else:
                was, wbs, w1s, w2s, wsas, b1s, b2s = self._trunk_weights(0, r)
                qkw = {}
                if quant:
                    wbs, ws = self.qweights["conv2"]
                    qkw = dict(quant=True, wb_scales=ws)
                h = k1.residual_chain_plain(h, was, wbs, w1s, w2s, wsas,
                                            pad=0, b1s=b1s, b2s=b2s, **qkw)
        ui, u2, hd = 11 + r, 15 + r, 19 + r
        h = conv(upsample_nearest_2x(h), m[ui], padding=1)
        if full:
            h = upsample_conv_int8(in_relu_int8(h), *self.qweights["up2"],
                                   INT8_NORM_SCALE, dtype=dt) \
                + m[u2].bias.to(dt)
            h = self._conv8("head", in_relu_int8(h, pad=3), INT8_NORM_SCALE,
                            m[hd].bias, torch.float32,
                            zero_point=INT8_ZERO_POINT)
            return torch.tanh(h)
        h = torch.relu(instance_norm(h))
        h = conv(upsample_nearest_2x(h), m[u2], padding=1)
        h = torch.relu(instance_norm(h))
        h = conv(reflect_pad(h, 3), m[hd])
        return torch.tanh(h.to(torch.float32))
