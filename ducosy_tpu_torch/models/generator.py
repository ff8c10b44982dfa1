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
  trunk="plain"  no kernel wrapper anywhere: the reference module math
                 with every conv bias, in plain PyTorch.
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
from ducosy_tpu_torch.ops.kernels import instance_norm as k2
from ducosy_tpu_torch.ops.kernels import residual_chain as k1

CHAIN_K = 3  # residual blocks per K1 call on the serving path
TRUNKS = ("chain", "plain")


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
    (N, H, W, 1) fp32 tanh output. Compute dtype = the parameters' dtype
    (``.to(torch.bfloat16)`` for bf16 serving)."""

    def __init__(self, input_channels: int = 1, num_residual_blocks: int = 9,
                 base_channels: int = 64, trunk: str = "chain"):
        super().__init__()
        if trunk not in TRUNKS:
            raise ValueError(f"trunk must be one of {TRUNKS}: {trunk!r}")
        self.trunk = trunk
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
    def from_state_dict(cls, sd: Dict[str, torch.Tensor], trunk: str = "chain"):
        """Build a generator shaped like ``sd`` (reference key layout) and
        load it strictly. Depth and width come from the state dict itself;
        values may be tensors or numpy arrays."""
        sd = {k: v if isinstance(v, torch.Tensor) else
              torch.from_numpy(np.array(v)) for k, v in sd.items()}
        stem = sd["model.1.weight"]
        r = len({k.split(".")[1] for k in sd if ".block.1.weight" in k})
        if r and not any(".cbam." in k for k in sd):
            raise NotImplementedError(
                "residual blocks without CBAM are not ported (ROADMAP.md "
                "Queue 1, item 2); the released checkpoints all use CBAM")
        gen = cls(int(stem.shape[1]), r, int(stem.shape[0]), trunk)
        gen.load_state_dict(sd)
        return gen

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m, r = self.model, self.num_residual_blocks
        chain = self.trunk == "chain"
        h = x.to(m[1].weight.dtype)
        h = conv2d(reflect_pad(h, 3), m[1].weight, m[1].bias)
        h = torch.relu(instance_norm(h))
        h = conv2d(h, m[4].weight, m[4].bias, stride=2, padding=1)
        if chain:
            h = k2.instance_norm(h.contiguous(), relu=True, pad=0)
        else:
            h = torch.relu(instance_norm(h))
        h = conv2d(h, m[7].weight, m[7].bias, stride=2, padding=1)
        if chain:
            # the down2 norm also writes the trunk's first reflect pad
            h = k2.instance_norm(h.contiguous(), relu=True, pad=1)
            step = CHAIN_K if r >= CHAIN_K else 1
            for lo in range(0, r, step):
                hi = min(lo + step, r)
                h = k1.residual_chain(h, *self._trunk_weights(lo, hi)[:5],
                                      pad=0 if hi == r else 1)
        else:
            h = reflect_pad(torch.relu(instance_norm(h)), 1)
            was, wbs, w1s, w2s, wsas, b1s, b2s = self._trunk_weights(0, r)
            h = k1.residual_chain_plain(h, was, wbs, w1s, w2s, wsas, pad=0,
                                        b1s=b1s, b2s=b2s)
        ui, u2, hd = 11 + r, 15 + r, 19 + r
        h = conv2d(upsample_nearest_2x(h), m[ui].weight, m[ui].bias, padding=1)
        h = torch.relu(instance_norm(h))
        h = conv2d(upsample_nearest_2x(h), m[u2].weight, m[u2].bias, padding=1)
        h = torch.relu(instance_norm(h))
        h = conv2d(reflect_pad(h, 3), m[hd].weight, m[hd].bias)
        return torch.tanh(h.to(torch.float32))
