"""PatchGAN discriminator (ducosy_tpu/models/discriminator.py:17-40).

Four 4x4 stride-2 convs (zero pad 1), channels base -> 2 base -> 4 base ->
8 base, InstanceNorm on all but the first, LeakyReLU(0.2); then
ZeroPad2d((1, 0, 1, 0)) and a 4x4 conv (pad 1) to a 1-channel logit map,
i.e. one asymmetric padding of 2 on the top/left and 1 on the bottom/right.
A 512x512 input gives a 32x32 patch map.

The module tree is the reference ``nn.Sequential`` (modules/model.py:
118-131), so ``state_dict()`` has its key layout (``model.{0,2,5,8,12}``,
models/torch_import.py:158). The forward is written out on NHWC tensors
with fp32 InstanceNorm statistics, like the generator's; it is plain
PyTorch and cuDNN, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ducosy_tpu_torch.models.layers import conv2d, instance_norm, leaky_relu

CONV_IDX = (0, 2, 5, 8)   # the four stride-2 convs in the Sequential
HEAD_IDX = 12


class Discriminator(nn.Module):
    """NHWC (N, H, W, in_ch) image -> (N, H/16, W/16, 1) fp32 logits."""

    def __init__(self, input_channels: int = 1, base_channels: int = 64,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        b = base_channels
        layers = [nn.Conv2d(input_channels, b, 4, stride=2, padding=1),
                  nn.LeakyReLU(0.2)]
        for cin, cout in ((b, 2 * b), (2 * b, 4 * b), (4 * b, 8 * b)):
            layers += [nn.Conv2d(cin, cout, 4, stride=2, padding=1),
                       nn.InstanceNorm2d(cout), nn.LeakyReLU(0.2)]
        layers += [nn.ZeroPad2d((1, 0, 1, 0)), nn.Conv2d(8 * b, 1, 4, padding=1)]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.model
        dt = self.compute_dtype or m[0].weight.dtype
        conv = lambda h, mod, **kw: conv2d(h, mod.weight.to(dt),
                                           mod.bias.to(dt), **kw)
        h = leaky_relu(conv(x.to(dt), m[0], stride=2, padding=1))
        for idx in CONV_IDX[1:]:
            h = leaky_relu(instance_norm(conv(h, m[idx], stride=2, padding=1)))
        # ZeroPad2d((1, 0, 1, 0)) + the head's pad 1: (2, 1) on H and W
        h = F.pad(h, (0, 0, 2, 1, 2, 1))
        return conv(h, m[HEAD_IDX]).to(torch.float32)
