"""Plain float32 PyTorch forwards of the DuCoSy-GAN networks
(qqaazz0222/DuCoSy-GAN, modules/model.py), on parameter dicts in the
reference's own state-dict layout (``model.N.*``).

NCHW, every conv through ``conv`` (``F.conv2d`` unless a caller passes
another, such as the lower-precision control), InstanceNorm without affine
at eps 1e-5 with the biased variance, as ``nn.InstanceNorm2d``. No kernel,
no cache, no batching trick: the yardstick that decides ``correct``. It
imports nothing of the program.

Generator (ResNet-9 + CBAM): ReflectionPad(3) + 7x7 conv -> IN -> ReLU;
two stride-2 3x3 convs (zero pad 1) -> IN -> ReLU; residual blocks
x + CBAM(IN(conv(pad(ReLU(IN(conv(pad(x)))))))); two nearest x2 upsamples
+ 3x3 conv (pad 1) -> IN -> ReLU; ReflectionPad(3) + 7x7 conv -> tanh.
CBAM: the channel gate sigmoid(MLP(avg) + MLP(max)) with the 1x1-conv MLP
C -> C/16 -> C, then the spatial gate sigmoid(7x7 conv([mean_c, max_c]))
(modules/model.py:6-52).

PatchGAN: 4x4 stride-2 convs (pad 1) base -> 2 base -> 4 base -> 8 base,
IN on all but the first, LeakyReLU(0.2); ZeroPad2d((1, 0, 1, 0)) and a 4x4
conv (pad 1) to one channel (modules/model.py:118-131).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS)


def _conv(p, key, x, conv, **kw):
    return conv(x, p[f"{key}.weight"], p.get(f"{key}.bias"), **kw)


def _cbam(p, base: str, y, conv):
    ca = f"{base}.cbam.channel_attention.fc"

    def mlp(v):
        return conv(F.relu(conv(v, p[f"{ca}.0.weight"], None)),
                    p[f"{ca}.2.weight"], None)

    gate = torch.sigmoid(mlp(y.mean(dim=(2, 3), keepdim=True))
                         + mlp(y.amax(dim=(2, 3), keepdim=True)))
    t = y * gate
    stat = torch.cat([t.mean(dim=1, keepdim=True),
                      t.amax(dim=1, keepdim=True)], dim=1)
    wsa = p[f"{base}.cbam.spatial_attention.conv.weight"]
    return t * torch.sigmoid(conv(stat, wsa, None,
                                  padding=wsa.shape[-1] // 2))


def generator_blocks(p) -> int:
    return len({k.split(".")[1] for k in p if ".block.1.weight" in k})


def generator(p, x: torch.Tensor, conv=F.conv2d) -> torch.Tensor:
    """(N, in_ch, H, W) in [-1, 1] -> (N, 1, H, W) tanh output."""
    r = generator_blocks(p)
    relu_in = lambda t: F.relu(instance_norm(t))
    h = relu_in(_conv(p, "model.1", F.pad(x, (3, 3, 3, 3), mode="reflect"),
                      conv))
    h = relu_in(_conv(p, "model.4", h, conv, stride=2, padding=1))
    h = relu_in(_conv(p, "model.7", h, conv, stride=2, padding=1))
    for i in range(r):
        b = f"model.{10 + i}"
        t = _conv(p, f"{b}.block.1", F.pad(h, (1, 1, 1, 1), mode="reflect"),
                  conv)
        t = relu_in(t)
        t = _conv(p, f"{b}.block.5", F.pad(t, (1, 1, 1, 1), mode="reflect"),
                  conv)
        t = instance_norm(t)
        if f"{b}.cbam.spatial_attention.conv.weight" in p:
            t = _cbam(p, b, t, conv)
        h = h + t
    for idx in (11 + r, 15 + r):
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = relu_in(_conv(p, f"model.{idx}", h, conv, padding=1))
    h = _conv(p, f"model.{19 + r}", F.pad(h, (3, 3, 3, 3), mode="reflect"),
              conv)
    return torch.tanh(h)


def discriminator(p, x: torch.Tensor, conv=F.conv2d) -> torch.Tensor:
    """(N, 1, H, W) -> (N, 1, H/16, W/16) logits."""
    h = F.leaky_relu(_conv(p, "model.0", x, conv, stride=2, padding=1), 0.2)
    for idx in (2, 5, 8):
        h = _conv(p, f"model.{idx}", h, conv, stride=2, padding=1)
        h = F.leaky_relu(instance_norm(h), 0.2)
    h = F.pad(h, (1, 0, 1, 0))
    return _conv(p, "model.12", h, conv, padding=1)
