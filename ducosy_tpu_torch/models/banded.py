"""The generator forwards on row bands (``parallel/spatial.py``): the
``sp`` axis of a (data, sp) mesh for serving and training.

Both compute their whole-image forward op for op, each padded conv as a
halo window (the op's padding only at a global image edge) and a VALID
conv in H, each InstanceNorm and CBAM gate over the whole image:

  module  ``Generator``'s plain trunk (models/generator.py; the JAX
          ``Generator.apply``, ducosy_tpu/models/generator.py:294-360):
          reflect pad 3 + 7x7 stem, the stride-2 downs (one zero row above
          a band, none below: band edges are even), the plain blocks, the
          nearest-upsample + 3x3 ups (one row a side before the upsample),
          reflect pad 3 + 7x7 head; with or without CBAM, any input
          channels, fp32 or bf16;
  packed  ``generator_apply_packed`` at ``trunk="xla"`` without the kernels
          (models/fused.py; ducosy_tpu/models/fused.py:560-676): the s2d
          stem on a reflect window of 3 rows a side (the even-row pad and
          the ``[:h_out]`` crop never act on heights divisible by 4), the
          packed-4 / packed-16 phase norms, down1's zero row above, the
          sub-pixel ups, the packed head's phase reflection at the global
          edges only, the final depth-to-space band by band.

The JAX package runs no Pallas kernel under ``sp`` (ducosy_tpu/infer/
engine.py:69-80), so neither does this: every op inside a band is the
port's plain PyTorch (``layers.conv2d``, ``fused._conv``, ``_s2d2``,
``_d2s``).

The weights reach a band through ``weights_on(device)``: laid out once per
device for serving (``BandedGenerator``), or sent from the parameters'
device with ``.to()`` in each forward for training (``banded_apply``), so
the bands' gradients add up in autograd.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from ducosy_tpu_torch.models.fused import (
    PackedWeights,
    _conv,
    _d2s,
    _s2d2,
    packed16_edge,
    packed_weights,
)
from ducosy_tpu_torch.models.generator import Generator
from ducosy_tpu_torch.models.layers import conv2d
from ducosy_tpu_torch.parallel import spatial
from ducosy_tpu_torch.parallel.spatial import BandPlan, Bands, pad_w

FORWARDS = ("module", "packed")


def module_weights(gen: Generator, dt: torch.dtype) -> dict:
    """A module generator's convs as (OIHW weight, bias) in ``dt`` and its
    blocks as ``Generator._blocks`` gives them; differentiable."""
    m, r = gen.model, gen.num_residual_blocks
    conv = lambda mod: (mod.weight.to(dt), mod.bias.to(dt))
    return {"stem": conv(m[1]), "d1": conv(m[4]), "d2": conv(m[7]),
            "blocks": gen._blocks(dt), "u1": conv(m[11 + r]),
            "u2": conv(m[15 + r]), "hd": conv(m[19 + r])}


def tree_to(tree, device):
    """Every tensor of a weight tree (dicts, tuples, lists,
    ``PackedWeights``) moved to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, PackedWeights):
        return tree._replace(convs=tree_to(tree.convs, device),
                             biases=tree_to(tree.biases, device),
                             trunk=tree_to(tree.trunk, device),
                             int8=tree_to(tree.int8, device))
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree


def _trunk(h: Bands, plan: BandPlan, weights_on, key) -> Bands:
    """The plain residual blocks at H/4 (``fused.trunk_plain``): x + [CBAM]
    (IN(conv2(pad(ReLU(IN(conv1(pad(x)))))))), each conv with its bias."""
    first = plan.devices[0]
    for i in range(len(key(weights_on(first)))):
        blk = [key(weights_on(d))[i] for d in plan.devices]

        def conv(bands, j):
            return [conv2d(pad_w(t, 1), b[j], b[j + 1].to(t.dtype))
                    for t, b in zip(spatial.window(bands, plan, 4, 1, 1,
                                                   "reflect"), blk)]

        t = spatial.instance_norm(conv(h, 0), relu=True)
        t = spatial.instance_norm(conv(t, 2))
        if len(blk[0]) > 4:
            fc1, fc2 = blk[0][4], blk[0][5]
            t = spatial.cbam(t, plan, 4, fc1, fc2,
                             lambda d: key(weights_on(d))[i][6])
        h = [a + b for a, b in zip(h, t)]
    return h


def _convs(bands: Bands, plan: BandPlan, weights_on, name: str, f: int,
           top: int, bot: int, pad, *, w_pad: int, w_mode: str = "reflect",
           stride: int = 1) -> Bands:
    """Each band's window through the named conv of its device's weights."""
    out = []
    for t, dev in zip(spatial.window(bands, plan, f, top, bot, pad),
                      plan.devices):
        w, b = weights_on(dev)[name]
        if w_mode == "zeros":
            out.append(conv2d(t, w, b, stride=stride, padding=(0, w_pad)))
        else:
            out.append(conv2d(pad_w(t, w_pad, w_mode), w, b, stride=stride))
    return out


def _up(bands: Bands, plan: BandPlan, weights_on, name: str, f: int) -> Bands:
    """nearest-upsample x2 + zero-padded 3x3 conv: one row a side of the
    band's window, upsampled, then the outer upsampled row a side
    dropped."""
    out = []
    for t, dev in zip(spatial.window(bands, plan, f, 1, 1, "zeros"),
                      plan.devices):
        n, h, w, c = t.shape
        up = t[:, :, None, :, None, :].expand(n, h, 2, w, 2, c) \
            .reshape(n, 2 * h, 2 * w, c).narrow(1, 1, 2 * h - 2)
        wt, b = weights_on(dev)[name]
        out.append(conv2d(up, wt, b, padding=(0, 1)))
    return out


def module_forward(xs: Bands, plan: BandPlan,
                   weights_on: Callable, dt: torch.dtype) -> Bands:
    """``Generator.forward`` at trunk="plain" on NHWC bands of the input:
    bands of the (N, H, W, 1) fp32 tanh output."""
    norm = lambda b: spatial.instance_norm(b, relu=True)
    h = _convs([x.to(dt) for x in xs], plan, weights_on, "stem", 1, 3, 3,
               "reflect", w_pad=3)
    h = _convs(norm(h), plan, weights_on, "d1", 1, 1, 0, "zeros", w_pad=1,
               w_mode="zeros", stride=2)
    h = _convs(norm(h), plan, weights_on, "d2", 2, 1, 0, "zeros", w_pad=1,
               w_mode="zeros", stride=2)
    h = _trunk(norm(h), plan, weights_on, lambda w: w["blocks"])
    h = norm(_up(h, plan, weights_on, "u1", 4))
    h = norm(_up(h, plan, weights_on, "u2", 2))
    h = _convs(h, plan, weights_on, "hd", 1, 3, 3, "reflect", w_pad=3)
    return [torch.tanh(t.to(torch.float32)) for t in h]


def _packed_blocks(pw: PackedWeights) -> list:
    return [(pw.convs[f"c1_{i}"], pw.biases[f"c1_{i}"], pw.convs[f"c2_{i}"],
             pw.biases[f"c2_{i}"], *(t[i] for t in pw.trunk[2:]))
            for i in range(pw.blocks)]


def packed_forward(xs: Bands, plan: BandPlan,
                   weights_on: Callable) -> Bands:
    """``generator_apply_packed(trunk="xla", encoder_fused=False)`` on NHWC
    bands of the input: bands of the (N, H, W, 1) fp32 tanh output.
    ``weights_on(device)`` gives ``PackedWeights``."""
    first = weights_on(plan.devices[0])
    if first.quant:
        raise ValueError("row bands run the packed forward unquantized")
    dt, c = first.dtype, first.channels
    phase_norm = lambda b, g: spatial.instance_norm(b, relu=True, groups=g)
    pk = lambda name: (lambda dev: (weights_on(dev).convs[name],
                                    weights_on(dev).biases[name]))
    w = xs[0].shape[2]
    if xs[0].shape[1] % 4 or w % 4:
        raise ValueError("packed forward: H, W must divide by 4")
    h = []
    for t, dev in zip(spatial.window([x.to(dt) for x in xs], plan, 1, 3, 3,
                                     "reflect"), plan.devices):
        wt, b = pk("stem")(dev)
        h.append(_conv(_s2d2(pad_w(t, 3)), wt, b)[:, :, :w // 2])
    h = phase_norm(h, 4)                               # packed-4 of H
    h = [_conv(F.pad(t, (0, 0, 1, 0)), *pk("d1")(dev)) for t, dev in
         zip(spatial.window(h, plan, 2, 1, 0, "zeros"), plan.devices)]
    h = spatial.instance_norm(h, relu=True)            # H/2 x 2 base
    h = [_conv(t, *pk("d2")(dev), stride=2, padding=(0, 1)) for t, dev in
         zip(spatial.window(h, plan, 2, 1, 0, "zeros"), plan.devices)]
    h = _trunk(spatial.instance_norm(h, relu=True), plan, weights_on,
               _packed_blocks)
    for name, groups in (("u1", 4), ("u2", 16)):
        h = [_conv(F.pad(t, (0, 0, 1, 1)), *pk(name)(dev)) for t, dev in
             zip(spatial.window(h, plan, 4, 1, 1, "zeros"), plan.devices)]
        h = phase_norm(h, groups)            # packed-4 of H/2, packed-16
    edge = lambda row, side: packed16_edge(row, c, 1, side)
    out = []
    for t, dev in zip(spatial.window(h, plan, 4, 1, 1, edge), plan.devices):
        t = torch.cat([packed16_edge(t.narrow(2, 0, 1), c, 2, "pre"), t,
                       packed16_edge(t.narrow(2, t.shape[2] - 1, 1), c, 2,
                                     "post")], dim=2)
        out.append(_d2s(torch.tanh(_conv(t, *pk("hd")(dev))
                                   .to(torch.float32)), 4))
    return out


def _forward(x: torch.Tensor, devices: Sequence, forward: str,
             weights_on: Callable, dt: torch.dtype) -> torch.Tensor:
    plan = spatial.band_plan(x.shape[1], devices)
    xs = spatial.split(x, plan)
    ys = module_forward(xs, plan, weights_on, dt) if forward == "module" \
        else packed_forward(xs, plan, weights_on)
    return spatial.gather(ys, x.device)


def check_sp_generator(gen: Generator) -> None:
    """Refuse a module generator whose forward holds kernels: under ``sp``
    the JAX package partitions only the plain math."""
    if gen.trunk != "plain" or gen.fused_norm or gen.quant:
        raise ValueError(
            f"trunk={gen.trunk!r}, fused_norm={gen.fused_norm}, quant="
            f"{gen.quant!r}: under sp sharding only the plain trunk "
            "partitions (the kernels and the quantized modes are refused, "
            "as the JAX engine refuses them)")


def banded_apply(gen: Generator, x: torch.Tensor, devices: Sequence, *,
                 forward: str = "module") -> torch.Tensor:
    """The training forward on row bands: x (N, H, W, C) on the parameters'
    device, split over ``devices`` (the mesh row, its first device the
    parameters'), the output gathered back there. The weights are sent to
    each band's device in this call, differentiably."""
    check_sp_generator(gen)
    dt = gen.compute_dtype or gen.model[1].weight.dtype
    whole = module_weights(gen, dt) if forward == "module" else \
        packed_weights(gen, dtype=dt)
    return _forward(x, devices, forward, _on_devices(whole), dt)


def _on_devices(whole) -> Callable:
    """``weights_on`` of a weight tree: moved once per device asked for."""
    cache = {}

    def weights_on(dev):
        dev = torch.device(dev)
        if dev not in cache:
            cache[dev] = tree_to(whole, dev)
        return cache[dev]
    return weights_on


class BandedGenerator:
    """One generator served on a mesh row's devices, called like the
    module: (N, H, W, in_ch) on the row's first device -> (N, H, W, 1)
    there. The weights are laid out once per distinct device: the module
    forward's plain convs, or the packed forward's ``PackedWeights``."""

    def __init__(self, sd, *, devices: Sequence, dtype: torch.dtype,
                 forward: str):
        if forward not in FORWARDS:
            raise ValueError(f"forward must be one of {FORWARDS}: "
                             f"{forward!r}")
        self.devices = tuple(torch.device(d) for d in devices)
        self.forward, self.dtype = forward, dtype
        with torch.no_grad():
            if forward == "packed":
                whole = packed_weights(sd, dtype=dtype,
                                       memory_format=torch.channels_last)
            else:
                gen = Generator.from_state_dict(sd, trunk="plain")
                whole = module_weights(gen, dtype)
                self.num_residual_blocks = gen.num_residual_blocks
            self.weights_on = _on_devices(whole)
            for dev in self.devices:
                self.weights_on(dev)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _forward(x, self.devices, self.forward, self.weights_on,
                        self.dtype)
