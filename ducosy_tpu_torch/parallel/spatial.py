"""Row bands: the ``sp`` axis of a (data, sp) mesh (ducosy_tpu/parallel/
mesh.py:36-50), written by hand where XLA's SPMD partitioner writes it.

An NHWC image batch is split into bands of image rows, one band a device of
a mesh row, and every op of the generators runs band by band. Three things
cross bands, all in eager PyTorch, so autograd runs through them as it runs
through any op (``.to()``, ``narrow``, ``flip`` and ``cat`` are
differentiable) and the CPU runs the whole mesh in one process:

  window   a band plus the rows above and below it that a conv reads, from
           whichever bands hold them (several when a band is thinner than
           the halo), the op's own padding taken only where the window
           passes a global image edge: "reflect" maps rows through the
           image's edges (so a band of the top rows reads the same mirrored
           rows as the whole image), "zeros" fills them, and a callable
           builds the one row beyond an edge from the edge row (the packed
           head's phase reflection, ``models/fused.py:packed16_edge``);
  norm     InstanceNorm over the whole image: the JAX function's two passes
           (ducosy_tpu/models/layers.py:22-32), each band's fp32 partial
           sums added on the row's first device, the mean sent back, then
           the centred sums of squares the same way; biased variance, eps
           1e-5; ``groups`` pools the phase groups of a packed channel axis
           as ``packed_in_relu`` does (models/fused.py);
  cbam     CBAM's gates (ducosy_tpu/models/generator.py:50-85): the channel
           gate's global mean and max pools from per-band partials on the
           first device, the gate sent back; the spatial gate's channel
           mean/max maps are per pixel, so the 7x7 conv reads a window of
           the 2-channel map, never of the C-channel tensor.

A ``BandPlan`` cuts the rows on multiples of ``GROUP`` = 4 full-resolution
rows, so a band holds whole rows in every layout of the generators: true
H, H/2 and H/4, packed-4 rows (2 true rows each) and packed-16 rows (4).
Bands are as equal as 4-row groups allow; an image of fewer groups than
devices, or whose height does not divide by 4, is refused.
"""
from __future__ import annotations

import bisect
from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ducosy_tpu_torch.models.layers import EPS_INSTANCE_NORM
from ducosy_tpu_torch.ops.kernels.block_tail import SA_KERNEL, \
    hwio_to_oihw, _spatial_stat

GROUP = 4   # full-resolution rows per band group

Bands = list   # one NHWC tensor a band, each on its device


class BandPlan(NamedTuple):
    """Row edges of the bands at full resolution (``edges[i]`` to
    ``edges[i + 1]`` is band i, on ``devices[i]``)."""
    edges: tuple
    devices: tuple

    def rows(self, f: int) -> tuple:
        """The edges in a layout whose row holds ``f`` full-resolution
        rows (f = 1, 2 or 4)."""
        return tuple(e // f for e in self.edges)


def band_plan(height: int, devices: Sequence) -> BandPlan:
    """Bands of ``height`` rows over ``devices``, edges on multiples of
    ``GROUP``, the groups dealt out as evenly as they go."""
    devices = tuple(torch.device(d) for d in devices)
    sp = len(devices)
    if height % GROUP:
        raise ValueError(f"row bands need the image height to divide by "
                         f"{GROUP}, got {height}")
    groups = height // GROUP
    if groups < sp:
        raise ValueError(f"{height} rows make {groups} bands of {GROUP} "
                         f"rows, fewer than sp = {sp}")
    q, r = divmod(groups, sp)
    edges = [0]
    for i in range(sp):
        edges.append(edges[-1] + (q + (i < r)) * GROUP)
    return BandPlan(tuple(edges), devices)


def split(x: torch.Tensor, plan: BandPlan, f: int = 1, dim: int = 1) -> Bands:
    """The bands of a whole tensor, each moved to its device."""
    edges = plan.rows(f)
    if x.shape[dim] != edges[-1]:
        raise ValueError(f"{x.shape[dim]} rows against the plan's "
                         f"{edges[-1]}")
    return [x.narrow(dim, lo, hi - lo).to(dev) for lo, hi, dev in
            zip(edges, edges[1:], plan.devices)]


def gather(bands: Bands, device, dim: int = 1) -> torch.Tensor:
    """The whole tensor of ``bands`` on ``device``."""
    return torch.cat([b.to(device) for b in bands], dim)


def _source(r: int, height: int, pad):
    """The global row that row r of the padded image reads, or "pre" /
    "post" for a pad row before / after the image."""
    if 0 <= r < height:
        return r
    if pad == "reflect":
        m = -r if r < 0 else 2 * (height - 1) - r
        if not 0 <= m < height:
            raise ValueError(f"reflect pad beyond a {height}-row image")
        return m
    return "pre" if r < 0 else "post"


def _runs(srcs, band_of) -> list:
    """Consecutive global rows of one band, in steps of +1 or -1, as lists;
    a pad row as its side."""
    runs = []
    for s in srcs:
        cur = runs[-1] if runs and isinstance(runs[-1], list) else None
        if isinstance(s, int) and cur and band_of(s) == band_of(cur[0]) \
                and abs(s - cur[-1]) == 1 and (
                    len(cur) == 1 or s - cur[-1] == cur[1] - cur[0]):
            cur.append(s)
        else:
            runs.append([s] if isinstance(s, int) else s)
    return runs


def window(bands: Bands, plan: BandPlan, f: int, top: int, bot: int,
           pad: str | Callable = "zeros", dim: int = 1) -> Bands:
    """Per band i of rows [lo, hi), rows [lo - top, hi + bot) of the padded
    whole image, on band i's device: rows inside the image from the bands
    that hold them, rows beyond a global edge by ``pad`` ("reflect",
    "zeros", or ``pad(edge_row, side)`` for one row, side "pre" or
    "post")."""
    edges = plan.rows(f)
    height = edges[-1]
    if callable(pad) and (top > 1 or bot > 1):
        raise ValueError("a callable pad builds one row a side")
    band_of = lambda g: bisect.bisect_right(edges, g) - 1

    def rows(run, dev):
        j = band_of(run[0])
        t = bands[j].narrow(dim, min(run[0], run[-1]) - edges[j], len(run))
        return (t.flip(dim) if run[-1] < run[0] else t).to(dev)

    out = []
    for i, (lo, hi) in enumerate(zip(edges, edges[1:])):
        if top == bot == 0:
            out.append(bands[i])
            continue
        dev = plan.devices[i]
        pieces = []
        for run in _runs([_source(r, height, pad)
                          for r in range(lo - top, hi + bot)], band_of):
            if isinstance(run, list):
                pieces.append(rows(run, dev))
            elif callable(pad):
                pieces.append(pad(rows([0 if run == "pre" else height - 1],
                                       dev), run))
            else:
                shape = list(bands[i].shape)
                shape[dim] = 1
                pieces.append(bands[i].new_zeros(shape))
        out.append(torch.cat(pieces, dim))
    return out


def pad_w(x: torch.Tensor, p: int, mode: str = "reflect") -> torch.Tensor:
    """Pad the W axis of NHWC x by p a side ("reflect" or "zeros")."""
    if p == 0:
        return x
    if mode == "zeros":
        return F.pad(x, (0, 0, p, p))
    return F.pad(x.permute(0, 3, 1, 2), (p, p, 0, 0),
                 mode=mode).permute(0, 2, 3, 1)


def _sum_on(parts, device) -> torch.Tensor:
    total = None
    for t in parts:
        t = t.to(device)
        total = t if total is None else total + t
    return total


def instance_norm(bands: Bands, *, relu: bool = False, groups: int = 1,
                  eps: float = EPS_INSTANCE_NORM) -> Bands:
    """IN over the whole image of NHWC bands (fp32 statistics, pooled over
    ``groups`` phase groups of the channel axis), optional ReLU, each band
    rounded to its dtype: ``layers.instance_norm`` and
    ``instance_norm_plain(phases=groups)`` on the whole tensor."""
    first = bands[0].device
    n, _, w, cf = bands[0].shape
    c = cf // groups
    views = [b.to(torch.float32).reshape(n, b.shape[1], w, groups, c)
             for b in bands]
    count = sum(v.shape[1] for v in views) * w * groups
    dims = (1, 2, 3)
    mean = _sum_on([v.sum(dims, keepdim=True) for v in views], first) / count
    means = [mean.to(v.device) for v in views]
    m2 = _sum_on([(v - m).square().sum(dims, keepdim=True)
                  for v, m in zip(views, means)], first)
    inv = torch.reciprocal(torch.sqrt(m2 / count + eps))
    out = []
    for b, v, m in zip(bands, views, means):
        y = ((v - m) * inv.to(v.device)).reshape(b.shape)
        out.append(torch.relu(y).to(b.dtype) if relu else y.to(b.dtype))
    return out


def cbam(bands: Bands, plan: BandPlan, f: int, w1, w2, wsa_on) -> Bands:
    """CBAM of normalized NHWC bands (``block_tail.cbam_plain`` on the whole
    tensor): ``w1`` (C, R), ``w2`` (R, C) on the first band's device,
    ``wsa_on(device)`` the (7, 7, 2, 1) spatial kernel there."""
    first = bands[0].device
    n, _, w, c = bands[0].shape
    pixels = sum(b.shape[1] for b in bands) * w
    avg = _sum_on([b.to(torch.float32).sum((1, 2)) for b in bands],
                  first) / pixels
    mx = torch.stack([b.amax((1, 2)).to(first) for b in bands]).amax(0) \
        .to(torch.float32)
    hid = torch.relu(torch.stack([avg, mx], dim=1) @ w1.to(torch.float32))
    gates = hid @ w2.to(torch.float32)
    gate_c = torch.sigmoid(gates[:, 0] + gates[:, 1])
    ts = [b * gate_c.to(b.dtype)[:, None, None, :].to(b.device)
          for b in bands]
    half = SA_KERNEL // 2
    maps = window([_spatial_stat(t) for t in ts], plan, f, half, half,
                  "zeros", dim=2)
    out = []
    for t, m in zip(ts, maps):
        z = F.conv2d(m, hwio_to_oihw(wsa_on(t.device).to(torch.float32)),
                     padding=(0, half))
        out.append(t * torch.sigmoid(z).permute(0, 2, 3, 1).to(t.dtype))
    return out
