"""Operations and bytes of nnU-Net's ``PlainConvUNet`` at a plan's widths,
from shapes: the architecture's multiply-accumulates for one patch (2
operations each), and the least bytes of its norms, for the peaks of
``portbench/roofline``.

A patch runs the encoder's convs (the first of a stage at the stage's
stride), each decoder stage's transposed conv and convs, and the last seg
layer only (inference, no deep supervision). A k^3 conv's MACs are
cin * cout * k^3 per output voxel; a stride-s transposed conv's cin * cout
* s^3 per input voxel. Norms, activations, the concat and the window's
weighting are not counted as operations.
"""
from __future__ import annotations

import math


def stage_grids(plan: dict) -> list:
    """The voxel grid (z, y, x) of each encoder stage on one patch."""
    grid, out = list(plan["patch_size"]), []
    for stride in plan["strides"]:
        grid = [g // s for g, s in zip(grid, stride)]
        out.append(tuple(grid))
    return out


def norms(plan: dict) -> list:
    """(voxels, channels) of each norm a patch runs, in order: the
    encoder's convs, then the decoder's."""
    grids, feats = stage_grids(plan), plan["features"]
    out = [(math.prod(grids[s]), feats[s])
           for s in range(len(feats))
           for _ in range(plan["n_conv_per_stage"][s])]
    for s in range(len(feats) - 1):
        below = len(feats) - 2 - s
        out += [(math.prod(grids[below]), feats[below])] * \
            plan["n_conv_per_stage_decoder"][s]
    return out


def patch_macs(plan: dict) -> float:
    """Multiply-accumulates of one patch through the network."""
    grids, feats, ks = stage_grids(plan), plan["features"], \
        plan["kernel_sizes"]
    macs, cin = 0.0, plan["input_channels"]
    for s, cout in enumerate(feats):
        k3 = math.prod(ks[s])
        vox = math.prod(grids[s])
        macs += vox * k3 * cin * cout
        macs += (plan["n_conv_per_stage"][s] - 1) * vox * k3 * cout * cout
        cin = cout
    for s in range(len(feats) - 1):
        hi, lo = len(feats) - 1 - s, len(feats) - 2 - s
        vox_lo = math.prod(grids[lo])
        macs += math.prod(grids[hi]) * math.prod(plan["strides"][hi]) \
            * feats[hi] * feats[lo]
        k3 = math.prod(ks[lo])
        macs += vox_lo * k3 * 2 * feats[lo] * feats[lo]
        macs += (plan["n_conv_per_stage_decoder"][s] - 1) * vox_lo * k3 \
            * feats[lo] * feats[lo]
    macs += math.prod(grids[0]) * feats[0] * plan["classes"]
    return macs


def patch_flop(plan: dict) -> float:
    """Operations of one patch through the network (2 a MAC)."""
    return 2.0 * patch_macs(plan)


def norm_bytes(plan: dict, batch: int, itemsize: int = 2) -> float:
    """The least bytes of every norm of one forward of ``batch`` patches:
    each norm's input read once and its output written once."""
    return sum(2.0 * batch * vox * c * itemsize for vox, c in norms(plan))
