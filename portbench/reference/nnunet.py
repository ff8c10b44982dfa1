"""nnU-Net v2's ``3d_fullres`` inference in plain float32 PyTorch, as
TotalSegmentator runs it on a CT series (MIC-DKFZ/nnUNet,
``nnunetv2/inference/sliding_window_prediction.py``,
``predict_from_raw_data.py``, ``preprocessing/normalization/
default_normalization_schemes.py`` ``CTNormalization``; MIC-DKFZ/
dynamic-network-architectures ``PlainConvUNet``, ``UNetDecoder``).

The network on a parameter dict in nnU-Net's layout (one key a
parameter: ``encoder.stages.{s}.0.convs.{i}.{conv,norm}.*``,
``decoder.transpconvs.{s}.*``, ``decoder.stages.{s}.convs.{i}.*``,
``decoder.seg_layers.{s}.*``), NCDHW: each conv (zero padding (k - 1) / 2,
bias) is followed by ``F.instance_norm`` with the affine (eps 1e-5) and
``F.leaky_relu`` (0.01); the decoder's ``F.conv_transpose3d`` output is
concatenated before its skip; the last seg layer gives the logits.

Around it, each written here from nnU-Net's description:
  resample     the volume to round(size * spacing / target) voxels,
               trilinear with the corner voxels aligned, one axis at a time
               (TotalSegmentator's cubic ``change_spacing`` is the source;
               the configuration lists trilinear as a departure), and the
               labels back by nearest neighbour (index floor(o (n_in - 1) /
               (n_out - 1) + 0.5));
  normalize    clip to [lower, upper], minus mean, over std;
  steps        ``compute_steps_for_sliding_window`` at step 0.5;
  gaussian     ``compute_gaussian``: ``scipy.ndimage.gaussian_filter`` of a
               delta at patch // 2, sigma patch / 8, over its max times 10,
               zeros raised to the smallest non-zero value;
  window       one patch at a time, padded to the patch where smaller
               (centred, zeros), the logits times the map and the map
               summed in float32, divided, the padding dropped, argmax.
No mirroring (``nnUNetTrainerNoMirroring``). TF32 is switched off for
matmuls and cuDNN by ``segment``.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch
import torch.nn.functional as F

EPS, SLOPE = 1e-5, 0.01


def param_shapes(plan: dict) -> dict:
    """{key: shape} of the network's parameters, in module order."""
    shapes, cin = {}, plan["input_channels"]
    feats, kernels = plan["features"], plan["kernel_sizes"]

    def block(prefix, n, ci, co, k):
        for i in range(n):
            p = f"{prefix}.convs.{i}"
            shapes[f"{p}.conv.weight"] = (co, ci if i == 0 else co, *k)
            shapes[f"{p}.conv.bias"] = (co,)
            shapes[f"{p}.norm.weight"] = (co,)
            shapes[f"{p}.norm.bias"] = (co,)

    for s, co in enumerate(feats):
        block(f"encoder.stages.{s}.0", plan["n_conv_per_stage"][s], cin, co,
              kernels[s])
        cin = co
    for s in range(1, len(feats)):
        skip = feats[-(s + 1)]
        block(f"decoder.stages.{s - 1}",
              plan["n_conv_per_stage_decoder"][s - 1], 2 * skip, skip,
              kernels[-(s + 1)])
    for s in range(1, len(feats)):
        below, skip = feats[-s], feats[-(s + 1)]
        shapes[f"decoder.transpconvs.{s - 1}.weight"] = \
            (below, skip, *plan["strides"][-s])
        shapes[f"decoder.transpconvs.{s - 1}.bias"] = (skip,)
    for s in range(1, len(feats)):
        skip = feats[-(s + 1)]
        shapes[f"decoder.seg_layers.{s - 1}.weight"] = \
            (plan["classes"], skip, 1, 1, 1)
        shapes[f"decoder.seg_layers.{s - 1}.bias"] = (plan["classes"],)
    return shapes


def quantize_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with a per-tensor scale (its largest
    |value| to the format's largest), back in float32: the control."""
    top = torch.finfo(torch.float8_e4m3fn).max
    s = t.abs().amax().clamp_min(1e-30) / top
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def forward(p: dict, x: torch.Tensor, plan: dict,
            fp8: bool = False) -> torch.Tensor:
    """Logits (N, classes, *patch) of x (N, C, *patch), float32; with
    ``fp8`` every conv's and transposed conv's operands rounded to e4m3
    first (the control)."""
    q = quantize_fp8 if fp8 else (lambda t: t)
    feats = plan["features"]

    def block(x, prefix, n, stride):
        for i in range(n):
            k = f"{prefix}.convs.{i}"
            w = p[f"{k}.conv.weight"]
            x = F.conv3d(q(x), q(w), p[f"{k}.conv.bias"],
                         stride if i == 0 else 1,
                         [(d - 1) // 2 for d in w.shape[2:]])
            x = F.instance_norm(x, weight=p[f"{k}.norm.weight"],
                                bias=p[f"{k}.norm.bias"], eps=EPS)
            x = F.leaky_relu(x, SLOPE)
        return x

    skips = []
    for s in range(len(feats)):
        x = block(x, f"encoder.stages.{s}.0", plan["n_conv_per_stage"][s],
                  tuple(plan["strides"][s]))
        skips.append(x)
    for s in range(len(feats) - 1):
        t = f"decoder.transpconvs.{s}"
        stride = tuple(plan["strides"][-(s + 1)])
        up = F.conv_transpose3d(q(x), q(p[f"{t}.weight"]), p[f"{t}.bias"],
                                stride)
        x = block(torch.cat([up, skips[-(s + 2)]], 1), f"decoder.stages.{s}",
                  plan["n_conv_per_stage_decoder"][s], 1)
    last = len(feats) - 2
    return F.conv3d(q(x), q(p[f"decoder.seg_layers.{last}.weight"]),
                    p[f"decoder.seg_layers.{last}.bias"])


def target_shape(shape, spacing, target) -> tuple:
    return tuple(int(round(n * s / t)) for n, s, t in zip(shape, spacing,
                                                         target))


def _lerp_axis(v: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    n_in = v.shape[axis]
    if n_in == n_out:
        return v
    pos = (np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
           if n_out > 1 else np.zeros(1))
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, max(n_in - 2, 0))
    i1 = np.minimum(i0 + 1, n_in - 1)
    t = torch.tensor(pos - i0, dtype=torch.float32, device=v.device)
    t = t.view(*[-1 if a == axis else 1 for a in range(v.dim())])
    a = v.index_select(axis, torch.from_numpy(i0).to(v.device))
    b = v.index_select(axis, torch.from_numpy(i1).to(v.device))
    return a + (b - a) * t


def resample_linear(v: torch.Tensor, shape) -> torch.Tensor:
    for axis, n in enumerate(shape):
        v = _lerp_axis(v, axis, n)
    return v


def resample_nearest(v: torch.Tensor, shape) -> torch.Tensor:
    for axis, n_out in enumerate(shape):
        n_in = v.shape[axis]
        idx = (np.floor(np.arange(n_out, dtype=np.float64) * (n_in - 1)
                        / (n_out - 1) + 0.5).astype(np.int64)
               if n_out > 1 else np.zeros(1, np.int64))
        v = v.index_select(axis, torch.from_numpy(idx).to(v.device))
    return v


def normalize(v: torch.Tensor, norm: dict) -> torch.Tensor:
    return (v.clamp(norm["lower"], norm["upper"]) - norm["mean"]) \
        / max(norm["std"], 1e-8)


def steps(image_size, tile_size, step: float = 0.5) -> list:
    out = []
    for i, k in zip(image_size, tile_size):
        n = int(np.ceil((i - k) / (k * step))) + 1
        actual = (i - k) / (n - 1) if n > 1 else 99999999999
        out.append([int(np.round(actual * j)) for j in range(n)])
    return out


def gaussian(patch, device) -> torch.Tensor:
    from scipy.ndimage import gaussian_filter

    tmp = np.zeros(patch)
    tmp[tuple(p // 2 for p in patch)] = 1
    g = gaussian_filter(tmp, [p / 8 for p in patch], 0, mode="constant",
                        cval=0)
    g = torch.from_numpy(g / g.max() * 10).to(device, torch.float32)
    zero = g == 0
    if zero.any():
        g[zero] = g[~zero].min()
    return g


def segment(hu: torch.Tensor, spacing, p: dict, plan: dict,
            fp8: bool = False) -> tuple:
    """(logits (classes, *plan grid) float32, labels at the series grid
    int64) of a (z, y, x) HU volume on its device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    patch = tuple(plan["patch_size"])
    shape = target_shape(hu.shape, spacing, plan["spacing"])
    with torch.no_grad():
        v = normalize(resample_linear(hu.to(torch.float32), shape),
                      plan["normalization"])
        pads = [max(k - n, 0) for n, k in zip(shape, patch)]
        v = F.pad(v, [a for d in reversed(pads) for a in (d // 2,
                                                          d - d // 2)])
        g = gaussian(patch, v.device)
        acc = torch.zeros((plan["classes"], *v.shape), device=v.device)
        wsum = torch.zeros(v.shape, device=v.device)
        for org in itertools.product(*steps(v.shape, patch, plan["step"])):
            box = tuple(slice(o, o + k) for o, k in zip(org, patch))
            out = forward(p, v[box][None, None], plan, fp8)[0]
            acc[(slice(None), *box)] += out * g
            wsum[box] += g
        inner = tuple(slice(d // 2, d // 2 + n) for d, n in zip(pads, shape))
        logits = acc[(slice(None), *inner)] / wsum[inner]
        labels = resample_nearest(logits.argmax(0), hu.shape)
    return logits, labels


def patches(shape, spacing, plan: dict) -> int:
    """Patches of a series of ``shape`` (z, y, x) at ``spacing``."""
    grid = [max(n, k) for n, k in zip(target_shape(shape, spacing,
                                                   plan["spacing"]),
                                      plan["patch_size"])]
    return math.prod(len(s) for s in steps(grid, plan["patch_size"],
                                           plan["step"]))
