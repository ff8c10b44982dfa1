"""Segmentation driver: one client in a closed loop through the masking
CLI's in-process segmenter (``ducosy_tpu_torch/infer/segment.py``
``Segmenter``, as ``masks/totalseg.segment_patients`` drives it: launch
patient i, then download patient i - 1 with the segmenter's ``download``),
DICOM decode and NIfTI write left out.

Traffic file keys: ``sizes`` (slices of the patients, cycled in order),
``img_size``, ``spacing_mm`` (z, y, x), ``sample`` (patients compared with
the reference after the window: the longest and others drawn from the
seed), ``profile_patients`` (patients in the traced segment, after the
window). Each patient is the leading slices of one seeded phantom volume of
the largest size, HU in int16. The network's weights are made from the seed
in the reference's layout (``portbench/reference/nnunet.py``) and loaded
into the program's ``PlainConvUNet`` strictly.

The window opens at a synchronize, launches no patient after ``seconds``,
and closes when the last patient launched in it has been downloaded. The
first window patient of each sampled size keeps its accumulated logits on
the card; after the window those logits and that patient's labels are
compared with the reference's, at full size, one patch at a time.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import numpy as np
import torch

from portbench.harness import inputs
from portbench.harness.common import Outcome, Parts, Reading, log, sync
from portbench.harness.serve_closed_loop import sample_sizes
from portbench.harness.trace import Segment, span
from portbench.program import counters
from portbench.reference import nnunet as ref
from portbench.roofline.nnunet import norm_bytes

TAG_NET, TAG_VOLUME = 40, 41


def nnunet_weights(config: dict, seed: int, device) -> dict:
    """The network's parameters from ``seed`` in the reference's layout,
    one N(0, 1) draw split in order: conv and transposed-conv weights
    He-normal (``kaiming_normal_`` at the configuration's slope, fan-in as
    torch counts it), the rest as the configuration's ``init`` says."""
    plan, init = config["network"], config["init"]
    shapes = ref.param_shapes(plan)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()),
                       generator=gen, device=device)
    gain = math.sqrt(2.0 / (1 + init["negative_slope"] ** 2))
    out, at = {}, 0
    for key, shape in shapes.items():
        v = flat[at:at + math.prod(shape)].view(shape)
        at += math.prod(shape)
        if key.endswith("norm.weight"):
            v = init["norm_weight_mean"] + init["norm_weight_std"] * v
        elif key.endswith("norm.bias"):
            v = init["norm_bias_std"] * v
        elif key.endswith("bias"):
            v = init["bias_std"] * v
        else:
            v = v * (gain / math.sqrt(shape[1] * math.prod(shape[2:])))
        out[key] = v
    return out


def make_segmenter(config: dict, seed: int, device):
    """The masking CLI's segmenter on the seeded weights."""
    from ducosy_tpu_torch.infer.segment import Segmenter
    from ducosy_tpu_torch.models.nnunet import PlainConvUNet

    plan = config["network"]
    sd = {k: v.cpu() for k, v in nnunet_weights(
        config, inputs.derive(seed, TAG_NET), device).items()}
    net = PlainConvUNet.from_canonical(plan, sd)
    return Segmenter(net, plan, device=device,
                     dtype=getattr(torch, config["compute_dtype"]),
                     patch_batch=config["patch_batch"])


def make_volume(traffic: dict, seed: int, device) -> np.ndarray:
    """(largest size, img, img) int16 HU of the seeded phantom."""
    hu = inputs.phantom_hu(max(traffic["sizes"]), traffic["img_size"],
                           inputs.derive(seed, TAG_VOLUME), device)
    return hu.round().clamp(-1024, 3071).to(torch.int16).cpu().numpy()


def forwards(patches: int, batch: int) -> list:
    """The batch sizes of a patient's forwards."""
    return [batch] * (patches // batch) + ([patches % batch]
                                           if patches % batch else [])


def k2_counts() -> dict:
    from ducosy_tpu_torch.ops.kernels import instance_norm as k2

    return {"instance_norm3d": k2.instance_norm3d.launches,
            "instance_norm": k2.instance_norm.launches}


def check_path(segmenter, config, traffic, vol) -> str:
    """Each size once: every norm a K2 3-D launch (``norms_per_forward``
    a forward of ``patch_batch`` patches), no 2-D K2 launch."""
    plan, spacing = config["network"], traffic["spacing_mm"]
    lines = []
    for z in dict.fromkeys(traffic["sizes"]):
        before = k2_counts()
        segmenter.download(segmenter.segment_async(vol[:z], spacing))
        p = ref.patches((z, *vol.shape[1:]), spacing, plan)
        want = {"instance_norm3d": config["path"]["norms_per_forward"]
                * len(forwards(p, config["patch_batch"])),
                "instance_norm": 0}
        got = {k: v - before[k] for k, v in k2_counts().items()}
        if got != want:
            raise RuntimeError(f"a {z}-slice patient of {p} patches "
                               f"launched {got}, not {want}")
        lines.append(f"{z}: {p} patches")
    return ("path: every norm on K2's 3-D route, "
            f"{config['path']['norms_per_forward']} a forward of up to "
            f"{config['patch_batch']} patches, held on " + ", ".join(lines))


def seg_numbers(logits, labels: np.ndarray, hu: np.ndarray, spacing,
                params, plan, device, fp8: bool = False) -> dict:
    """A patient's program logits (on the card) and series labels against
    the reference's."""
    want_logits, want_labels = ref.segment(
        torch.from_numpy(hu).to(device), spacing, params, plan, fp8=fp8)
    if logits is None or tuple(logits.shape) != tuple(want_logits.shape) \
            or labels.shape != hu.shape:
        return {"logit_rel_l2": float("inf"),
                "label_disagree_pct": float("inf")}
    got = torch.from_numpy(labels).to(device).long()
    return {"logit_rel_l2": float((logits.float() - want_logits).norm()
                                  / want_logits.norm()),
            "label_disagree_pct": 100.0 * float(
                (got != want_labels).float().mean())}


def run(ctx) -> Outcome:
    config, traffic, dev = ctx.config, ctx.traffic, torch.device(ctx.device)
    plan, spacing = config["network"], traffic["spacing_mm"]
    parts = Parts(ctx.t0)
    import ducosy_tpu_torch.infer.segment  # noqa: F401
    from ducosy_tpu_torch.ops.kernels import _build

    parts.mark("import")
    if dev.type == "cuda":
        _build.build_all(config["path"]["kernels"])
        for name in config["path"]["kernels"]:
            _build.load_library(name)
        torch.backends.cudnn.benchmark = config["path"]["cudnn_benchmark"]
    parts.mark("kernel load")
    segmenter = make_segmenter(config, ctx.seed, dev)
    parts.mark("weights")
    vol = make_volume(traffic, ctx.seed, dev)
    sizes = traffic["sizes"]
    parts.mark("inputs")
    if ctx.check_path:
        log(check_path(segmenter, config, traffic, vol))
    else:
        for z in dict.fromkeys(sizes):
            segmenter.download(segmenter.segment_async(vol[:z], spacing))
    parts.mark("warm-up")
    log(parts.line())

    want = sample_sizes(dict.fromkeys(sizes), traffic["sample"], ctx.seed)
    kept, lat, slices, failed = {}, [], 0, 0
    count0 = counters() or {}

    def finish(item):
        nonlocal failed
        i, z, t_launch, out = item
        arr = segmenter.download(out)
        lat.append(time.perf_counter() - t_launch)
        if arr.dtype != np.uint8 or arr.shape != (z, *vol.shape[1:]):
            failed += 1
        if z in kept and kept[z][0] == i:
            kept[z] = (i, kept[z][1], arr)

    sync(dev)
    t_start = time.perf_counter()
    i, prev = 0, None
    while time.perf_counter() - t_start < ctx.seconds:
        z = sizes[i % len(sizes)]
        keep = z in want and z not in kept
        t_launch = time.perf_counter()
        out = segmenter.segment_async(vol[:z], spacing, logits=keep)
        if keep:
            kept[z] = (i, out.logits, None)
        if prev is not None:
            finish(prev)
        prev = (i, z, t_launch, out)
        slices += z
        i += 1
    finish(prev)
    window_s = time.perf_counter() - t_start
    count1 = counters() or {}
    patches = count1.get("seg.patches", 0) - count0.get("seg.patches", 0)

    profile, seg_launches, bound_bytes = None, 0, 0.0
    if ctx.trace:
        before = k2_counts()["instance_norm3d"]
        with Segment(dev) as seg:
            prev = None
            for j in range(traffic["profile_patients"]):
                z = sizes[(i + j) % len(sizes)]
                with span("launch", True):
                    out = segmenter.segment_async(vol[:z], spacing)
                if prev is not None:
                    with span("download", True):
                        segmenter.download(prev)
                prev = out
                p = ref.patches((z, *vol.shape[1:]), spacing, plan)
                bound_bytes += sum(norm_bytes(plan, b) for b in forwards(
                    p, config["patch_batch"]))
            with span("download", True):
                segmenter.download(prev)
        profile = seg.profile
        seg_launches = k2_counts()["instance_norm3d"] - before

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"window: {i} patients, {slices} slices, {patches} patches in "
        f"{window_s:.3f} s")
    del segmenter, prev, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    missing = [z for z in want if z not in kept or kept[z][2] is None]
    if missing:
        raise RuntimeError(f"the window served no patient of sizes {missing}")
    params = nnunet_weights(config, inputs.derive(ctx.seed, TAG_NET), dev)
    worst = {}
    t_ref = time.perf_counter()
    for z in want:
        nums = seg_numbers(kept[z][1], kept[z][2], vol[:z], spacing, params,
                           plan, dev)
        worst = {k: max(worst.get(k, 0.0), v) for k, v in nums.items()}
    log(f"reference: {len(want)} patients {want} in "
        f"{time.perf_counter() - t_ref:.1f} s; {worst}")
    lim = config["limits"]
    e2e = {"setup_s": t_start - ctx.t0,
           "serve_slices_per_s": slices / window_s}
    window = {"seconds": window_s, "slices": slices, "patients": i,
              "patches": patches if "seg.patches" in count1 else None,
              "latency_median_s": statistics.median(lat)}
    extra = {"in3d_launches": seg_launches, "in3d_bound_bytes": bound_bytes}
    return Outcome(e2e, i, failed, peak,
                   Reading(config, traffic, window, profile, extra),
                   [(k, worst[k], lim[k]) for k in lim])
