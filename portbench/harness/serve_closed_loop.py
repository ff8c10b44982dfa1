"""Serving driver: one client in a closed loop through the engine that the
generate CLI builds, in the CLI's order (launch patient i, then download
patient i - 1; ducosy_tpu_torch/cli/generate.py ``run_fast_pipeline``),
DICOM decode and write left out.

Traffic file keys: ``sizes`` (slices of the patients, cycled in order),
``chunk`` (slices a forward, the CLI's ``--slice_batch``), ``sample``
(patients compared with the reference after the window: the longest and
others drawn from the seed), ``profile_patients`` (patients in the traced
segment, after the window). Each patient is the leading slices of one
seeded phantom volume of the largest size, int16, slope and intercept of
the configuration's ``rescale``.

The window opens at a synchronize, launches no patient after ``seconds``,
and closes when the last patient launched in it has been downloaded. A
patient's latency runs from the call that launches it to the end of its
download.
"""
from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from portbench.harness import inputs
from portbench.harness.common import Outcome, Parts, Reading, log, sync
from portbench.harness.trace import Segment, span

TAG_ST, TAG_LUNG, TAG_VOLUME, TAG_SAMPLE, TAG_PRIORITY = 1, 2, 20, 21, 22


def generator_pair(config: dict, seed: int, device):
    """The soft-tissue and lung generators' weights made from ``seed``."""
    gen = config["generator"]
    return [inputs.generator_weights(gen, gen["input_channels"],
                                     inputs.derive(seed, t), device)
            for t in (TAG_ST, TAG_LUNG)]


def make_engine(config: dict, seed: int, device, quant=None):
    """The generate CLI's engine (no forward or trunk named) on weights made
    from ``seed``; ``quant`` switches on the program's int8 path (the
    control)."""
    from ducosy_tpu_torch.infer.engine import DualGeneratorEngine

    st, lung = generator_pair(config, seed, device)
    return DualGeneratorEngine(st, lung, img_size=config["img_size"],
                               compute_dtype=getattr(
                                   torch, config["compute_dtype"]),
                               device=device, quant=quant)


def make_volume(config: dict, traffic: dict, seed: int, device) -> np.ndarray:
    hu = inputs.phantom_hu(max(traffic["sizes"]), config["img_size"],
                           inputs.derive(seed, TAG_VOLUME), device)
    return inputs.stored_int16(hu).cpu().numpy()


def launch(engine, config, traffic, vol, z):
    r = config["rescale"]
    return engine.run_patient_async(vol[:z], r["slope"], r["intercept"],
                                    chunk=traffic["chunk"])


def launch_counts() -> dict:
    from ducosy_tpu_torch.ops.kernels import instance_norm as k2
    from ducosy_tpu_torch.ops.kernels import residual_chain as k1

    return {"residual_chain": k1.residual_chain.launches,
            "instance_norm": k2.instance_norm.launches,
            "instance_norm_phased": k2.instance_norm.phase_launches}


def check_path(engine, config, traffic, vol) -> str:
    """The engine resolved to the configuration's forward and trunk, and
    one patient of each size launches the kernels its chunks ask for."""
    path = config["path"]
    got = (engine.forward_impl, engine.trunk, engine.quant)
    if got != (path["forward"], path["trunk"], None):
        raise RuntimeError(f"the engine runs {got}, not the configuration's "
                           f"({path['forward']}, {path['trunk']}, None)")
    lines = []
    for z in dict.fromkeys(traffic["sizes"]):
        before = launch_counts()
        launch(engine, config, traffic, vol, z).cpu()
        chunks = -(-z // traffic["chunk"])
        got = {k: v - before[k] for k, v in launch_counts().items()}
        want = {k: v * chunks for k, v in path["launches_per_chunk"].items()}
        if got != want:
            raise RuntimeError(f"a {z}-slice patient launched {got}, its "
                               f"{chunks} chunks ask for {want}")
        lines.append(f"{z}: {chunks} chunks")
    return (f"path: forward {engine.forward_impl}, trunk {engine.trunk}, "
            f"launches a chunk {path['launches_per_chunk']} held on "
            + ", ".join(lines))


def serve_numbers(got: np.ndarray, ref: np.ndarray, slope: float,
                  device) -> dict:
    """A served series against the reference's, in HU: the mean |difference|
    over all voxels, and the largest mean |difference| of one slice."""
    d = (torch.from_numpy(got).to(device, torch.float32)
         - torch.from_numpy(ref).to(device, torch.float32)).abs() * abs(slope)
    per_slice = d.mean(dim=(1, 2))
    return {"mean_abs_hu": float(per_slice.mean()),
            "worst_slice_hu": float(per_slice.max())}


def compare(served: dict, config: dict, traffic: dict, seed: int, device,
            conv=None) -> dict:
    """Each served series ({z: int16 array}) against the reference's, the
    worst of each number over them; a series of the wrong dtype or shape
    reads infinity."""
    from portbench.reference.serve import serve_patient

    st_w, lung_w = generator_pair(config, seed, device)
    vol = make_volume(config, traffic, seed, device)
    worst = {}
    kw = {"conv": conv} if conv else {}
    for z, got in served.items():
        ref = serve_patient(vol[:z], st_w, lung_w, config, device, **kw)
        if got.dtype != np.int16 or got.shape != ref.shape:
            nums = {k: float("inf") for k in config["limits"]}
        else:
            nums = serve_numbers(got, ref, config["rescale"]["slope"], device)
        worst = {k: max(worst.get(k, 0.0), v) for k, v in nums.items()}
    return worst


def sample_sizes(done: dict, n: int, seed: int) -> list:
    """The longest size served and n - 1 others drawn from the seed."""
    longest = max(done)
    rest = sorted(z for z in done if z != longest)
    rng = np.random.default_rng(inputs.derive(seed, TAG_SAMPLE))
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def run(ctx) -> Outcome:
    config, traffic, dev = ctx.config, ctx.traffic, torch.device(ctx.device)
    parts = Parts(ctx.t0)
    import ducosy_tpu_torch.infer.engine  # noqa: F401
    from ducosy_tpu_torch.ops.kernels import _build

    parts.mark("import")
    if dev.type == "cuda":
        libs = config["path"]["kernels"]
        _build.build_all(libs)
        for name in libs:
            _build.load_library(name)
    parts.mark("kernel load")
    engine = make_engine(config, ctx.seed, dev)
    parts.mark("weights")
    vol = make_volume(config, traffic, ctx.seed, dev)
    sizes = traffic["sizes"]
    parts.mark("inputs")
    if ctx.check_path:
        log(check_path(engine, config, traffic, vol))
    else:
        for z in dict.fromkeys(sizes):
            launch(engine, config, traffic, vol, z).cpu()
    parts.mark("warm-up")
    log(parts.line())

    # keep, for each size, the window's patient with the highest seeded
    # priority: a sample drawn from the seed, held in at most one series a
    # size
    prio = np.random.default_rng(inputs.derive(ctx.seed, TAG_PRIORITY)
                                 ).random(1 << 16)
    kept, lat, slices, failed = {}, [], 0, 0
    chunks = 0
    before = launch_counts()

    def finish(item):
        nonlocal failed
        i, z, t_launch, out = item
        arr = out.cpu().numpy()
        lat.append(time.perf_counter() - t_launch)
        if arr.dtype != np.int16 or arr.shape != (z, *vol.shape[1:]):
            failed += 1
        if z not in kept or prio[i % len(prio)] > kept[z][0]:
            kept[z] = (prio[i % len(prio)], arr)

    sync(dev)
    t_start = time.perf_counter()
    i, prev = 0, None
    while time.perf_counter() - t_start < ctx.seconds:
        z = sizes[i % len(sizes)]
        t_launch = time.perf_counter()
        out = launch(engine, config, traffic, vol, z)
        if prev is not None:
            finish(prev)
        prev = (i, z, t_launch, out)
        slices += z
        chunks += -(-z // traffic["chunk"])
        i += 1
    finish(prev)
    window_s = time.perf_counter() - t_start
    counts = {k: v - before[k] for k, v in launch_counts().items()}
    if ctx.check_path:
        want = {k: v * chunks for k, v in
                config["path"]["launches_per_chunk"].items()}
        if counts != want:
            raise RuntimeError(f"the window launched {counts}, its {chunks} "
                               f"chunks ask for {want}")

    profile, seg_calls = None, 0
    if ctx.trace:
        k1_before = launch_counts()["residual_chain"]
        with Segment(dev) as seg:
            prev = None
            for j in range(traffic["profile_patients"]):
                z = sizes[(i + j) % len(sizes)]
                with span("launch", True):
                    out = launch(engine, config, traffic, vol, z)
                if prev is not None:
                    with span("download", True):
                        prev.cpu()
                prev = out
            with span("download", True):
                prev.cpu()
        profile = seg.profile
        seg_calls = launch_counts()["residual_chain"] - k1_before

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"window: {i} patients, {slices} slices, {chunks} chunks in "
        f"{window_s:.3f} s; launches {counts}")
    del engine, prev, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    served = {z: kept[z][1] for z in sample_sizes(kept, traffic["sample"],
                                                  ctx.seed)}
    t_ref = time.perf_counter()
    worst = compare(served, config, traffic, ctx.seed, dev)
    log(f"reference: {len(served)} patients {sorted(served)} in "
        f"{time.perf_counter() - t_ref:.1f} s")
    lim = config["limits"]
    lat.sort()
    e2e = {"setup_s": t_start - ctx.t0,
           "serve_slices_per_s": slices / window_s,
           "patient_s_p90": lat[max(int(np.ceil(0.9 * len(lat))) - 1, 0)]}
    window = {"seconds": window_s, "slices": slices, "patients": i,
              "chunks": chunks, "latency_median_s": statistics.median(lat)}
    extra = {"trunk_calls": seg_calls, "chunk": traffic["chunk"]}
    return Outcome(e2e, i, failed, peak,
                   Reading(config, traffic, window, profile, extra),
                   [(k, worst[k], lim[k]) for k in lim])
