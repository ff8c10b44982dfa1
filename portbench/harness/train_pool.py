"""Training driver: the CycleGAN step of the training CLI, fed from a pool
of batches resident on the card and dispatched ahead.

Set-up builds the step as ``train_cycle_gan`` does (``sp_row``,
``step_forward``, ``create_state``, ``make_train_step``, remat "auto": no
remat until a step runs out of memory, then remat, as the loop falls back)
on weights made from the seed, and drives that same object through its
first steps with the window's own call and feed; the first
``checked_steps`` are what the reference follows. The window then enqueues
steps back to back over the pool: no synchronize, no upload, no read of a
device value between steps; the losses stay on the card until it closes.

Traffic file keys: ``batch``, ``batches`` (distinct batches in the pool,
every row a different slice), ``warmup_steps`` (steps before the window,
the checked ones among them), ``checked_steps``, ``dispatch_probe_steps``
(steps each timed alone on an idle card, after the warm-up),
``profile_steps`` (steps in the traced segment, after the window).
"""
from __future__ import annotations

import gc
import statistics
import time

import torch

from portbench.harness import inputs
from portbench.harness.common import Outcome, Parts, Reading, log, sync
from portbench.harness.trace import Segment, span

NETS = ("g_a2b", "g_b2a", "d_a", "d_b")
TAG_NET = {"g_a2b": 3, "g_b2a": 4, "d_a": 5, "d_b": 6}
TAG_A, TAG_B, TAG_GEOM = 30, 31, 32


def init_weights(config: dict, seed: int, device) -> dict:
    """The four networks' weights from ``seed``: {net: state dict}."""
    gen, disc = config["generator"], config["discriminator"]
    out = {n: inputs.generator_weights(gen, gen["input_channels"],
                                       inputs.derive(seed, TAG_NET[n]),
                                       device) for n in NETS[:2]}
    out.update({n: inputs.discriminator_weights(
        disc, inputs.derive(seed, TAG_NET[n]), device) for n in NETS[2:]})
    return out


def make_pool(config: dict, traffic: dict, seed: int, device) -> list:
    """``batches`` batches of ``batch`` NCCT/CECT slice pairs as the host
    loader hands them to the step: "a", "b" (N, S, S, 1) and "masks"
    (N, S, S, M) float32, the range's window and soft squeeze applied, the
    masks (in the range's order) from the phantom's own geometry. Every row
    is a slice of its own anatomy (registered NCCT and CECT share it)."""
    b, s = traffic["batch"], config["img_size"]
    z = b * traffic["batches"]
    win = config["window"]
    geom = inputs.slice_geometry(z, device, inputs.derive(seed, TAG_GEOM))
    a, bb = (inputs.soft_squeeze(
        inputs.phantom_hu(z, s, inputs.derive(seed, tag), device,
                          contrast=tag == TAG_B, geometry=geom),
        win["hu_min"], win["hu_max"])[..., None] for tag in (TAG_A, TAG_B))
    masks = inputs.phantom_masks(z, s, device, geom)
    m = torch.stack([masks[t] for t in config["mask_types"]], dim=-1).float()
    return [{"a": a[k:k + b], "b": bb[k:k + b], "masks": m[k:k + b]}
            for k in range(0, z, b)]


class Trainer:
    """The program's state and step, built as the training loop builds
    them, with the loop's out-of-memory fall-back to remat."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from ducosy_tpu_torch.config import (RANGES, LossConfig, ModelConfig,
                                             TrainConfig)
        from ducosy_tpu_torch.train.loop import sp_row, step_forward
        from ducosy_tpu_torch.train.state import create_state

        gen, opt = config["generator"], config["optimizer"]
        self.cfg = TrainConfig(
            batch_size=traffic["batch"], img_size=config["img_size"],
            compute_dtype=config["compute_dtype"], lr=opt["lr"],
            adam_b1=opt["betas"][0], adam_b2=opt["betas"][1],
            remat=config["path"]["remat"])
        self.model_cfg = ModelConfig(
            num_residual_blocks=gen["num_residual_blocks"],
            base_channels=gen["base_channels"],
            cbam_reduction=gen["cbam_reduction"],
            cbam_spatial_kernel=gen["cbam_spatial_kernel"],
            disc_base_channels=config["discriminator"]["base_channels"])
        self.loss_cfg = LossConfig()
        range_cfg = RANGES[config["range"]]
        if range_cfg.input_channels != gen["input_channels"]:
            raise ValueError(f"range {config['range']} takes "
                             f"{range_cfg.input_channels} channels")
        self.device, self.sp, trunk = sp_row(device, "auto")
        self.forward = step_forward(self.cfg, self.model_cfg, "auto",
                                    self.device)
        self.weights = init_weights(config, seed, self.device)
        self.state = create_state(
            self.cfg, range_cfg, self.model_cfg, device=self.device,
            trunk=trunk, state_dicts={n: {k: v.cpu() for k, v in w.items()}
                                      for n, w in self.weights.items()})
        self.remat = self.cfg.remat == "on"
        self.step = self._build()

    def _build(self):
        from ducosy_tpu_torch.train.step import make_train_step

        return make_train_step(self.cfg, self.loss_cfg, remat=self.remat,
                               gen_forward=self.forward,
                               sp_devices=self.sp)

    def __call__(self, batch: dict) -> dict:
        try:
            return self.step(self.state, batch)
        except torch.cuda.OutOfMemoryError:
            if self.remat or self.cfg.remat != "auto" or self.step.updating:
                raise
        torch.cuda.empty_cache()
        self.remat = True
        self.step = self._build()
        return self.step(self.state, batch)

    def named_leaves(self):
        s = self.state
        opts = {"g_a2b": s.opt_g, "g_b2a": s.opt_g, "d_a": s.opt_d_a,
                "d_b": s.opt_d_b}
        return [(f"{n}/{k}", p, opts[n]) for n in NETS
                for k, p in getattr(s, n).named_parameters()]

    def first_gradients(self) -> dict:
        """Each leaf's gradient norm of the first step as its optimizer got
        it: Adam's first moment after one step is (1 - beta1) g; a leaf the
        optimizer holds no moment of got none."""
        b1 = self.cfg.adam_b1
        zero = torch.zeros((), device=self.device)
        return _floats({n: opt.state[p].get("exp_avg", zero).norm() / (1 - b1)
                        for n, p, opt in self.named_leaves()})

    def changes(self) -> dict:
        """Each leaf's norm of its change from the seeded weights."""
        init = {f"{n}/{k}": v for n, w in self.weights.items()
                for k, v in w.items()}
        return _floats({n: (p.detach() - init[n]).norm()
                        for n, p, _ in self.named_leaves()})


def _floats(tensors: dict) -> dict:
    vals = torch.stack(list(tensors.values())).tolist()
    return dict(zip(tensors, vals))


def kernel_counts() -> dict:
    from ducosy_tpu_torch.ops.kernels import block_tail as k4
    from ducosy_tpu_torch.ops.kernels import instance_norm as k2

    return {"instance_norm": k2.instance_norm.launches,
            "instance_norm_bwd": k2.instance_norm_bwd.launches,
            "block_tail": k4.block_tail.launches,
            "block_tail_bwd": k4.block_tail_bwd.launches}


def launches_wanted(config: dict, remat: bool) -> dict:
    """Kernel launches of one step: each of the six generator forwards
    launches K2 and K4 once a block (twice under remat, whose backward
    runs the forward again), each backward K3 and K5 once a block."""
    per = 6 * config["generator"]["num_residual_blocks"]
    twice = 2 if remat else 1
    return {"instance_norm": per * twice, "instance_norm_bwd": per,
            "block_tail": per * twice, "block_tail_bwd": per}


def first_steps(trainer: Trainer, pool: list, n: int, path_of=None) -> dict:
    """Steps 1..n through the window's call on pool batches 0..n-1: their
    losses, the first gradients (after step 1) and the changes (after step
    n, before any later step). With ``path_of`` (the configuration) each
    step's kernel launches are held to what it asks for."""
    losses, grads = [], None
    for k in range(n):
        before = kernel_counts() if path_of else None
        out = trainer(pool[k])
        if path_of:
            got = {key: v - before[key] for key, v in kernel_counts().items()}
            want = launches_wanted(path_of, trainer.remat)
            if got != want:
                raise RuntimeError(f"step {k + 1} launched {got}, the "
                                   f"{trainer.forward} step asks for {want}")
        losses.append((out["loss_G"], out["loss_D"]))
        if k == 0:
            grads = trainer.first_gradients()
    return {"losses": [tuple(float(v) for v in pair) for pair in losses],
            "grads": grads, "changes": trainer.changes()}


def reference_steps(config: dict, traffic: dict, seed: int, device, n: int,
                    conv=None) -> dict:
    """The plain float32 step (TF32 off) from the same seed, on the same
    first n batches: the readings ``first_steps`` takes."""
    from portbench.reference.cyclegan import CycleGAN

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    weights = init_weights(config, seed, device)
    pool = make_pool(config, traffic, seed, device)[:n]
    model = CycleGAN(weights, **({"conv": conv} if conv else {}))
    init = {name: leaf.detach().clone() for name, leaf in model.leaves()}
    losses, grads = [], None
    for k, batch in enumerate(pool):
        nchw = lambda t: t.permute(0, 3, 1, 2).contiguous()
        out = model.step(nchw(batch["a"]), nchw(batch["b"]),
                         nchw(batch["masks"]))
        losses.append((float(out["loss_G"]), float(out["loss_D"])))
        if k == 0:
            grads = _floats({name: g.norm() for name, g in
                             out["grads"].items()})
    changes = _floats({name: (leaf.detach() - init[name]).norm()
                       for name, leaf in model.leaves()})
    return {"losses": losses, "grads": grads, "changes": changes}


def train_numbers(prog: dict, ref: dict, moved_share: float) -> dict:
    """The gaps between the program's readings and the reference's.

    Leaves whose reference gradient is under ``moved_share`` of the median
    leaf's are left out: their true gradient is nought (a conv bias before
    an InstanceNorm), so the program's is round-off and Adam moves them by
    round-off alone. Of the others, a leaf's gap of norms is taken against
    the reference's norm of that leaf or of the median leaf, whichever is
    larger, and:
      loss_gap    the first step's |loss_G gap| + |loss_D gap| over the
                  reference's loss_G + loss_D (the later steps' losses carry
                  the noise of Adam's sign-like first updates);
      grad_gap    the median leaf's gap of first-gradient norms (a worst
                  leaf is one of the 98-weight CBAM spatial gates, whose
                  gradient swings with the max-pool's argmax, or the stem,
                  whose gradient along a constant input cancels in exact
                  arithmetic and not in bf16);
      update_gap  the worst leaf's gap of change norms after the checked
                  steps.
    The largest relative loss gap of each checked step rides beside them."""
    med_g = statistics.median(ref["grads"].values())
    moved = [n for n, g in ref["grads"].items() if g >= moved_share * med_g]
    (pg, pd), (rg, rd) = prog["losses"][0], ref["losses"][0]
    med_c = statistics.median(ref["changes"][n] for n in moved)
    return {
        "loss_gap": (abs(pg - rg) + abs(pd - rd)) / (abs(rg) + abs(rd)),
        "grad_gap": statistics.median(
            abs(prog["grads"][n] - ref["grads"][n]) / max(ref["grads"][n],
                                                          med_g)
            for n in moved),
        "update_gap": max(abs(prog["changes"][n] - ref["changes"][n])
                          / max(ref["changes"][n], med_c) for n in moved),
        "step_loss_gaps": [max(abs(p - r) / abs(r) for p, r in zip(ps, rs))
                           for ps, rs in zip(prog["losses"], ref["losses"])],
        "leaves_compared": len(moved)}


def run_window(call, pool: list, first: int, seconds: float, device):
    """Steps enqueued back to back over the pool from batch ``first`` until
    ``seconds`` have passed on the host clock, between two synchronizes:
    (the steps' outputs, untouched, and the window's seconds)."""
    sync(device)
    t0 = time.perf_counter()
    outs = []
    while time.perf_counter() - t0 < seconds:
        outs.append(call(pool[(first + len(outs)) % len(pool)]))
    sync(device)
    return outs, time.perf_counter() - t0


def run(ctx) -> Outcome:
    config, traffic, dev = ctx.config, ctx.traffic, torch.device(ctx.device)
    path = config["path"]
    parts = Parts(ctx.t0)
    import ducosy_tpu_torch.train.loop  # noqa: F401
    import ducosy_tpu_torch.train.step  # noqa: F401
    from ducosy_tpu_torch.ops.kernels import _build

    parts.mark("import")
    if dev.type == "cuda":
        _build.build_all(path["kernels"])
        for name in path["kernels"]:
            _build.load_library(name)
        torch.backends.cudnn.benchmark = path["cudnn_benchmark"]
    parts.mark("kernel load")
    trainer = Trainer(config, traffic, ctx.seed, dev)
    parts.mark("weights")
    pool = make_pool(config, traffic, ctx.seed, dev)
    parts.mark("inputs")
    if ctx.check_path and trainer.forward != path["gen_forward"]:
        raise RuntimeError(f"the step resolved the {trainer.forward} "
                           f"forward, not {path['gen_forward']}")
    n_checked = traffic["checked_steps"]
    prog = first_steps(trainer, pool, n_checked,
                       config if ctx.check_path else None)
    del trainer.weights
    done = n_checked
    while done < traffic["warmup_steps"]:
        trainer(pool[done % len(pool)])
        done += 1
    probe = []
    for _ in range(traffic["dispatch_probe_steps"]):
        sync(dev)
        t = time.perf_counter()
        trainer(pool[done % len(pool)])
        probe.append(time.perf_counter() - t)
        done += 1
    sync(dev)
    parts.mark("warm-up")
    log(parts.line())
    log(f"path: gen_forward {trainer.forward}, remat "
        f"{'on' if trainer.remat else 'off'} (setting "
        f"{trainer.cfg.remat}), cudnn.benchmark "
        f"{torch.backends.cudnn.benchmark}, K2-K5 a step "
        f"{launches_wanted(config, trainer.remat)} held on steps 1-"
        f"{n_checked}")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_start = time.perf_counter()
    outs, window_s = run_window(trainer, pool, done, ctx.seconds, dev)
    steps = len(outs)
    done += steps
    window_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    finite = torch.stack([torch.stack([o["loss_G"], o["loss_D"]])
                          for o in outs]).isfinite().all(dim=1).tolist()
    failed = finite.count(False)

    profile, k5_calls = None, 0
    if ctx.trace:
        k5_before = kernel_counts()["block_tail_bwd"]
        with Segment(dev) as seg:
            for _ in range(traffic["profile_steps"]):
                with span("step_call", True):
                    trainer(pool[done % len(pool)])
                done += 1
        profile = seg.profile
        k5_calls = kernel_counts()["block_tail_bwd"] - k5_before

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"window: {steps} steps in {window_s:.3f} s, {failed} with a "
        f"non-finite loss; remat {'on' if trainer.remat else 'off'}")
    remat = trainer.remat
    del trainer, pool, outs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_steps(config, traffic, ctx.seed, dev, n_checked)
    nums = train_numbers(prog, ref, config["moved_share"])
    log(f"reference: {n_checked} steps in {time.perf_counter() - t_ref:.1f}"
        f" s; program losses {prog['losses']}, reference {ref['losses']}; "
        f"{nums['leaves_compared']} of {len(ref['grads'])} leaves moved")
    lim = config["limits"]
    gen = config["generator"]
    window = {"seconds": window_s, "steps": steps}
    extra = {"host_dispatch_s": statistics.median(probe),
             "window_peak_bytes": window_peak, "k5_calls": k5_calls,
             "k5_shape": (traffic["batch"], config["img_size"] // 4,
                          4 * gen["base_channels"]), "remat": remat}
    return Outcome({"setup_s": t_start - ctx.t0,
                    "train_step_s": window_s / steps}, steps, failed, peak,
                   Reading(config, traffic, window, profile, extra),
                   [(k, nums[k], lim[k]) for k in lim])
