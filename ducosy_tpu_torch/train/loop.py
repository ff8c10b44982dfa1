"""The training loop for one HU-range CycleGAN
(ducosy_tpu/train/loop.py:88-341; reference modules/trainer.py:297-597).

It keeps the reference's run: the seeded patient-level 80/20 split, the
host loader, the per-epoch lr, the non-finite-loss guard, the per-epoch
validation (GAN + cycle + identity) with the [A | fake_B | B] image grid,
best/last/epoch generator snapshots and the full checkpoint with resume
(from the port's own checkpoint or the reference's checkpoint.pth.tar).
``remat="auto"`` runs without rematerialization until a step runs out of
device memory, then retries that step, and runs all later ones, with
rematerialized generator forwards and loss terms.

In a process group of more than one rank (one card a rank: the training
CLI's ``--num_devices``, or torchrun's environment), each rank loads its
rows of every global batch (HostLoader's ``shard``), starts from rank 0's
state (broadcast after init and resume) and takes the data-parallel step
(``train/step.py``); the validation loss is all-reduced, weighted by real
rows, and rank 0 alone writes the metrics, the image grid, the snapshots
and the checkpoint, with a barrier at the end of each epoch. The
out-of-memory retry is decided across ranks on each step function's first
run; a rank that runs out of memory alone (the others wait in a
collective) ends the run within the process group's timeout.

Each step is followed by a device synchronize, so the summary's
``step_seconds`` are the steps' wall times.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ducosy_tpu_torch.config import LossConfig, ModelConfig, RANGES, \
    RangeConfig, TrainConfig
from ducosy_tpu_torch.data.loader import HostLoader
from ducosy_tpu_torch.data.pairing import list_patient_dirs, train_val_split
from ducosy_tpu_torch.utils.imaging import save_comparison_grid
from ducosy_tpu_torch.utils.logging import MetricsLogger, StepTimer
from ducosy_tpu_torch.data.dataset import SlicePairDataset
from ducosy_tpu_torch.device import require_cuda
from ducosy_tpu_torch.ops.hu import apply_windowing
from ducosy_tpu_torch.parallel.mesh import all_reduce_sum, any_rank, \
    barrier, process_row_slice, rank, replicate, shard_batch, world_size
from ducosy_tpu_torch.train import checkpoint as ckpt
from ducosy_tpu_torch.train.schedule import lr_for_epoch
from ducosy_tpu_torch.train.state import NETS, create_state
from ducosy_tpu_torch.train.torch_resume import import_reference_checkpoint
from ducosy_tpu_torch.train.step import make_train_step, val_step

OOM_MESSAGE = ("train step exceeded HBM; retrying with remat'd generator "
               "forwards")


def _resolve_resume(resume: str, saved_models_dir: str) -> str:
    """A bare name lives under saved_models/; a path is taken as given
    (relative ones fall back to saved_models/); ``.pt`` may be left off.
    A ``.pth.tar`` is the reference's checkpoint (``_restore`` imports
    it)."""
    cand = resume if os.path.isabs(resume) or os.sep in resume \
        else os.path.join(saved_models_dir, resume)
    if not os.path.exists(cand) and not os.path.isabs(resume):
        alt = os.path.join(saved_models_dir, resume)
        if os.path.exists(alt):
            cand = alt
    if not os.path.exists(cand) and os.path.exists(cand + ".pt"):
        cand += ".pt"
    return cand


def _restore(path: str, state) -> bool:
    """Load the checkpoint at ``path`` into ``state``: the port's own
    ``checkpoint.pt``, or the reference's ``checkpoint.pth.tar``
    (train/torch_resume.py). False if there is no file at path."""
    if not path.endswith(".pth.tar"):
        return ckpt.restore_checkpoint(path, state)
    if not os.path.isfile(path):
        return False
    import_reference_checkpoint(path, state)
    return True


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _export_trace(profiler, profile_dir: str) -> None:
    """Stop ``profiler`` and write its chrome trace to
    ``profile_dir/trace.json``; returns None, the loop's "not tracing"."""
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    trace = os.path.join(profile_dir, "trace.json")
    profiler.export_chrome_trace(trace)
    print(f"profiler trace written to {trace}")
    return None


def train_cycle_gan(cfg: TrainConfig, target_range: str,
                    model_cfg: ModelConfig = ModelConfig(),
                    loss_cfg: LossConfig = LossConfig(), *,
                    range_cfg: Optional[RangeConfig] = None,
                    device: str | torch.device = "cuda", trunk: str = "tail",
                    max_epochs: Optional[int] = None,
                    max_steps_per_epoch: Optional[int] = None
                    ) -> Dict[str, object]:
    """Train one HU-range CycleGAN; returns summary stats: the losses, the
    remat mode the run ended in (and whether it fell back to remat), each
    step's wall time, the first step's metrics and (on a card) the peak
    device memory (this rank's)."""
    if target_range not in RANGES and range_cfg is None:
        raise ValueError("target_range must be either 'soft_tissue' or 'lung'")
    range_cfg = range_cfg or RANGES[target_range]
    dev = require_cuda(device)
    cuda = dev.type == "cuda"
    world, primary = world_size(), rank() == 0
    shard = None
    if world > 1:   # raises, as the JAX loop, where the batch does not divide
        process_row_slice(world, rank(), cfg.batch_size)
        shard = (rank(), world)
    say = print if primary else (lambda *a, **k: None)

    training_dir = os.path.join(cfg.training_dir, target_range)
    images_dir = os.path.join(training_dir, "images")
    saved_models_dir = os.path.join(training_dir, "saved_models")
    os.makedirs(images_dir, exist_ok=True)
    os.makedirs(saved_models_dir, exist_ok=True)

    state = create_state(cfg, range_cfg, model_cfg, device=dev, trunk=trunk)
    start_epoch = 0
    best = ckpt.BestTracker(saved_models_dir)
    resumed = False
    if cfg.resume and primary:
        cand = _resolve_resume(cfg.resume, saved_models_dir)
        resumed = _restore(cand, state)
        if not resumed:
            print(f"=> no checkpoint at {cand}, training from scratch")
    if world > 1:
        resumed = any_rank(resumed)
        replicate(state)
    if resumed:
        start_epoch = state.epoch + 1
        best.best_val, best.best_epoch = state.best_val_loss, state.best_epoch
        say(f"=> resumed from epoch {start_epoch}")

    # ---- data (trainer.py:419-436)
    patients = list_patient_dirs(cfg.data_root, cfg.dataset_names)
    train_dirs, val_dirs = train_val_split(patients, cfg.val_split,
                                           cfg.split_seed)
    ds_kw = dict(img_size=cfg.img_size, ncct_folder=cfg.ncct_folder,
                 cect_folder=cfg.cect_folder)
    train_ds = SlicePairDataset(train_dirs, range_cfg, **ds_kw)
    val_ds = SlicePairDataset(val_dirs, range_cfg, **ds_kw)
    if len(train_ds) == 0:
        raise RuntimeError(
            f"no training slice pairs under {cfg.data_root}/{cfg.dataset_names}")
    loader = HostLoader(train_ds, cfg.batch_size, shuffle=True,
                        seed=cfg.split_seed, num_workers=cfg.num_workers,
                        shard=shard)
    val_loader = HostLoader(val_ds, cfg.batch_size * 2, shuffle=False,
                            num_workers=cfg.num_workers, shard=shard) \
        if len(val_ds) else None
    fixed_val_batch = next(iter(val_loader)) if val_loader else None
    say(f"Train/Val split: {len(train_ds)} / {len(val_ds)} slices")

    remat_active = cfg.remat == "on"
    train_step = make_train_step(cfg, loss_cfg, remat=remat_active)
    # wrap-padded final batches carry a "weight" vector and need a step
    # built with the real-sample count (exact ragged semantics)
    final_steps: Dict[int, object] = {}
    # step functions that have run once on every rank: the shapes are
    # fixed, so one that fitted once fits (remat="auto" across ranks)
    proven: set = set()

    def step_for(host_batch):
        if "weight" not in host_batch:
            return train_step
        n_real = loader.final_n_real
        if n_real not in final_steps:
            final_steps[n_real] = make_train_step(
                cfg, loss_cfg, remat=remat_active, n_real=n_real)
        return final_steps[n_real]

    logger = MetricsLogger(os.path.join(training_dir, "metrics.jsonl")) \
        if primary else None
    log = logger.log if primary else (lambda *a, **k: None)
    epochs = min(cfg.epochs, start_epoch + max_epochs) if max_epochs \
        else cfg.epochs
    last_metrics: Dict[str, float] = {}
    first_metrics: Dict[str, float] = {}
    step_seconds = []
    val_loss = float("nan")
    oom_fallback = False
    profiler = None
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    for epoch in range(start_epoch, epochs):
        lr = lr_for_epoch(cfg.lr, epoch, cfg.epochs, cfg.decay_epoch)
        state.set_learning_rate(lr)
        timer = StepTimer()

        for step_idx, host_batch in enumerate(loader):
            if max_steps_per_epoch and step_idx >= max_steps_per_epoch:
                break
            if cfg.profile_dir and epoch == start_epoch and primary:
                if step_idx == cfg.profile_start:
                    profiler = torch.profiler.profile()
                    profiler.start()
                elif step_idx == cfg.profile_stop and profiler is not None:
                    profiler = _export_trace(profiler, cfg.profile_dir)
            t0 = time.perf_counter()
            batch = _to_device(host_batch, dev)
            step_fn = step_for(host_batch)
            retry = cfg.remat == "auto" and not remat_active
            try:
                metrics = step_fn(state, batch)
                oom = False
            except torch.cuda.OutOfMemoryError:
                # a step that ran out of memory before its optimizers
                # started left the state as it was: retry it with remat
                if not retry or step_fn.updating:
                    raise
                oom = True
            if world > 1 and retry and id(step_fn) not in proven:
                oom = any_rank(oom)   # every rank retries, or none
                proven.add(id(step_fn))
            if oom:   # outside the handler, so the failed graph is freed
                say(OOM_MESSAGE)
                oom_fallback = True
                torch.cuda.empty_cache()
                remat_active = True
                train_step = make_train_step(cfg, loss_cfg, remat=True)
                final_steps.clear()
                metrics = step_for(host_batch)(state, batch)
            if cuda:
                torch.cuda.synchronize(dev)
            step_seconds.append(time.perf_counter() - t0)
            timer.tick()
            if step_idx % cfg.log_every == 0:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                first_metrics = first_metrics or dict(last_metrics)
                # the losses are the global batch's: every rank agrees
                if not all(np.isfinite(v) for v in last_metrics.values()):
                    if primary:
                        ckpt.save_checkpoint(os.path.join(
                            saved_models_dir, "checkpoint_nan.pt"), state)
                    log({"epoch": epoch + 1, "step": step_idx,
                         "event": "non_finite_loss", **last_metrics},
                        force_print=True)
                    raise FloatingPointError(
                        f"non-finite loss at epoch {epoch + 1} step "
                        f"{step_idx}: {last_metrics} (state saved to "
                        "checkpoint_nan.pt)")
                log({"epoch": epoch + 1, "step": step_idx, "lr": lr,
                     "steps_per_s": timer.rate(), **last_metrics})

        if profiler is not None:
            # the epoch ended before step profile_stop: keep what was traced
            profiler = _export_trace(profiler, cfg.profile_dir)

        # ---- validation + image grid (trainer.py:543-547)
        val_loss = float("nan")
        if val_loader is not None:
            total, n_batches = 0.0, 0
            for vb_idx, host_batch in enumerate(val_loader):
                if max_steps_per_epoch and vb_idx >= max_steps_per_epoch:
                    break
                loss = float(val_step(state, _to_device(host_batch, dev),
                                      cfg)[0])
                if world > 1:   # each term is a mean over real rows
                    rows = float(host_batch["weight"].sum()) \
                        if "weight" in host_batch else len(host_batch["a"])
                    part, real = all_reduce_sum([loss * rows if rows else 0.0,
                                                 rows])
                    loss = part / real
                total += loss
                n_batches += 1
            val_loss = total / max(n_batches, 1)
            if primary:   # the grid of rank 0's rows, as the JAX primary's
                _, fake_b = val_step(state, _to_device(fixed_val_batch, dev),
                                     cfg)
                win = lambda x: apply_windowing(
                    torch.as_tensor(x).float().cpu(), range_cfg.hu_min,
                    range_cfg.hu_max, range_cfg.window_center,
                    range_cfg.window_width).numpy()
                save_comparison_grid(
                    os.path.join(images_dir, f"epoch_{epoch + 1}.jpg"),
                    win(fixed_val_batch["a"]), win(fake_b),
                    win(fixed_val_batch["b"]))

        # ---- snapshots + full checkpoint (trainer.py:549-597)
        if val_loader is not None and np.isfinite(val_loss):
            if best.update(epoch + 1, val_loss, state.g_a2b, state.g_b2a,
                           write=primary):
                say(f"new best epoch {epoch + 1}: val={val_loss:.4f}")
        state.epoch = epoch
        state.best_val_loss, state.best_epoch = best.best_val, best.best_epoch
        if primary:   # the ranks' states are equal; one writes them
            ckpt.save_epoch_snapshots(saved_models_dir, epoch + 1,
                                      state.g_a2b, state.g_b2a,
                                      keep=cfg.checkpoint_keep)
            ckpt.save_checkpoint(
                os.path.join(saved_models_dir, ckpt.CHECKPOINT), state)
        log({"epoch": epoch + 1, "val_loss": val_loss, "lr": lr,
             **{f"train_{k}": v for k, v in last_metrics.items()}},
            force_print=True)
        barrier()   # no rank starts the next epoch before the files exist

    if primary:
        logger.close()
    return {"val_loss": val_loss, "best_val_loss": best.best_val,
            "best_epoch": best.best_epoch, "epochs_run": epochs - start_epoch,
            **last_metrics, "remat": "on" if remat_active else "off",
            "oom_fallback": oom_fallback,
            "step_seconds": step_seconds, "first_metrics": first_metrics,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)
            if cuda else None}


def _rank_spread(state) -> float:
    """max |a - b| over every parameter of two ranks' states (0 in one
    process): 0 while the ranks are in step."""
    if world_size() == 1:
        return 0.0
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1).float() for net in NETS
                      for p in getattr(state, net).parameters()])
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return float((hi - lo).max())


def run_steps(device, state_dicts, batches, cfg: TrainConfig,
              range_cfg: RangeConfig, model_cfg: ModelConfig = ModelConfig(),
              loss_cfg: LossConfig = LossConfig(), *, trunk: str = "tail",
              remat: bool = False, n_real: int | None = None) -> dict:
    """One training step per global host batch of ``batches`` from the
    networks ``state_dicts`` (keyed as NETS), on this rank's rows (all rows
    in one process): the rank worker of the data-parallel step's checks
    (``parallel.launch.spawn(run_steps, ...)``). Returns per step the
    metrics, the synchronized seconds, the launches of K2-K5 and the
    spread of the parameters across ranks; and as numpy on rank 0 (None on
    the other ranks) the first step's gradients, taken where both sides of
    a comparison hold the same parameters, and the parameters after the
    last step."""
    from ducosy_tpu_torch.ops.kernels import block_tail as k4
    from ducosy_tpu_torch.ops.kernels import instance_norm as k2

    counters = {"instance_norm": k2.instance_norm,
                "instance_norm_bwd": k2.instance_norm_bwd,
                "block_tail": k4.block_tail,
                "block_tail_bwd": k4.block_tail_bwd}
    device = torch.device(device)
    state = create_state(cfg, range_cfg, model_cfg, device=device,
                         trunk=trunk, state_dicts=state_dicts)
    step = make_train_step(cfg, loss_cfg, remat=remat, n_real=n_real)
    out: Dict[str, object] = {"metrics": [], "seconds": [], "launches": [],
                              "spread": []}
    primary = rank() == 0
    numpy = lambda get: {
        net: {name: get(p).detach().cpu().numpy()
              for name, p in getattr(state, net).named_parameters()}
        for net in NETS} if primary else None
    for host_batch in batches:
        batch = _to_device(shard_batch(host_batch), device)
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        metrics = step(state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["seconds"].append(time.perf_counter() - t0)
        out["launches"].append({k: f.launches for k, f in counters.items()})
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["spread"].append(_rank_spread(state))
        if "grads" not in out:
            out["grads"] = numpy(lambda p: p.grad)
    out["params"] = numpy(lambda p: p)
    return out
