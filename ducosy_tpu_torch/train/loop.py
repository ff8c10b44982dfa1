"""The training loop for one HU-range CycleGAN on one card
(ducosy_tpu/train/loop.py:88-341; reference modules/trainer.py:297-597).

It keeps the reference's run: the seeded patient-level 80/20 split, the
host loader, the per-epoch lr, the non-finite-loss guard, the per-epoch
validation (GAN + cycle + identity) with the [A | fake_B | B] image grid,
best/last/epoch generator snapshots and the full checkpoint with resume
(from the port's own checkpoint or the reference's checkpoint.pth.tar).
``remat="auto"`` runs without rematerialization until a step runs out of
device memory, then retries that step, and runs all later ones, with
rematerialized generator forwards and loss terms. The JAX loop's mesh and multi-host
paths are not ported: the port trains on one card.

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
from ducosy_tpu_torch.train import checkpoint as ckpt
from ducosy_tpu_torch.train.schedule import lr_for_epoch
from ducosy_tpu_torch.train.state import create_state
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
    device memory."""
    if target_range not in RANGES and range_cfg is None:
        raise ValueError("target_range must be either 'soft_tissue' or 'lung'")
    range_cfg = range_cfg or RANGES[target_range]
    dev = require_cuda(device)
    cuda = dev.type == "cuda"

    training_dir = os.path.join(cfg.training_dir, target_range)
    images_dir = os.path.join(training_dir, "images")
    saved_models_dir = os.path.join(training_dir, "saved_models")
    os.makedirs(images_dir, exist_ok=True)
    os.makedirs(saved_models_dir, exist_ok=True)

    state = create_state(cfg, range_cfg, model_cfg, device=dev, trunk=trunk)
    start_epoch = 0
    best = ckpt.BestTracker(saved_models_dir)
    if cfg.resume:
        cand = _resolve_resume(cfg.resume, saved_models_dir)
        if _restore(cand, state):
            start_epoch = state.epoch + 1
            best.best_val, best.best_epoch = state.best_val_loss, \
                state.best_epoch
            print(f"=> resumed from epoch {start_epoch}")
        else:
            print(f"=> no checkpoint at {cand}, training from scratch")

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
                        seed=cfg.split_seed, num_workers=cfg.num_workers)
    val_loader = HostLoader(val_ds, cfg.batch_size * 2, shuffle=False,
                            num_workers=cfg.num_workers) if len(val_ds) else None
    fixed_val_batch = next(iter(val_loader)) if val_loader else None
    print(f"Train/Val split: {len(train_ds)} / {len(val_ds)} slices")

    remat_active = cfg.remat == "on"
    train_step = make_train_step(cfg, loss_cfg, remat=remat_active)
    # wrap-padded final batches carry a "weight" vector and need a step
    # built with the real-sample count (exact ragged semantics)
    final_steps: Dict[int, object] = {}

    def step_for(host_batch):
        if "weight" not in host_batch:
            return train_step
        n_real = loader.final_n_real
        if n_real not in final_steps:
            final_steps[n_real] = make_train_step(
                cfg, loss_cfg, remat=remat_active, n_real=n_real)
        return final_steps[n_real]

    logger = MetricsLogger(os.path.join(training_dir, "metrics.jsonl"))
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
            if cfg.profile_dir and epoch == start_epoch:
                if step_idx == cfg.profile_start:
                    profiler = torch.profiler.profile()
                    profiler.start()
                elif step_idx == cfg.profile_stop and profiler is not None:
                    profiler = _export_trace(profiler, cfg.profile_dir)
            t0 = time.perf_counter()
            batch = _to_device(host_batch, dev)
            step_fn = step_for(host_batch)
            try:
                metrics = step_fn(state, batch)
                oom = False
            except torch.cuda.OutOfMemoryError:
                # a step that ran out of memory before its optimizers
                # started left the state as it was: retry it with remat
                if cfg.remat != "auto" or remat_active or step_fn.updating:
                    raise
                oom = True
            if oom:   # outside the handler, so the failed graph is freed
                print(OOM_MESSAGE)
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
                if not all(np.isfinite(v) for v in last_metrics.values()):
                    ckpt.save_checkpoint(
                        os.path.join(saved_models_dir, "checkpoint_nan.pt"),
                        state)
                    logger.log({"epoch": epoch + 1, "step": step_idx,
                                "event": "non_finite_loss", **last_metrics},
                               force_print=True)
                    raise FloatingPointError(
                        f"non-finite loss at epoch {epoch + 1} step "
                        f"{step_idx}: {last_metrics} (state saved to "
                        "checkpoint_nan.pt)")
                logger.log({"epoch": epoch + 1, "step": step_idx, "lr": lr,
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
                loss, _ = val_step(state, _to_device(host_batch, dev), cfg)
                total += float(loss)
                n_batches += 1
            val_loss = total / max(n_batches, 1)
            _, fake_b = val_step(state, _to_device(fixed_val_batch, dev), cfg)
            win = lambda x: apply_windowing(
                torch.as_tensor(x).float().cpu(), range_cfg.hu_min,
                range_cfg.hu_max, range_cfg.window_center,
                range_cfg.window_width).numpy()
            save_comparison_grid(
                os.path.join(images_dir, f"epoch_{epoch + 1}.jpg"),
                win(fixed_val_batch["a"]), win(fake_b), win(fixed_val_batch["b"]))

        # ---- snapshots + full checkpoint (trainer.py:549-597)
        if val_loader is not None and np.isfinite(val_loss):
            if best.update(epoch + 1, val_loss, state.g_a2b, state.g_b2a):
                print(f"new best epoch {epoch + 1}: val={val_loss:.4f}")
        ckpt.save_epoch_snapshots(saved_models_dir, epoch + 1, state.g_a2b,
                                  state.g_b2a, keep=cfg.checkpoint_keep)
        state.epoch = epoch
        state.best_val_loss, state.best_epoch = best.best_val, best.best_epoch
        ckpt.save_checkpoint(os.path.join(saved_models_dir, ckpt.CHECKPOINT),
                             state)
        logger.log({"epoch": epoch + 1, "val_loss": val_loss, "lr": lr,
                    **{f"train_{k}": v for k, v in last_metrics.items()}},
                   force_print=True)

    logger.close()
    return {"val_loss": val_loss, "best_val_loss": best.best_val,
            "best_epoch": best.best_epoch, "epochs_run": epochs - start_epoch,
            **last_metrics, "remat": "on" if remat_active else "off",
            "oom_fallback": oom_fallback,
            "step_seconds": step_seconds, "first_metrics": first_metrics,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)
            if cuda else None}
