"""nmodel (3-D U-Net difference-map) training loop, on the card.

The port of ducosy_tpu/train/nmodel_loop.py. The reference ships the nmodel
config/dataset/inference but no committed trainer (the config documents its
recipe: L1 loss, Adam 5e-5, clip 1.0 — modules/nmodel/config.py:26-38).
One step: L1 x ``l1_weight``, then global-norm clipping exactly as optax's
``clip_by_global_norm`` (g * c / ||g|| where ||g|| >= c, no epsilon in the
norm, unlike ``torch.nn.utils.clip_grad_norm_``), then Adam at
``learning_rate`` (optax's defaults). BatchNorm keeps flax's running
statistics (``models/unet3d.BatchNorm``). The epoch order, ``max_steps`` /
``max_epochs`` and the metrics JSONL keys are the JAX loop's.

Checkpoints: ``<output>/checkpoints/nmodel_latest.pth`` each epoch and
``nmodel_best.pth`` on validation L1, state dicts in the reference's layout
(the JAX loop writes ``.npz`` of its variables). This package's
``load_model`` and the JAX package's both read them.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ducosy_tpu_torch.device import require_cuda
from ducosy_tpu_torch.models.nmodel_data import CTDiffDataset, NModelConfig
from ducosy_tpu_torch.models.unet3d import UNet3D, UNet3DLight
from ducosy_tpu_torch.utils.logging import MetricsLogger


def build_nmodel(cfg: NModelConfig) -> nn.Module:
    cls = UNet3D if cfg.model_type == "standard" else UNet3DLight
    return cls(n_channels=cfg.in_channels, n_classes=cfg.out_channels,
               base_channels=cfg.base_channels)


def _ncdhw(x) -> torch.Tensor:
    """A (B, D, H, W, C) batch array (the dataset's layout) -> NCDHW."""
    return torch.as_tensor(x).permute(0, 4, 1, 2, 3)


def make_nmodel_step(model: nn.Module, cfg: NModelConfig):
    """(optimizer, step, eval_step) for ``model`` on its device, in fp32.
    ``step(batch)`` trains ``model`` and the optimizer in place and returns
    the loss; ``eval_step(batch)`` the eval-mode L1. A batch is {"vue",
    "diff"} of (B, D, H, W, 1) arrays."""
    dev = next(model.parameters()).device
    opt = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    clip = float(cfg.gradient_clip_value)

    def forward(batch):
        x = _ncdhw(batch["vue"]).to(dev, torch.float32)
        y = _ncdhw(batch["diff"]).to(dev, torch.float32)
        return torch.mean(torch.abs(model(x) - y))

    def step(batch) -> torch.Tensor:
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = cfg.l1_weight * forward(batch)
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < clip
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * clip))
        opt.step()
        return loss.detach()

    def eval_step(batch) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            return forward(batch)

    return opt, step, eval_step


def save_nmodel_pth(path: str, model: nn.Module) -> None:
    """The module's state dict on the CPU, in the reference's layout."""
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)


def train_nmodel(cfg: NModelConfig, *, max_epochs: Optional[int] = None,
                 max_steps: Optional[int] = None,
                 device: str | torch.device = "cuda") -> Dict[str, float]:
    """Train on ``cfg.data_dir`` in fp32 (the card unless the caller names
    the CPU); returns {"val_l1", "best_val_l1", "epochs_run"} as the JAX
    loop. The JAX loop's ``dtype`` (its compute dtype, which no caller
    sets) is not ported."""
    dev = require_cuda(device)
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    cfg.save(os.path.join(cfg.output_dir, "nmodel_config.json"))

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_nmodel(cfg)
    model = model.to(dev)
    _opt, step, eval_step = make_nmodel_step(model, cfg)

    train_ds = CTDiffDataset(cfg.data_dir, "train", val_size=cfg.val_size,
                             use_patches=cfg.use_patches,
                             patch_size=cfg.patch_size,
                             patches_per_volume=cfg.patches_per_volume)
    val_ds = CTDiffDataset(cfg.data_dir, "val", val_size=cfg.val_size,
                           use_patches=cfg.use_patches,
                           patch_size=cfg.patch_size,
                           patches_per_volume=cfg.patches_per_volume)

    logger = MetricsLogger(os.path.join(cfg.output_dir, "nmodel_metrics.jsonl"))
    best_val = float("inf")
    epochs = min(cfg.num_epochs, max_epochs or cfg.num_epochs)
    val_loss = float("nan")
    for epoch in range(epochs):
        order = np.random.default_rng(epoch).permutation(len(train_ds))
        losses = []
        for i in range(0, len(order), cfg.batch_size):
            if max_steps and len(losses) >= max_steps:
                break
            idx = order[i:i + cfg.batch_size]
            if len(idx) < cfg.batch_size:
                break
            samples = [train_ds[int(j)] for j in idx]
            batch = {k: np.stack([s[k] for s in samples])
                     for k in samples[0]}
            losses.append(step(batch))
        losses = [float(x) for x in losses]

        vals = []
        for j in range(min(len(val_ds), max_steps or len(val_ds))):
            s = val_ds[j]
            vals.append(eval_step({k: v[None] for k, v in s.items()}))
        val_loss = float(np.mean([float(v) for v in vals])) if vals \
            else float("nan")
        logger.log({"epoch": epoch + 1,
                    "train_l1": float(np.mean(losses)) if losses else None,
                    "val_l1": val_loss}, force_print=True)

        save_nmodel_pth(os.path.join(cfg.checkpoint_dir, "nmodel_latest.pth"),
                        model)
        if np.isfinite(val_loss) and val_loss < best_val:
            best_val = val_loss
            save_nmodel_pth(
                os.path.join(cfg.checkpoint_dir, "nmodel_best.pth"), model)
    logger.close()
    return {"val_l1": val_loss, "best_val_l1": best_val,
            "epochs_run": epochs}
