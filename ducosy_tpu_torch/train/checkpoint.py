"""Checkpoints of a training run (ducosy_tpu/train/checkpoint.py;
reference modules/trainer.py:549-597), with ``torch.save``:

  - the full state (4 networks, 3 Adam states, epoch, best-val bookkeeping)
    in ``saved_models/checkpoint.pt`` each epoch, resumable mid-run;
  - generator snapshots per epoch and ``last`` (``G_A2B_epoch_{N}.pth``,
    ``G_*_last.pth``) and best-on-val (``G_*_best_epoch_{N}.pth``, the
    previous best deleted) as state dicts in the reference ``.pth`` key
    layout, which ``Generator.from_state_dict`` and the reference's own
    tools load.

The reference's own ``checkpoint.pth.tar`` is imported by
``train/torch_resume.py`` (``--resume .../checkpoint.pth.tar``).
"""
from __future__ import annotations

import os
import re

import torch

from ducosy_tpu_torch.train.state import CycleGANState

CHECKPOINT = "checkpoint.pt"


def save_checkpoint(path: str, state: CycleGANState) -> None:
    """Atomic full-state save."""
    tmp = f"{path}.tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, state: CycleGANState) -> bool:
    """Load a full state saved by ``save_checkpoint`` into ``state`` (its
    networks and optimizers keep their devices); False if there is no file
    at path."""
    if not os.path.isfile(path):
        return False
    sd = torch.load(path, map_location="cpu", weights_only=True)
    try:
        state.load_state_dict(sd)
    except (KeyError, RuntimeError, ValueError) as e:
        raise RuntimeError(
            f"checkpoint at {path} is incompatible with the current model "
            f"configuration (did mask channels / architecture change?): {e}"
        ) from e
    return True


def save_generator_pth(path: str, gen: torch.nn.Module) -> None:
    """A generator's state dict (reference key layout, CPU tensors)."""
    torch.save({k: v.detach().to("cpu") for k, v in gen.state_dict().items()},
               path)


class BestTracker:
    """Best-val generator snapshots with previous-best deletion
    (trainer.py:555-569)."""

    def __init__(self, saved_models_dir: str):
        self.dir = saved_models_dir
        self.best_val = float("inf")
        self.best_epoch = -1

    def update(self, epoch1: int, val_loss: float, g_a2b, g_b2a, *,
               write: bool = True) -> bool:
        """Track a new best; ``write`` False keeps the bookkeeping only (the
        ranks of a data-parallel run other than rank 0)."""
        if val_loss >= self.best_val:
            return False
        if not write:
            self.best_val, self.best_epoch = val_loss, epoch1
            return True
        if self.best_epoch != -1:
            for stem in ("G_A2B", "G_B2A"):
                old = os.path.join(self.dir,
                                   f"{stem}_best_epoch_{self.best_epoch}.pth")
                if os.path.exists(old):
                    os.remove(old)
        self.best_val, self.best_epoch = val_loss, epoch1
        for stem, gen in (("G_A2B", g_a2b), ("G_B2A", g_b2a)):
            save_generator_pth(
                os.path.join(self.dir, f"{stem}_best_epoch_{epoch1}.pth"), gen)
        return True


def save_epoch_snapshots(saved_models_dir: str, epoch1: int, g_a2b, g_b2a, *,
                         keep: int = 0) -> None:
    """Per-epoch and ``last`` generator snapshots (trainer.py:572-577);
    ``keep`` > 0 keeps only the newest ``keep`` per-epoch ones."""
    for stem, gen in (("G_A2B", g_a2b), ("G_B2A", g_b2a)):
        for tag in (f"epoch_{epoch1}", "last"):
            save_generator_pth(
                os.path.join(saved_models_dir, f"{stem}_{tag}.pth"), gen)
    if keep > 0:
        pat = re.compile(r"^G_(A2B|B2A)_epoch_(\d+)\.pth$")
        epochs = sorted({int(m.group(2)) for f in os.listdir(saved_models_dir)
                         if (m := pat.match(f))}, reverse=True)
        for old in epochs[keep:]:
            for stem in ("G_A2B", "G_B2A"):
                p = os.path.join(saved_models_dir, f"{stem}_epoch_{old}.pth")
                if os.path.exists(p):
                    os.remove(p)
