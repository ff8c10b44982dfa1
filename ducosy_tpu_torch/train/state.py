"""Train state: 4 networks, 3 optimizers, epoch and best-val bookkeeping
(ducosy_tpu/train/state.py).

The reference's optimizer topology (modules/trainer.py:360-367): one Adam
over both generators jointly (lr 2e-4, betas (0.5, 0.999)) and one per
discriminator. ``set_learning_rate`` sets every param group's lr once per
epoch, the LambdaLR step. Parameters stay fp32; the networks compute in
``compute_dtype``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ducosy_tpu_torch.config import ModelConfig, RangeConfig, TrainConfig
from ducosy_tpu_torch.models.convert import (
    init_discriminator_state_dict,
    init_generator_state_dict,
)
from ducosy_tpu_torch.models.discriminator import Discriminator
from ducosy_tpu_torch.models.generator import Generator

NETS = ("g_a2b", "g_b2a", "d_a", "d_b")


def _compute_dtype(cfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32


@dataclass
class CycleGANState:
    """All mutable training state; ``state_dict`` is what the full
    checkpoint saves."""

    g_a2b: Generator
    g_b2a: Generator
    d_a: Discriminator
    d_b: Discriminator
    opt_g: torch.optim.Adam
    opt_d_a: torch.optim.Adam
    opt_d_b: torch.optim.Adam
    epoch: int = 0
    best_val_loss: float = math.inf
    best_epoch: int = -1

    def set_learning_rate(self, lr: float) -> None:
        """Per-epoch LambdaLR step (trainer.py:534-536)."""
        for opt in (self.opt_g, self.opt_d_a, self.opt_d_b):
            for group in opt.param_groups:
                group["lr"] = lr

    def state_dict(self) -> Dict[str, object]:
        sd = {k: getattr(self, k).state_dict() for k in NETS}
        sd.update({k: getattr(self, k).state_dict()
                   for k in ("opt_g", "opt_d_a", "opt_d_b")})
        sd.update(epoch=self.epoch, best_val_loss=self.best_val_loss,
                  best_epoch=self.best_epoch)
        return sd

    def load_state_dict(self, sd: Dict[str, object]) -> None:
        for k in NETS + ("opt_g", "opt_d_a", "opt_d_b"):
            getattr(self, k).load_state_dict(sd[k])
        self.epoch = int(sd["epoch"])
        self.best_val_loss = float(sd["best_val_loss"])
        self.best_epoch = int(sd["best_epoch"])


def resolve_trunk(trunk: str, range_cfg: RangeConfig,
                  model_cfg: ModelConfig) -> str:
    """The training trunk: "auto" is "tail", or "plain" for a range without
    CBAM or a model with ``fused_norm`` (the trunks that hold the CBAM gates
    refuse a generator without them)."""
    if trunk != "auto":
        return trunk
    return "tail" if range_cfg.use_cbam and not model_cfg.fused_norm \
        else "plain"


def build_models(range_cfg: RangeConfig, model_cfg: ModelConfig = ModelConfig(),
                 *, trunk: str = "auto", compute_dtype=None):
    """The four networks for one HU range (trainer.py:319-330,
    ducosy_tpu/train/state.py:52-64): generators take image + mask channels,
    with CBAM as ``range_cfg.use_cbam`` and ``model_cfg.fused_norm``;
    discriminators the 1-channel image."""
    gens = [Generator(range_cfg.input_channels, model_cfg.num_residual_blocks,
                      model_cfg.base_channels,
                      resolve_trunk(trunk, range_cfg, model_cfg),
                      compute_dtype, use_cbam=range_cfg.use_cbam,
                      fused_norm=model_cfg.fused_norm)
            for _ in range(2)]
    discs = [Discriminator(1, model_cfg.disc_base_channels, compute_dtype)
             for _ in range(2)]
    return gens + discs


def init_state_dicts(seed: int, range_cfg: RangeConfig,
                     model_cfg: ModelConfig = ModelConfig()):
    """Seeded numpy init of the four networks (N(0, 0.02) weights, zero
    biases; generators with CBAM as ``range_cfg.use_cbam``), keyed as
    NETS."""
    in_ch, base = range_cfg.input_channels, model_cfg.base_channels
    blocks, dbase = model_cfg.num_residual_blocks, model_cfg.disc_base_channels
    cbam = range_cfg.use_cbam
    return {"g_a2b": init_generator_state_dict(seed, in_ch, base, blocks,
                                               cbam),
            "g_b2a": init_generator_state_dict(seed + 1, in_ch, base, blocks,
                                               cbam),
            "d_a": init_discriminator_state_dict(seed + 2, 1, dbase),
            "d_b": init_discriminator_state_dict(seed + 3, 1, dbase)}


def create_state(cfg: TrainConfig, range_cfg: RangeConfig,
                 model_cfg: ModelConfig = ModelConfig(), *,
                 device: str | torch.device = "cuda", trunk: str = "auto",
                 state_dicts=None) -> CycleGANState:
    """Networks from ``state_dicts`` (numpy or tensor values, keyed as
    NETS; default: the seeded init from ``cfg.init_seed``) and fresh Adam
    optimizers, on ``device``."""
    if trunk == "chain":
        raise ValueError("trunk='chain' has no backward; train with 'tail' "
                         "or 'plain'")
    sds = state_dicts or init_state_dicts(cfg.init_seed, range_cfg, model_cfg)
    nets = build_models(range_cfg, model_cfg, trunk=trunk,
                        compute_dtype=_compute_dtype(cfg))
    for name, net in zip(NETS, nets):
        net.load_state_dict({k: torch.tensor(np.asarray(v))
                             for k, v in sds[name].items()})
        net.to(device)
    g_a2b, g_b2a, d_a, d_b = nets
    adam = lambda params: torch.optim.Adam(
        params, lr=cfg.lr, betas=(cfg.adam_b1, cfg.adam_b2))
    return CycleGANState(
        g_a2b, g_b2a, d_a, d_b,
        adam(list(g_a2b.parameters()) + list(g_b2a.parameters())),
        adam(d_a.parameters()), adam(d_b.parameters()))
