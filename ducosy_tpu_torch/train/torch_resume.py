"""Resume from the reference's all-in-one ``checkpoint.pth.tar``
(ducosy_tpu/train/torch_resume.py; reference modules/trainer.py:580-596,
restore :374-417).

The file holds the epoch, the four networks' state dicts, the three Adam
optimizers' state dicts, the three LambdaLR schedulers' states and the
best-val bookkeeping. ``import_reference_checkpoint`` loads it into the
port's ``CycleGANState`` (train/state.py), so a reference run continues
here with its weights, Adam moments, step counts and best-model tracking.

Mapping notes
-------------
* The port's networks use the reference key layout as their own, so the
  state dicts load as they are (a DataParallel ``module.`` prefix is
  stripped).
* ``Adam.state_dict()`` keys its per-parameter state by the parameter's
  POSITION in the optimizer's list. Each position is mapped to the
  reference's name for it (the order of the saved model state dict; for
  the joint generator optimizer, ``Adam(list(G_A2B.parameters()) +
  list(G_B2A.parameters()))`` at trainer.py:361, the A2B names, then the
  B2A ones), and that name to the port's parameter of the same name, so
  nothing depends on the two ``parameters()`` orders agreeing.
* A parameter without optimizer state (it got no gradient before the save)
  gets zero moments and the others' step count, as the JAX importer gives
  it (optax keeps one count for all).
* The lr of each optimizer comes from its ``param_groups``; the other
  hyperparameters stay the port's. A LambdaLR's state is its
  ``last_epoch`` only, and the port's loop recomputes the lr from the
  epoch, so restoring ``epoch`` restores the schedule.
"""
from __future__ import annotations

import pickle
import warnings
from typing import Any, Dict, List

import numpy as np
import torch

from ducosy_tpu_torch.models.convert import strip_module_prefix
from ducosy_tpu_torch.train.state import CycleGANState

NETS = {"g_a2b": "G_A2B_state_dict", "g_b2a": "G_B2A_state_dict",
        "d_a": "D_A_state_dict", "d_b": "D_B_state_dict"}
OPTIMIZERS = {"opt_g": "optimizer_G_state_dict",
              "opt_d_a": "optimizer_D_A_state_dict",
              "opt_d_b": "optimizer_D_B_state_dict"}


def load_reference_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint's dict, on the CPU. The safe loader comes first; the
    reference format embeds its argparse Namespace under 'args'
    (trainer.py:580-596), which that loader refuses, and the full unpickle
    that follows runs code from the file: resume only from checkpoints you
    trust."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:   # the safe loader's refusal
        warnings.warn(f"{path}: the safe loader refused the file; loading "
                      "it with a full unpickle, which runs code from it "
                      "(resume only from checkpoints you trust)")
        return torch.load(path, map_location="cpu", weights_only=False)


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def _adam_state(opt_sd: Dict[str, Any], ref_names: List[str],
                port_index: Dict[str, int]) -> Dict[int, Dict[str, Any]]:
    """The reference optimizer's per-parameter state re-keyed by the port's
    parameter positions."""
    state = opt_sd.get("state", {})
    n_ref = sum(len(g["params"]) for g in opt_sd.get("param_groups", []))
    if n_ref and n_ref != len(ref_names):
        raise ValueError(f"optimizer holds {n_ref} parameters, the models' "
                         f"state dicts {len(ref_names)}")
    if set(ref_names) != set(port_index):
        raise ValueError("checkpoint parameter names differ from the "
                         "port's: " + str(sorted(set(ref_names)
                                                 ^ set(port_index))[:8]))
    by_name = {}
    for j, name in enumerate(ref_names):
        s = state.get(j, state.get(str(j)))
        if s is not None:
            by_name[name] = s
    if not by_name:
        return {}
    step = max(float(_tensor(s["step"])) for s in by_name.values())
    out = {}
    for name, i in port_index.items():
        s = by_name.get(name)
        if s is None:
            out[i] = {"step": torch.tensor(step), "exp_avg": None,
                      "exp_avg_sq": None}
            continue
        out[i] = {"step": torch.tensor(float(_tensor(s["step"]))),
                  "exp_avg": _tensor(s["exp_avg"]),
                  "exp_avg_sq": _tensor(s["exp_avg_sq"])}
    return out


def _load_optimizer(opt: torch.optim.Optimizer, opt_sd: Dict[str, Any],
                    ref_names: List[str], params: List) -> None:
    """Adam state of ``opt`` (over ``params``, (name, tensor) pairs in its
    order) from the reference optimizer's state dict."""
    port_index = {name: i for i, (name, _) in enumerate(params)}
    state = _adam_state(opt_sd, ref_names, port_index)
    for i, s in state.items():   # zero moments where the reference had none
        p = params[i][1]
        for k in ("exp_avg", "exp_avg_sq"):
            if s[k] is None:
                s[k] = torch.zeros_like(p, device="cpu")
            if tuple(s[k].shape) != tuple(p.shape):
                raise ValueError(f"{params[i][0]}: {k} shape "
                                 f"{tuple(s[k].shape)} != {tuple(p.shape)}")
    sd = opt.state_dict()
    groups = opt_sd.get("param_groups", [])
    if groups:
        for g in sd["param_groups"]:
            g["lr"] = float(groups[0]["lr"])
    sd["state"] = state
    opt.load_state_dict(sd)


def import_reference_checkpoint(path: str,
                                state: CycleGANState) -> CycleGANState:
    """Load a reference-format ``checkpoint.pth.tar`` into ``state`` (its
    networks and optimizers keep their devices) and return it: weights,
    Adam moments and step counts, lr, epoch (the last finished 0-based
    epoch; the loop resumes at epoch + 1) and the best-val bookkeeping.
    Raises KeyError for a file that is not a full training checkpoint and
    ValueError or RuntimeError for one of another model configuration."""
    ckpt = load_reference_checkpoint(path)
    missing = [k for k in NETS.values() if k not in ckpt]
    if missing:
        raise KeyError(
            f"{path} is not a full training checkpoint (missing {missing}); "
            "for generator-only .pth weights use models/convert")
    sds = {k: strip_module_prefix(ckpt[k]) for k in NETS.values()}
    for net, key in NETS.items():
        getattr(state, net).load_state_dict(
            {k: _tensor(v) for k, v in sds[key].items()})

    def named(*nets):
        return [(prefix + n, p) for prefix, net in nets
                for n, p in getattr(state, net).named_parameters()]

    ref_names = {
        "opt_g": list(sds["G_A2B_state_dict"])
        + [f"B2A::{k}" for k in sds["G_B2A_state_dict"]],
        "opt_d_a": list(sds["D_A_state_dict"]),
        "opt_d_b": list(sds["D_B_state_dict"])}
    params = {"opt_g": named(("", "g_a2b"), ("B2A::", "g_b2a")),
              "opt_d_a": named(("", "d_a")), "opt_d_b": named(("", "d_b"))}
    for slot, key in OPTIMIZERS.items():
        if key in ckpt:
            _load_optimizer(getattr(state, slot), ckpt[key], ref_names[slot],
                            params[slot])
    state.epoch = int(ckpt.get("epoch", -1))
    state.best_val_loss = float(ckpt.get("best_val_loss", np.inf))
    state.best_epoch = int(ckpt.get("best_epoch", -1))
    return state
