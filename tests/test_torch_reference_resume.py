"""Resuming the reference's ``checkpoint.pth.tar`` in the port
(train/torch_resume.py) against the JAX package's importer, on the CPU.

The reference's dict (modules/trainer.py:580-596: epoch, the four state
dicts, the three Adam and three LambdaLR state dicts, the best-val
bookkeeping, the run's argparse Namespace) is built from the port's own
models and optimizers after two training steps at the train tests' size
(32^2, 2 blocks, base 8, SOFT_TISSUE, fp32). In the "shuffled" case the
saved state dicts list their keys in another order and the optimizers'
positions follow it, as a reference whose ``parameters()`` order differs
from the port's would save them: a positional mapping would put moments on
the wrong parameters. The file is loaded through the port and through the
JAX ``import_torch_checkpoint``, and each takes the next step on the same
batch. Held: the port's resumed state equals the saved one (networks bit
for bit, Adam moments and steps by name); the resumed step's metrics
within rtol 1e-5 and its parameters within atol 1e-6 of the step the
never-saved state takes, and of the JAX step from the JAX import (where
the gradient is above 1e-6 and the parameter does not feed an
InstanceNorm, as tests/test_torch_train.py holds them).
"""
import argparse
import copy
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.config import ModelConfig, SOFT_TISSUE, TrainConfig, replace
from ducosy_tpu.train import create_state as jax_create_state
from ducosy_tpu.train import make_train_step as jax_make_train_step
from ducosy_tpu.train.torch_resume import import_torch_checkpoint
from ducosy_tpu_torch.cli import train as tcli
from ducosy_tpu_torch.models.convert import cyclegan_state_dicts_from_jax
from ducosy_tpu_torch.train import loop as tloop
from ducosy_tpu_torch.train.state import NETS, create_state
from ducosy_tpu_torch.train.step import make_train_step
from ducosy_tpu_torch.train.torch_resume import import_reference_checkpoint

sys.path.insert(0, os.path.dirname(__file__))
from synth import write_dataset  # noqa: E402

IMG, BATCH = 32, 2
CFG = replace(TrainConfig(), img_size=IMG, batch_size=BATCH,
              compute_dtype="float32")
MODEL = ModelConfig(num_residual_blocks=2, base_channels=8,
                    disc_base_channels=8)
OPTS = {"opt_g": "optimizer_G_state_dict", "opt_d_a": "optimizer_D_A_state_dict",
        "opt_d_b": "optimizer_D_B_state_dict"}
SDS = {"g_a2b": "G_A2B_state_dict", "g_b2a": "G_B2A_state_dict",
       "d_a": "D_A_state_dict", "d_b": "D_B_state_dict"}
METRICS = ["loss_G", "loss_D", "loss_GAN", "loss_cycle", "loss_id",
           "loss_ssim", "contrast"]


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.uniform(-1, 1, (BATCH, IMG, IMG, 1)).astype(np.float32),
            "b": rng.uniform(-1, 1, (BATCH, IMG, IMG, 1)).astype(np.float32),
            "masks": rng.integers(0, 2, (BATCH, IMG, IMG, 2)).astype(
                np.float32)}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _feeds_instance_norm(net, name):
    if not name.endswith(".bias"):
        return False
    idx = int(name.split(".")[1])
    if net.startswith("g"):
        return idx != 19 + MODEL.num_residual_blocks
    return idx not in (0, 12)


def _names(state, slot):
    nets = {"opt_g": (("", "g_a2b"), ("B2A::", "g_b2a")),
            "opt_d_a": (("", "d_a"),), "opt_d_b": (("", "d_b"),)}[slot]
    return [prefix + n for prefix, net in nets
            for n, _ in getattr(state, net).named_parameters()]


def _reference_dict(state, shuffled, seed=0):
    """The trainer.py:580-596 dict of ``state``; with ``shuffled`` the state
    dicts' keys in a seeded other order and the optimizers' positions
    following it."""
    rng = np.random.default_rng(seed)
    sds, order = {}, {}
    for net, key in SDS.items():
        sd = {k: v.detach().clone() for k, v in
              getattr(state, net).state_dict().items()}
        keys = list(sd)
        if shuffled:
            keys = [keys[i] for i in rng.permutation(len(keys))]
        sds[key] = {k: sd[k] for k in keys}
        order[net] = keys
    ref_order = {"opt_g": order["g_a2b"] + [f"B2A::{k}" for k in
                                            order["g_b2a"]],
                 "opt_d_a": order["d_a"], "opt_d_b": order["d_b"]}
    ckpt = {"epoch": 4, **sds, "best_val_loss": 0.625, "best_epoch": 3,
            "args": argparse.Namespace(lr=CFG.lr, epochs=CFG.epochs)}
    for slot, key in OPTS.items():
        opt_sd = getattr(state, slot).state_dict()
        pos = {n: i for i, n in enumerate(_names(state, slot))}
        ckpt[key] = {
            "state": {j: {k: (v.clone() if torch.is_tensor(v) else v)
                          for k, v in opt_sd["state"][pos[n]].items()}
                      for j, n in enumerate(ref_order[slot])},
            "param_groups": [{**opt_sd["param_groups"][0],
                              "params": list(range(len(pos)))}]}
        ckpt[key.replace("optimizer", "scheduler")] = {
            "last_epoch": 5, "base_lrs": [CFG.lr], "_last_lr": [CFG.lr]}
    return ckpt


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's state after two steps (JAX init, converted), the next
    batch, and the JAX template to import into."""
    jstate, gen, disc = jax_create_state(jax.random.PRNGKey(0), CFG,
                                         SOFT_TISSUE, MODEL, img_size=IMG)
    init = cyclegan_state_dicts_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate))
    state = create_state(CFG, SOFT_TISSUE, MODEL, device="cpu",
                         state_dicts=init)
    step = make_train_step(CFG, remat=False)
    for seed in (0, 1):
        step(state, _torch_batch(_batch(seed)))
    return dict(state=state, init=init, jax_template=jstate, gen=gen,
                disc=disc, tmp=tmp_path_factory.mktemp("ref_resume"))


def _write(trained, shuffled):
    path = trained["tmp"] / f"checkpoint_{shuffled}.pth.tar"
    if not path.exists():
        torch.save(_reference_dict(trained["state"], shuffled), str(path))
    return str(path)


def _resume_port(trained, shuffled):
    fresh = create_state(replace(CFG, init_seed=7), SOFT_TISSUE, MODEL,
                         device="cpu")
    with pytest.warns(UserWarning, match="full unpickle"):
        return import_reference_checkpoint(_write(trained, shuffled), fresh)


@pytest.mark.parametrize("shuffled", [False, True],
                         ids=["ordered", "shuffled"])
def test_import_restores_networks_moments_and_bookkeeping(trained, shuffled):
    saved = trained["state"]
    state = _resume_port(trained, shuffled)
    for net in NETS:
        a, b = getattr(saved, net).state_dict(), getattr(state,
                                                        net).state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), (net, k)
    for slot in OPTS:
        a, b = getattr(saved, slot), getattr(state, slot)
        for pa, pb in zip(a.param_groups[0]["params"],
                          b.param_groups[0]["params"]):
            sa, sb = a.state[pa], b.state[pb]
            assert float(sa["step"]) == float(sb["step"]) == 2.0
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(sa[k], sb[k]), (slot, k)
        assert b.param_groups[0]["lr"] == CFG.lr
    assert (state.epoch, state.best_val_loss, state.best_epoch) == \
        (4, 0.625, 3)


def _jax_step(trained, path):
    jstate = import_torch_checkpoint(path, trained["jax_template"],
                                     num_residual_blocks=2)
    jstate = jstate.set_learning_rate(CFG.lr)
    step = jax_make_train_step(trained["gen"], trained["disc"], CFG,
                               donate=False, remat=False,
                               gen_forward="module")
    new, metrics = step(jstate, {k: jnp.asarray(v)
                                 for k, v in _batch(2).items()})
    params = cyclegan_state_dicts_from_jax(
        jax.tree_util.tree_map(np.asarray, new))
    return {k: float(v) for k, v in metrics.items()}, params


@pytest.fixture(scope="module")
def next_steps(trained):
    """The next step (batch 2) from: the never-saved state (a copy), the
    port's import of each file, and the JAX import of the shuffled one."""
    out = {}
    cont = create_state(CFG, SOFT_TISSUE, MODEL, device="cpu",
                        state_dicts=trained["init"])
    # a deep copy: Optimizer.load_state_dict keeps the given tensors, and
    # the step below updates them in place
    cont.load_state_dict(copy.deepcopy(trained["state"].state_dict()))
    for name, state in (("continued", cont),
                        ("ordered", _resume_port(trained, False)),
                        ("shuffled", _resume_port(trained, True))):
        m = make_train_step(CFG, remat=False)(state,
                                              _torch_batch(_batch(2)))
        out[name] = ({k: float(v) for k, v in m.items()}, state)
    out["jax"] = _jax_step(trained, _write(trained, True))
    return out


def _params(entry, net):
    if isinstance(entry[1], dict):   # the JAX step's converted state dicts
        return {k: np.asarray(v) for k, v in entry[1][net].items()}
    return {k: p.detach().numpy() for k, p in
            getattr(entry[1], net).named_parameters()}


@pytest.mark.parametrize("other", ["ordered", "shuffled", "jax"])
def test_resumed_step_metrics(next_steps, other):
    want = next_steps["continued"][0]
    for k in METRICS:
        np.testing.assert_allclose(next_steps[other][0][k], want[k],
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("other", ["ordered", "shuffled", "jax"])
def test_resumed_step_params(next_steps, other):
    cont = next_steps["continued"][1]
    for net in NETS:
        want = _params(next_steps["continued"], net)
        got = _params(next_steps[other], net)
        for name, p in getattr(cont, net).named_parameters():
            if _feeds_instance_norm(net, name):
                continue
            keep = p.grad.abs().numpy() > 1e-6
            np.testing.assert_allclose(got[name][keep], want[name][keep],
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{net} {name}")


def test_import_of_a_safe_file_and_sparse_state(trained, tmp_path):
    """A file the safe loader reads (no Namespace) loads without the
    warning; a ``module.`` prefix is stripped; a parameter without Adam
    state gets zero moments and the others' step count."""
    ckpt = _reference_dict(trained["state"], False)
    ckpt["args"] = None
    for key in SDS.values():
        ckpt[key] = {f"module.{k}": v for k, v in ckpt[key].items()}
    del ckpt["optimizer_G_state_dict"]["state"][0]
    path = str(tmp_path / "checkpoint.pth.tar")
    torch.save(ckpt, path)
    fresh = create_state(CFG, SOFT_TISSUE, MODEL, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        state = import_reference_checkpoint(path, fresh)
    first = state.opt_g.param_groups[0]["params"][0]
    s = state.opt_g.state[first]
    assert float(s["step"]) == 2.0
    assert not s["exp_avg"].any() and not s["exp_avg_sq"].any()
    assert torch.equal(state.g_a2b.state_dict()["model.1.weight"],
                       trained["state"].g_a2b.state_dict()["model.1.weight"])


def test_import_refuses_a_generator_pth(trained, tmp_path):
    path = str(tmp_path / "G_A2B_last.pth")
    torch.save(trained["state"].g_a2b.state_dict(), path)
    fresh = create_state(CFG, SOFT_TISSUE, MODEL, device="cpu")
    with pytest.raises(KeyError, match="not a full training checkpoint"):
        import_reference_checkpoint(path, fresh)


def test_training_cli_resumes_a_pth_tar(trained, tmp_path):
    """``--resume .../checkpoint.pth.tar``: the run continues at the saved
    epoch + 1 with the saved weights, and each Adam step count goes on
    from the saved one."""
    root = str(tmp_path / "data")
    write_dataset(root, n_patients=3, n_slices=2, size=IMG)
    path = _write(trained, True)
    assert tloop._resolve_resume(path, "unused") == path
    out = tcli.main([
        "--data_root", root, "--dataset_names", "SynthSet",
        "--training_dir", str(tmp_path / "run"), "--target_model",
        "soft_tissue", "--img_size", str(IMG), "--batch_size", str(BATCH),
        "--num_residual_blocks", "2", "--base_channels", "8",
        "--disc_base_channels", "8", "--compute_dtype", "float32",
        "--device", "cpu", "--val_split", "0.34", "--max_epochs", "1",
        "--max_steps_per_epoch", "1", "--resume", path])["soft_tissue"]
    assert out["epochs_run"] == 1 and np.isfinite(out["loss_G"])
    saved = torch.load(str(tmp_path / "run" / "soft_tissue" / "saved_models"
                           / "checkpoint.pt"), weights_only=True)
    assert saved["epoch"] == 5
    steps = {float(s["step"]) for s in saved["opt_g"]["state"].values()}
    assert steps == {3.0}
