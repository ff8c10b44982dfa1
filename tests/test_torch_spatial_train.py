"""The port's (data, sp) mesh training on the CPU, against the JAX package,
at 32^2, base 8, 2 residual blocks, batch 4, SOFT_TISSUE, fp32, every band
on "cpu". Held:
  (b) the sp step (module and packed forwards, remat on and off, 4 row
      bands) against JAX's step from the same init and batch, at the
      bounds of JAX's own sp step test (tests/test_train_step.py:264-294):
      losses at rtol 2e-4, every generator parameter within 4 lr and 99%
      of them within 1e-5; ``val_step`` on bands against the whole image;
  (c) 2 spawned gloo ranks of 2 bands, ``data_sp_mesh(2, 2)``, against
      one process of the whole image: metrics at rtol 1e-5, gradients at
      relative L2 1e-4, the ranks' parameters equal;
  (d) ``train_cycle_gan(mesh=...)`` against the one-device loop.
"""
import datetime
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.config import ModelConfig as JaxModelConfig
from ducosy_tpu.config import SOFT_TISSUE as JAX_SOFT_TISSUE
from ducosy_tpu.config import TrainConfig as JaxTrainConfig
from ducosy_tpu.train import create_state as jax_create_state
from ducosy_tpu.train import make_train_step as jax_make_train_step
from ducosy_tpu_torch.config import ModelConfig, SOFT_TISSUE, TrainConfig, \
    replace
from ducosy_tpu_torch.models.convert import cyclegan_state_dicts_from_jax
from ducosy_tpu_torch.parallel import launch
from ducosy_tpu_torch.parallel.mesh import data_sp_mesh
from ducosy_tpu_torch.train import loop as tloop
from ducosy_tpu_torch.train.loop import run_steps
from ducosy_tpu_torch.train.state import NETS, create_state
from ducosy_tpu_torch.train.step import val_step

sys.path.insert(0, os.path.dirname(__file__))
from synth import write_dataset  # noqa: E402

IMG, BASE, BATCH = 32, 8, 4
DEADLINE_S = 240
PG_TIMEOUT = datetime.timedelta(seconds=120)


# ------------------------------------------------------------------- (b)
CFG = replace(TrainConfig(), img_size=IMG, batch_size=BATCH,
              compute_dtype="float32")
MODEL = ModelConfig(num_residual_blocks=2, base_channels=BASE,
                    disc_base_channels=BASE)
JAX_CFG = replace(JaxTrainConfig(), img_size=IMG, batch_size=BATCH,
                  compute_dtype="float32")
JAX_MODEL = JaxModelConfig(num_residual_blocks=2, base_channels=BASE,
                           disc_base_channels=BASE)
LOSSES = ("loss_G", "loss_D", "loss_ssim", "contrast")


def _batch(seed=7):
    rng = np.random.default_rng(seed)
    return {"a": rng.uniform(-1, 1, (BATCH, IMG, IMG, 1)).astype(np.float32),
            "b": rng.uniform(-1, 1, (BATCH, IMG, IMG, 1)).astype(np.float32),
            "masks": rng.integers(0, 2, (BATCH, IMG, IMG, 2)).astype(
                np.float32)}


@pytest.fixture(scope="module")
def jax_step():
    """JAX's step from its create_state init on one batch: the metrics, the
    updated generator parameters and the port's state dicts of the init."""
    state, gen, disc = jax_create_state(jax.random.PRNGKey(0), JAX_CFG,
                                        JAX_SOFT_TISSUE, JAX_MODEL,
                                        img_size=IMG)
    step = jax_make_train_step(gen, disc, JAX_CFG, donate=False,
                               remat=False, gen_forward="module")
    new, metrics = step(state, {k: jnp.asarray(v)
                                for k, v in _batch().items()})
    new = cyclegan_state_dicts_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               new))
    init = cyclegan_state_dicts_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                state))
    return init, {k: float(v) for k, v in metrics.items()}, new


@pytest.mark.parametrize("forward", ["module", "packed"])
@pytest.mark.parametrize("remat", [False, True])
def test_sp_step_matches_jax(jax_step, forward, remat):
    """One step with the generators on 4 row bands (the plain trunk) from
    JAX's init against JAX's step: tests/test_train_step.py:264-294's
    bounds."""
    init, ref, new = jax_step
    cfg = replace(CFG, gen_forward=forward)
    out = run_steps(("cpu",) * 4, init, [_batch()], cfg, SOFT_TISSUE, MODEL,
                    remat=remat)
    for k in LOSSES:
        np.testing.assert_allclose(out["metrics"][0][k], ref[k], rtol=2e-4,
                                   err_msg=k)
    diffs = np.concatenate([
        np.abs(out["params"][net][name] - want).ravel()
        for net in ("g_a2b", "g_b2a") for name, want in new[net].items()])
    assert diffs.max() < 4 * cfg.lr
    assert np.mean(diffs < 1e-5) > 0.99


def test_sp_val_step_matches_one_device(jax_step):
    """val_step on 4 row bands against the whole image."""
    state = create_state(CFG, SOFT_TISSUE, MODEL, device="cpu",
                         trunk="plain", state_dicts=jax_step[0])
    batch = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    loss, fake = val_step(state, batch, CFG)
    sp_loss, sp_fake = val_step(state, batch, CFG, sp_devices=["cpu"] * 4)
    np.testing.assert_allclose(float(sp_loss), float(loss), rtol=1e-5)
    torch.testing.assert_close(sp_fake, fake, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- (c)
def test_spawned_2x2_matches_one_process(jax_step):
    """(2, 2): two gloo ranks, each its rows of the global batch on two
    bands, against one process on whole images (the plain trunk)."""
    init, batch = jax_step[0], _batch(11)
    one = run_steps("cpu", init, [batch], CFG, SOFT_TISSUE, MODEL,
                    trunk="plain")
    ranks = launch.spawn(run_steps, (init, [batch], CFG, SOFT_TISSUE, MODEL),
                         data_sp_mesh(2, 2, ["cpu"] * 4),
                         timeout=DEADLINE_S, pg_timeout=PG_TIMEOUT)
    assert [r["spread"] for r in ranks] == [[0.0], [0.0]]
    for k, v in one["metrics"][0].items():
        np.testing.assert_allclose(ranks[0]["metrics"][0][k], v, rtol=1e-5,
                                   err_msg=k)
    for net in NETS:
        for name, ref in one["grads"][net].items():
            if np.linalg.norm(ref) < 1e-5:   # a bias that feeds a norm
                continue
            got = ranks[0]["grads"][net][name]
            rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert rel <= 1e-4, f"{net} {name}: relative L2 {rel:.2e}"


# ------------------------------------------------------------------- (d)
def test_train_cycle_gan_on_a_mesh_row(tmp_path):
    """One epoch of 2 steps on data_sp_mesh(1, 2) against the one-device
    loop (trunk "plain", which "auto" becomes under sp): the same losses;
    a mesh of 2 data rows in one process raises."""
    write_dataset(str(tmp_path / "data"), n_patients=3, n_slices=2,
                  size=IMG)
    cfg = replace(CFG, batch_size=2, num_workers=1, val_split=0.34,
                  data_root=str(tmp_path / "data"),
                  dataset_names="SynthSet", resume="")
    run = lambda name, **kw: tloop.train_cycle_gan(
        replace(cfg, training_dir=str(tmp_path / name)), "soft_tissue",
        MODEL, max_epochs=1, max_steps_per_epoch=2, **kw)
    got = run("sp", mesh=data_sp_mesh(1, 2, ["cpu", "cpu"]))
    ref = run("one", device="cpu", trunk="plain")
    assert len(got["step_seconds"]) == 2
    for k in ("loss_G", "loss_D", "val_loss"):
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-4, err_msg=k)
    with pytest.raises(ValueError, match="2 data rows"):
        run("two", mesh=data_sp_mesh(2, 2, ["cpu"] * 4))
