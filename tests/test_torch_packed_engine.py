"""The port's packed forward behind its entry points, against the JAX
package on the CPU: the serving engine's ``forward="packed"`` (32^2
slices, base 8, 3 blocks, fp32) and the train step's
``gen_forward="packed"`` (32^2, base 8, 2 blocks, SOFT_TISSUE, fp32).

Held:
  - ``run_patient(forward="packed")`` within 1 stored unit of the JAX
    engine's packed forward on >= 99.9% of voxels
    (tests/test_torch_quant.py's bound), at the default trunk (the XLA
    trunk on the CPU), a chain trunk, and the XLA trunk's dynamic requant;
  - one training step with the packed forward against JAX's step on the
    same init and batch: metrics rtol 1e-4, generator gradients relative
    L2 <= 1e-3, the biases that feed an InstanceNorm to their noise bound
    (tests/test_torch_train.py's bounds). JAX's step is its module step:
    its packed step computes the same function (tests/test_fused_forward.py
    holds the two forwards and their gradients together) and takes ten
    minutes to compile on the CPU, its module step half a minute.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.config import SOFT_TISSUE, replace
from ducosy_tpu.infer.engine import DualGeneratorEngine as JaxEngine
from ducosy_tpu.losses.suite import generator_loss as jax_g_loss
from ducosy_tpu.models.generator import Generator as JaxGenerator
from ducosy_tpu.train import create_state as jax_create_state
from ducosy_tpu.train import make_train_step as jax_make_train_step
from ducosy_tpu.train.step import _forward_all as jax_forward_all
from ducosy_tpu_torch.infer.engine import DualGeneratorEngine
from ducosy_tpu_torch.models.convert import (
    cyclegan_state_dicts_from_jax,
    generator_state_dict_from_jax,
    init_generator_state_dict,
)
from ducosy_tpu_torch.train import step as tstep
from ducosy_tpu_torch.train.state import create_state
from ducosy_tpu_torch.train.step import make_train_step

sys.path.insert(0, os.path.dirname(__file__))
import jax_shared  # noqa: E402
from synth import chest_hu  # noqa: E402

BASE, SIZE = 8, 32


def _jax_params(seed, blocks=3):
    gen = JaxGenerator(1, blocks, BASE, dtype=jnp.float32)
    p = jax.jit(gen.init)(jax.random.PRNGKey(seed),
                          jnp.zeros((1, SIZE, SIZE, 1)))
    return jax.tree_util.tree_map(np.asarray, p["params"])


# --------------------------------------------------------------- engine
def _volume(z=6):
    hu = np.stack([chest_hu(SIZE, SIZE, z=i) for i in range(z)])
    return (hu + 1024.0).astype(np.int16)


@pytest.mark.parametrize("quant,trunk", [(None, "auto"), ("trunk", "xla")])
def test_run_patient_packed_matches_jax_engine(quant, trunk):
    params = [_jax_params(0, blocks=3), _jax_params(1, blocks=3)]
    jeng = JaxEngine(*params, img_size=SIZE, compute_dtype=jnp.float32,
                     forward="packed", trunk=trunk, quant=quant)
    ref = jeng.run_patient(_volume(), 1.0, -1024.0, chunk=4)
    eng = DualGeneratorEngine(
        *(generator_state_dict_from_jax(p) for p in params), img_size=SIZE,
        compute_dtype=torch.float32, device="cpu", forward="packed",
        trunk=trunk, quant=quant)
    assert eng.forward_impl == "packed" and eng.trunk == trunk
    got = eng.run_patient(_volume(), 1.0, -1024.0, chunk=4)
    assert got.dtype == np.int16 and got.shape == ref.shape
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert float(np.mean(d <= 1)) >= 0.999


@pytest.mark.parametrize("kw,match", [
    ({"forward": "packed", "trunk": "tail"}, "trunk must be"),
    ({"forward": "packed", "img_size": 30}, "divisible by 4"),
    ({"forward": "sideways"}, "forward must be"),
], ids=["module-trunk-under-packed", "img-size", "forward"])
def test_packed_engine_refuses(kw, match):
    sd = init_generator_state_dict(0, 1, BASE, 1)
    kw = {"img_size": SIZE, "device": "cpu", **kw}
    with pytest.raises(ValueError, match=match):
        DualGeneratorEngine(sd, sd, **kw)


def test_packed_engine_on_a_data_mesh_matches_one_device():
    """forward="packed" over a 1-D data mesh (two CPU replicas, each chunk
    of 4 in parts of 2) against one device, fp32, quant="trunk": |d| <= 1
    stored unit on >= 99.9% of voxels (tests/test_torch_parallel.py's
    bound: fp32 summation order can flip a truncation)."""
    sds = [init_generator_state_dict(s, 1, BASE, 3) for s in (3, 4)]
    kw = dict(img_size=SIZE, compute_dtype=torch.float32, forward="packed",
              trunk="chain3", quant="trunk")
    two = DualGeneratorEngine(*sds, mesh=["cpu", "cpu"], **kw)
    assert len(two.replicas) == 2
    assert two.replicas[0][0] is not two.replicas[1][0]
    got = two.run_patient(_volume(), 1.0, -1024.0, chunk=4)
    one = DualGeneratorEngine(*sds, device="cpu", **kw).run_patient(
        _volume(), 1.0, -1024.0, chunk=4)
    assert got.shape == one.shape and got.dtype == np.int16
    d = np.abs(got.astype(np.int32) - one.astype(np.int32))
    assert float(np.mean(d <= 1)) >= 0.999


# ------------------------------------------------------------- training
IMG, BATCH = jax_shared.IMG, jax_shared.BATCH
CFG, MODEL = jax_shared.CFG, jax_shared.MODEL
NOISE_BOUND = 1e-5   # |grad| of a bias that feeds an InstanceNorm


_batch = jax_shared.batch


def jax_step_run(range_cfg, model_cfg):
    """One JAX module step and the generators' gradients, as the port's
    state dicts (shared with tests/test_torch_nocbam.py)."""
    state, gen, disc = jax_create_state(jax.random.PRNGKey(0), CFG,
                                        range_cfg, model_cfg, img_size=IMG)
    batch = _batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax_make_train_step(gen, disc, CFG, donate=False, remat=False,
                               gen_forward="module")
    _, metrics = step(state, jb)
    apply = lambda p, x: gen.apply({"params": p}, x)

    def g_loss(g_params):
        fake_a, fake_b, id_a, id_b, rec_a, rec_b = jax_forward_all(
            apply, g_params["a2b"], g_params["b2a"], jb)
        return jax_g_loss(
            real_a=jb["a"], real_b=jb["b"], fake_a=fake_a, fake_b=fake_b,
            rec_a=rec_a, rec_b=rec_b, id_a=id_a, id_b=id_b,
            d_a_fake_logits=disc.apply({"params": state.params_d_a}, fake_a),
            d_b_fake_logits=disc.apply({"params": state.params_d_b}, fake_b),
            cfg=CFG).total

    g = jax.jit(jax.grad(g_loss))({"a2b": state.params_g_a2b,
                                   "b2a": state.params_g_b2a})
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(init=cyclegan_state_dicts_from_jax(tree(state)),
                metrics={k: float(v) for k, v in metrics.items()},
                grads={"g_a2b": generator_state_dict_from_jax(tree(g["a2b"])),
                       "g_b2a": generator_state_dict_from_jax(tree(g["b2a"]))},
                batch=batch)


def port_step_run(jax_run, range_cfg, model_cfg, **kw):
    state = create_state(CFG, range_cfg, model_cfg, device="cpu",
                         state_dicts=jax_run["init"])
    batch = {k: torch.from_numpy(v) for k, v in jax_run["batch"].items()}
    metrics = make_train_step(CFG, remat=False, **kw)(state, batch)
    return state, {k: float(v) for k, v in metrics.items()}


def check_generator_grads(state, jax_run, blocks):
    """Relative L2 <= 1e-3 a tensor; the biases of convs that feed an
    InstanceNorm (every generator conv but the head) to the noise bound."""
    for net in ("g_a2b", "g_b2a"):
        for name, p in getattr(state, net).named_parameters():
            ref, got = jax_run["grads"][net][name], p.grad.numpy()
            if name.endswith(".bias") and \
                    int(name.split(".")[1]) != 19 + blocks:
                assert np.abs(ref).max() < NOISE_BOUND, name
                assert np.abs(got).max() < NOISE_BOUND, name
                continue
            rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert rel <= 1e-3, f"{net} {name}: relative L2 {rel:.2e}"


@pytest.fixture(scope="module")
def packed_runs(tmp_path_factory):
    """JAX's module step at this file's CFG and MODEL, computed once a test
    run (tests/jax_shared.py; jax_step_run's quantities and more), and the
    port's packed step from its init."""
    jax_run = jax_shared.module_step(tmp_path_factory)
    return jax_run, port_step_run(jax_run, SOFT_TISSUE, MODEL,
                                  gen_forward="packed")


def test_packed_step_metrics_match_jax(packed_runs):
    jax_run, (_, metrics) = packed_runs
    for k, v in jax_run["metrics"].items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-4, err_msg=k)


def test_packed_step_gradients_match_jax(packed_runs):
    jax_run, (state, _) = packed_runs
    check_generator_grads(state, jax_run, MODEL.num_residual_blocks)


def test_gen_forward_packed_is_read_from_the_config(packed_runs,
                                                   monkeypatch):
    """TrainConfig.gen_forward="packed" changes what the step runs: its six
    generator forwards go through generator_apply_packed, the step's
    metrics are those of gen_forward="packed" named; "auto" runs none."""
    jax_run, (_, metrics) = packed_runs
    calls = []
    real = tstep.generator_apply_packed

    def counted(*a, **kw):
        calls.append(kw.get("encoder_fused"))
        return real(*a, **kw)

    monkeypatch.setattr(tstep, "generator_apply_packed", counted)
    batch = {k: torch.from_numpy(v) for k, v in jax_run["batch"].items()}
    for fwd, want in (("packed", [False] * 6), ("auto", [])):
        cfg = replace(CFG, gen_forward=fwd)
        state = create_state(cfg, SOFT_TISSUE, MODEL, device="cpu",
                             state_dicts=jax_run["init"])
        calls.clear()
        got = make_train_step(cfg, remat=False)(state, batch)
        assert calls == want, fwd
        if fwd == "packed":
            for k, v in metrics.items():
                np.testing.assert_allclose(float(got[k]), v, rtol=1e-6,
                                           err_msg=k)


def test_packed_step_remat_matches_plain_step(packed_runs):
    """remat wraps the packed forward as it wraps the module forward."""
    jax_run, (_, metrics) = packed_runs
    state = create_state(CFG, SOFT_TISSUE, MODEL, device="cpu",
                         state_dicts=jax_run["init"])
    batch = {k: torch.from_numpy(v) for k, v in jax_run["batch"].items()}
    got = make_train_step(CFG, remat=True, gen_forward="packed")(state, batch)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-6, err_msg=k)
