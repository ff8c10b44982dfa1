"""Generators without CBAM and the module forward's ``fused_norm``, against
the JAX package on the CPU: 32^2 slices, base 8 (a 32-channel trunk),
fp32, numpy inputs from a seed, weights through
``generator_state_dict_from_jax``.

Held:
  - ``RangeConfig(use_cbam=False)`` builds and inits the JAX package's
    no-CBAM generator, where a build that ignores the flag makes a CBAM
    one;
  - the module forward without CBAM, and with ``fused_norm`` (the 18 trunk
    norms on K2/K3's plain versions here) with and without CBAM, and the
    packed forward without CBAM under each quant mode, at rtol 1e-4, atol
    1e-5 (tests/test_fused_forward.py's forward tolerance);
  - ``run_patient`` of a no-CBAM pair (module plain, module fused_norm,
    packed) within 1 stored unit of the JAX engine's on >= 99.9% of voxels;
  - one no-CBAM ``fused_norm`` training step against JAX's step on the
    same init and batch: metrics rtol 1e-4, generator gradients relative L2
    <= 1e-3, the biases that feed an InstanceNorm to their noise bound
    (tests/test_torch_train.py's bounds);
  - the refusals: a trunk with the CBAM gates on a generator without them,
    as the JAX engine words it.
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.config import ModelConfig as JaxModelConfig
from ducosy_tpu.config import SOFT_TISSUE as JAX_SOFT_TISSUE
from ducosy_tpu.config import replace as jax_replace
from ducosy_tpu.infer.engine import DualGeneratorEngine as JaxEngine
from ducosy_tpu.models import fused as jf
from ducosy_tpu.models.generator import Generator as JaxGenerator
from ducosy_tpu.train.state import build_models as jax_build_models
from ducosy_tpu_torch.config import SOFT_TISSUE, ModelConfig, replace
from ducosy_tpu_torch.infer.engine import DualGeneratorEngine
from ducosy_tpu_torch.models import fused as tf
from ducosy_tpu_torch.models.convert import (
    generator_shapes,
    generator_state_dict_from_jax,
    init_generator_state_dict,
)
from ducosy_tpu_torch.models.generator import Generator
from ducosy_tpu_torch.ops.kernels import instance_norm as k2
from ducosy_tpu_torch.train.state import (
    build_models,
    init_state_dicts,
    resolve_trunk,
)

sys.path.insert(0, os.path.dirname(__file__))
from synth import chest_hu  # noqa: E402
from test_torch_packed_engine import (  # noqa: E402
    check_generator_grads,
    jax_step_run,
    port_step_run,
)

BASE, SIZE = 8, 32
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
NO_CBAM = replace(SOFT_TISSUE, use_cbam=False)


@functools.lru_cache(maxsize=None)
def _jax_params(seed, cbam=False, blocks=2, in_ch=1):
    gen = JaxGenerator(in_ch, blocks, BASE, use_cbam=cbam, dtype=jnp.float32)
    p = jax.jit(gen.init)(jax.random.PRNGKey(seed),
                          jnp.zeros((1, SIZE, SIZE, in_ch)))
    return jax.tree_util.tree_map(np.asarray, p["params"])


def _input(seed=1, n=2):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, SIZE, SIZE, 1)).astype(np.float32)


def _jax_sd_keys(range_cfg, model_cfg):
    gen, _ = jax_build_models(range_cfg, model_cfg)
    p = jax.eval_shape(gen.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, SIZE, SIZE, range_cfg.input_channels)))
    return set(generator_state_dict_from_jax(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), p["params"])))


def test_use_cbam_false_builds_the_jax_generator():
    """build_models reads the range's use_cbam: Generator called without
    it (build_models' call before it read the flag) makes a CBAM model,
    where JAX trains a plain one for RangeConfig(use_cbam=False); the
    generators built now have JAX's keys."""
    model = ModelConfig(num_residual_blocks=2, base_channels=BASE)
    jax_model = JaxModelConfig(num_residual_blocks=2, base_channels=BASE)
    jax_keys = _jax_sd_keys(jax_replace(JAX_SOFT_TISSUE, use_cbam=False),
                            jax_model)
    unread = Generator(NO_CBAM.input_channels, 2, BASE, "tail", None)
    assert any(".cbam." in k for k in unread.state_dict())
    assert set(unread.state_dict()) != jax_keys
    gens = build_models(NO_CBAM, model)[:2]
    for gen in gens:
        assert set(gen.state_dict()) == jax_keys
        assert not gen.use_cbam and gen.trunk == "plain"
    inits = init_state_dicts(0, NO_CBAM, model)
    assert set(inits["g_a2b"]) == jax_keys
    assert set(generator_shapes(3, BASE, 2, use_cbam=False)) == jax_keys
    # and a CBAM range is as before
    assert set(build_models(SOFT_TISSUE, model)[0].state_dict()) == \
        _jax_sd_keys(JAX_SOFT_TISSUE, jax_model)


@pytest.mark.parametrize("cbam,fused_norm", [(False, False), (False, True),
                                             (True, True)])
def test_module_forward_matches_jax(cbam, fused_norm):
    """Generator.from_state_dict takes a no-CBAM state dict; "auto" is the
    plain trunk, whose fused_norm sends the 18 trunk norms through K2 (the
    plain version here, counted 0 times) as JAX's fused_norm does."""
    p = _jax_params(0, cbam)
    x = _input()
    ref = JaxGenerator(1, 2, BASE, use_cbam=cbam, dtype=jnp.float32,
                       fused_norm=fused_norm).apply({"params": p},
                                                    jnp.asarray(x))
    gen = Generator.from_state_dict(generator_state_dict_from_jax(p),
                                    fused_norm=fused_norm)
    assert gen.trunk == "plain" and gen.use_cbam == cbam
    before = k2.instance_norm.launches
    with torch.no_grad():
        got = gen(torch.from_numpy(x))
    assert k2.instance_norm.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


def test_fused_norm_routes_the_trunk_norms_through_k2(monkeypatch):
    """fused_norm: 2 K2 calls a block (ReLU pad 0, then no ReLU), through
    the differentiable wrapper; none without it."""
    seen = []
    real = k2.instance_norm_fused

    def spy(x, relu=False, pad=0, eps=1e-5):
        seen.append((relu, pad))
        return real(x, relu, pad, eps)

    monkeypatch.setattr(k2, "instance_norm_fused", spy)
    sd = generator_state_dict_from_jax(_jax_params(0))
    x = torch.from_numpy(_input())
    Generator.from_state_dict(sd, fused_norm=True)(x)
    assert seen == [(True, 0), (False, 0)] * 2
    seen.clear()
    Generator.from_state_dict(sd)(x)
    assert seen == []


@pytest.mark.parametrize("trunk", ["chain", "mega", "tail"])
def test_cbam_trunks_refuse_a_generator_without_cbam(trunk):
    sd = generator_state_dict_from_jax(_jax_params(0))
    with pytest.raises(ValueError, match="needs CBAM checkpoints"):
        Generator.from_state_dict(sd, trunk=trunk)


@pytest.mark.parametrize("quant", [None, "trunk", "full"])
@pytest.mark.parametrize("trunk", ["xla", "pallas"])
def test_packed_forward_without_cbam_matches_jax(trunk, quant):
    """Without CBAM the packed forward runs the XLA trunk whatever it is
    named (fused.py:540), with the dynamic-requant convs under quant."""
    p = _jax_params(1)
    x = _input(2)
    ref = jf.generator_apply_packed(p, jnp.asarray(x), num_residual_blocks=2,
                                    use_cbam=False, dtype=jnp.float32,
                                    trunk=trunk, quant=quant)
    got = tf.generator_apply_packed(generator_state_dict_from_jax(p),
                                    torch.from_numpy(x), use_cbam=False,
                                    dtype=torch.float32, trunk=trunk,
                                    quant=quant)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


def test_generator_apply_fused_without_cbam_matches_jax():
    p = _jax_params(1)
    x = _input(3)
    ref = jf.generator_apply_fused(p, jnp.asarray(x), num_residual_blocks=2,
                                   use_cbam=False, dtype=jnp.float32)
    got = tf.generator_apply_fused(generator_state_dict_from_jax(p),
                                   torch.from_numpy(x), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


def _volume(z=6):
    hu = np.stack([chest_hu(SIZE, SIZE, z=i) for i in range(z)])
    return (hu + 1024.0).astype(np.int16)


def test_run_patient_without_cbam_matches_jax_engine():
    """One JAX run of a no-CBAM pair (its module forward) against the port's
    module forward ("auto": plain), with fused_norm, and packed."""
    params = [_jax_params(2, blocks=3), _jax_params(3, blocks=3)]
    ref = JaxEngine(*params, img_size=SIZE, compute_dtype=jnp.float32,
                    forward="module").run_patient(_volume(), 1.0, -1024.0,
                                                  chunk=4)
    sds = [generator_state_dict_from_jax(p) for p in params]
    for kw in ({}, {"fused_norm": True}, {"forward": "packed"}):
        eng = DualGeneratorEngine(*sds, img_size=SIZE, device="cpu",
                                  compute_dtype=torch.float32, **kw)
        if "forward" not in kw:
            assert eng.st_generator.trunk == "plain"
        got = eng.run_patient(_volume(), 1.0, -1024.0, chunk=4)
        assert got.dtype == np.int16 and got.shape == ref.shape
        d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert float(np.mean(d <= 1)) >= 0.999, kw


@pytest.mark.parametrize("kw,match", [
    ({"trunk": "mega"}, "needs CBAM checkpoints"),
    ({"trunk": "tail"}, "needs CBAM checkpoints"),
    ({"forward": "packed", "trunk": "pallas"}, "needs CBAM checkpoints"),
    ({"forward": "packed", "trunk": "chain3"}, "needs CBAM checkpoints"),
    ({"quant": "trunk"}, "packed forward's XLA trunk"),
], ids=["mega", "tail", "packed-pallas", "packed-chain3", "module-quant"])
def test_engine_refuses_cbam_trunks_without_cbam(kw, match):
    sd = init_generator_state_dict(0, 1, BASE, 1, use_cbam=False)
    with pytest.raises(ValueError, match=match):
        DualGeneratorEngine(sd, sd, img_size=SIZE, device="cpu", **kw)


def test_engine_serves_no_cbam_packed_quant():
    """quant on a no-CBAM pair runs on the packed forward (its XLA trunk's
    dynamic requant), as in JAX; the outputs are finite int16."""
    sd = init_generator_state_dict(0, 1, BASE, 3, use_cbam=False)
    eng = DualGeneratorEngine(sd, sd, img_size=SIZE, device="cpu",
                              compute_dtype=torch.float32, forward="packed",
                              trunk="xla", quant="full")
    out = eng.run_patient(_volume(4), 1.0, -1024.0, chunk=4)
    assert out.dtype == np.int16 and out.shape == (4, SIZE, SIZE)


def test_training_trunk_resolution():
    model = ModelConfig(num_residual_blocks=2, base_channels=BASE)
    assert resolve_trunk("auto", SOFT_TISSUE, model) == "tail"
    assert resolve_trunk("auto", NO_CBAM, model) == "plain"
    assert resolve_trunk("auto", SOFT_TISSUE,
                         replace(model, fused_norm=True)) == "plain"
    assert resolve_trunk("tail", SOFT_TISSUE, model) == "tail"
    with pytest.raises(ValueError, match="needs CBAM checkpoints"):
        build_models(NO_CBAM, model, trunk="tail")


# ------------------------------------------------------------- training
MODEL = ModelConfig(num_residual_blocks=2, base_channels=8,
                    disc_base_channels=8, fused_norm=True)
JAX_MODEL = JaxModelConfig(num_residual_blocks=2, base_channels=8,
                           disc_base_channels=8, fused_norm=True)


@pytest.fixture(scope="module")
def fused_norm_runs():
    jax_run = jax_step_run(jax_replace(JAX_SOFT_TISSUE, use_cbam=False),
                           JAX_MODEL)
    return jax_run, port_step_run(jax_run, NO_CBAM, MODEL)


def test_no_cbam_fused_norm_step_metrics_match_jax(fused_norm_runs):
    jax_run, (state, metrics) = fused_norm_runs
    assert state.g_a2b.fused_norm and not state.g_a2b.use_cbam
    for k, v in jax_run["metrics"].items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-4, err_msg=k)


def test_no_cbam_fused_norm_step_gradients_match_jax(fused_norm_runs):
    jax_run, (state, _) = fused_norm_runs
    check_generator_grads(state, jax_run, MODEL.num_residual_blocks)
