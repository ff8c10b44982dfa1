"""The port's (data, sp) mesh serving on the CPU, against the JAX package,
at 32^2 slices, base 8, 1 residual block, fp32, every band on "cpu" (JAX on
its 8 virtual CPU devices). Held, as the JAX package's own sp tests hold it
(tests/test_infer.py:431-486): ``run_patient`` on ``data_sp_mesh`` (2, 4)
and (1, 8) against the JAX single-device engine, and on (2, 4) against
JAX's own (2, 4) engine: |d| <= 1 stored unit on > 99.9% of voxels;
"auto" resolves to the packed forward at trunk="xla"; the module forward
by explicit request; ``generate_batch`` on the first row; a 36-row volume
at sp = 8 raises; every mode JAX refuses under sp raises ``ValueError`` in
both; the port's own refusals (ROADMAP.md Queue 3) beside JAX serving
them. Training on the mesh: tests/test_torch_spatial_train.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.config import ModelConfig as JaxModelConfig
from ducosy_tpu.infer.engine import DualGeneratorEngine as JaxEngine
from ducosy_tpu.models.generator import Generator as JaxGenerator
from ducosy_tpu.parallel import mesh as jmesh
from ducosy_tpu_torch.infer.engine import DualGeneratorEngine
from ducosy_tpu_torch.models.convert import generator_state_dict_from_jax
from ducosy_tpu_torch.parallel.mesh import data_sp_mesh

IMG, BASE = 32, 8
CPU8 = ["cpu"] * 8
SHARE = 0.999


# ------------------------------------------------------------------- (a)
@pytest.fixture(scope="module")
def gen_params():
    init = jax.jit(JaxGenerator(1, 1, BASE).init)
    return [jax.tree_util.tree_map(np.asarray, init(
        jax.random.PRNGKey(seed), jnp.zeros((1, IMG, IMG, 1)))["params"])
        for seed in (0, 1)]


@pytest.fixture(scope="module")
def stored():
    return np.random.default_rng(0).integers(0, 3000, (16, IMG, IMG)) \
        .astype(np.int16)


def _jax_engine(params, **kw):
    return JaxEngine(*params, model_cfg=JaxModelConfig(
        num_residual_blocks=1, base_channels=BASE), img_size=IMG,
        compute_dtype=jnp.float32, **kw)


def _engine(params, **kw):
    return DualGeneratorEngine(
        *(generator_state_dict_from_jax(p) for p in params), img_size=IMG,
        compute_dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def jax_ref(gen_params, stored):
    return _jax_engine(gen_params).run_patient(stored, 1.0, -1024.0, chunk=8)


def _within_one(got, ref):
    assert got.shape == ref.shape and got.dtype == np.int16
    return float(np.mean(np.abs(got.astype(np.int32)
                                - ref.astype(np.int32)) <= 1))


@pytest.mark.parametrize("dp,sp", [(2, 4), (1, 8)])
def test_sp_engine_matches_jax(gen_params, stored, jax_ref, dp, sp):
    """Under sp "auto" serves the packed forward with the XLA trunk, as
    JAX's engine; within 1 stored unit of JAX's single-device engine."""
    eng = _engine(gen_params, mesh=data_sp_mesh(dp, sp, CPU8))
    assert eng.forward_impl == "packed" and eng.trunk == "xla", (dp, sp)
    assert len(eng.replicas) == dp and eng.sp == sp
    got = eng.run_patient(stored, 1.0, -1024.0, chunk=8)
    assert _within_one(got, jax_ref) > SHARE


def test_sp_engine_module_forward_matches_jax(gen_params, stored, jax_ref):
    """The module forward stays available under sp by explicit request."""
    eng = _engine(gen_params, mesh=data_sp_mesh(2, 4, CPU8),
                  forward="module")
    assert eng.forward_impl == "module"
    got = eng.run_patient(stored, 1.0, -1024.0, chunk=8)
    assert _within_one(got, jax_ref) > SHARE


def test_sp_engine_matches_jax_sp_engine(gen_params, stored):
    """The port's (2, 4) engine against JAX's own (2, 4) engine."""
    jeng = _jax_engine(gen_params, mesh=jmesh.data_sp_mesh(2, 4))
    assert (jeng.forward_impl, jeng.trunk) == ("packed", "xla")
    ref = jeng.run_patient(stored, 1.0, -1024.0, chunk=8)
    got = _engine(gen_params, mesh=data_sp_mesh(2, 4, CPU8)).run_patient(
        stored, 1.0, -1024.0, chunk=8)
    assert _within_one(got, ref) > SHARE


def test_sp_engine_generate_batch_on_the_first_row(gen_params, stored):
    """generate_batch serves through the first mesh row: the one-device
    engine's outputs within fp32 rounding."""
    sl = stored[:3].astype(np.float32)
    got = _engine(gen_params, mesh=data_sp_mesh(2, 4, CPU8)) \
        .generate_batch(sl, 1.0, -1024.0)
    ref = _engine(gen_params, device="cpu", forward="packed",
                  trunk="xla").generate_batch(sl, 1.0, -1024.0)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=2e-3,
                                   err_msg=k)


def test_sp_engine_height_and_chunk_refusals(gen_params, stored):
    """A 36-row volume at sp = 8 and a chunk that the data axis does not
    divide raise ValueError, in both packages."""
    odd = np.random.default_rng(1).integers(0, 10, (16, 36, 36)) \
        .astype(np.int16)
    for run_patient in (
            _jax_engine(gen_params, mesh=jmesh.data_sp_mesh(1, 8))
            .run_patient,
            _engine(gen_params, mesh=data_sp_mesh(1, 8, CPU8)).run_patient):
        with pytest.raises(ValueError, match="not divisible by sp"):
            run_patient(odd, 1.0, -1024.0, chunk=8)
    for run_patient in (
            _jax_engine(gen_params, mesh=jmesh.data_sp_mesh(2, 4))
            .run_patient,
            _engine(gen_params, mesh=data_sp_mesh(2, 4, CPU8)).run_patient):
        with pytest.raises(ValueError, match="not divisible by data"):
            run_patient(stored, 1.0, -1024.0, chunk=3)


@pytest.mark.parametrize("kw", [
    {"trunk": "mono"}, {"trunk": "mega"}, {"trunk": "pallas"},
    {"trunk": "chain3"}, {"quant": "trunk"}, {"quant": "full"},
    {"trunk_int8": True}, {"fused_norm": True},
    {"forward": "module", "trunk": "xla"}],
    ids=["mono", "mega", "pallas", "chain3", "quant-trunk", "quant-full",
         "trunk-int8", "fused-norm", "module-xla"])
def test_sp_engine_refuses_what_jax_refuses(gen_params, kw):
    """The kernel trunks, the quantized modes and fused_norm under sp, and
    a packed trunk name on the module forward: ValueError in both."""
    with pytest.raises(ValueError):
        _jax_engine(gen_params, mesh=jmesh.data_sp_mesh(2, 4), **kw)
    with pytest.raises(ValueError):
        _engine(gen_params, mesh=data_sp_mesh(2, 4, CPU8), **kw)


@pytest.mark.parametrize("img_size,sp", [(30, 2), (16, 8)],
                         ids=["img-not-4", "fewer-bands"])
def test_sp_engine_refuses_bands_it_cannot_cut(gen_params, img_size, sp):
    """Deliberate differences (ROADMAP.md Queue 3): JAX serves an img_size
    that does not divide by 4 (on its module forward; run here) and fewer
    4-row groups than sp devices (resolved here; XLA's partitioner
    replicates what it cannot split); the port's bands need whole 4-row
    groups, so it raises at construction."""
    jeng = JaxEngine(*gen_params, model_cfg=JaxModelConfig(
        num_residual_blocks=1, base_channels=BASE), img_size=img_size,
        compute_dtype=jnp.float32, mesh=jmesh.data_sp_mesh(1, sp))
    assert jeng.forward_impl == ("module" if img_size % 4 else "packed")
    if img_size % 4:
        out = jeng.run_patient(np.zeros((2, IMG, IMG), np.int16), 1.0,
                               -1024.0, chunk=2)
        assert out.shape == (2, IMG, IMG)
    with pytest.raises(ValueError, match="row bands need"):
        DualGeneratorEngine(
            *(generator_state_dict_from_jax(p) for p in gen_params),
            img_size=img_size, compute_dtype=torch.float32,
            mesh=data_sp_mesh(1, sp, CPU8))
