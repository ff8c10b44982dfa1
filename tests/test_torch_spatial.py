"""The port's row bands (parallel/spatial.py) and the generator forwards on
them (models/banded.py) on the CPU, at 32^2, base 8, 1-2 residual blocks,
fp32, the bands of sp = 2, 4 and 8 all on "cpu" (sp = 8 leaves one row a
band at H/4, thinner than the spatial gate's 3-row halo). Held:
  - each primitive against its whole-image version: ``window`` with every
    padding kind (reflect, zeros, the packed head's phase reflection, the
    2-channel gate map's rows) exactly; ``instance_norm`` with groups 1, 4
    and 16 and ``cbam`` at 1e-6; ``split``/``gather`` exactly, with
    gradients;
  - the banded module and packed (trunk="xla") forwards against JAX's
    ``Generator.apply`` and ``generator_apply_packed(trunk="xla")``, with
    and without CBAM and with a 3-channel stem, at rtol/atol 1e-5;
  - their parameter and input gradients against the unbanded port's at
    relative L2 1e-5, plain and under ``checkpoint``;
  - the refusals: band plans, meshes, generators that hold kernels.
The sp engine and the sp training step against the JAX package:
tests/test_torch_spatial_mesh.py and tests/test_torch_spatial_train.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ducosy_tpu.models import fused as jf
from ducosy_tpu.models.generator import Generator as JaxGenerator
from ducosy_tpu.parallel import mesh as jmesh
from ducosy_tpu_torch.models import banded
from ducosy_tpu_torch.models import fused as tf
from ducosy_tpu_torch.models.convert import generator_state_dict_from_jax, \
    init_generator_state_dict
from ducosy_tpu_torch.models.generator import Generator
from ducosy_tpu_torch.models.layers import instance_norm
from ducosy_tpu_torch.ops.kernels.block_tail import _spatial_stat, \
    cbam_plain
from ducosy_tpu_torch.ops.kernels.instance_norm import instance_norm_plain
from ducosy_tpu_torch.parallel import spatial
from ducosy_tpu_torch.parallel.mesh import data_sp_mesh, mesh_shape

SIZE, BASE = 32, 8
SPS = [2, 4, 8]
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-5


def _plan(sp, height=SIZE):
    return spatial.band_plan(height, ["cpu"] * sp)


def _rows(plan, f):
    e = plan.rows(f)
    return list(zip(e, e[1:]))


# ------------------------------------------------------------ primitives
@pytest.mark.parametrize("sp", SPS)
def test_band_plan(sp):
    """Edges on multiples of 4 rows, bands as equal as the groups allow,
    whole rows at H/2 and H/4."""
    plan = spatial.band_plan(44, ["cpu"] * sp)
    sizes = np.diff(plan.edges)
    assert plan.edges[0] == 0 and plan.edges[-1] == 44
    assert all(s % 4 == 0 and s > 0 for s in sizes)
    assert sizes.max() - sizes.min() <= 4
    for f in (2, 4):
        assert plan.rows(f)[-1] * f == 44


PADS = [(3, 3, "reflect"), (1, 1, "reflect"), (1, 0, "zeros"),
        (1, 1, "zeros"), (3, 3, "zeros")]


@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("sp", SPS)
def test_window_matches_the_padded_image(sp, f):
    """Each band's window is its rows of the whole padded image, whatever
    the band's height against the halo (one row a band at sp = 8, f = 4)."""
    plan = _plan(sp)
    x = torch.from_numpy(np.random.default_rng(sp * f).standard_normal(
        (2, SIZE // f, 5, 3)).astype(np.float32))
    bands = spatial.split(x, plan, f)
    for top, bot, pad in PADS:
        if pad == "reflect" and top >= SIZE // f:
            continue
        if pad == "reflect":
            whole = F.pad(x.permute(0, 3, 1, 2), (0, 0, top, bot),
                          mode="reflect").permute(0, 2, 3, 1)
        else:
            whole = F.pad(x, (0, 0, 0, 0, top, bot))
        got = spatial.window(bands, plan, f, top, bot, pad)
        for (lo, hi), g in zip(_rows(plan, f), got):
            torch.testing.assert_close(g, whole[:, lo:hi + top + bot],
                                       rtol=0, atol=0)


@pytest.mark.parametrize("sp", SPS)
def test_window_of_the_gate_map(sp):
    """The spatial gate's (N, 2, H, W) map, rows on dim 2, zeros beyond the
    image: 3 rows a side, from up to 3 neighbours at H/4."""
    plan = _plan(sp)
    t = torch.randn(2, SIZE // 4, 6, 16)
    stat = _spatial_stat(t)
    whole = F.pad(stat, (0, 0, 3, 3))
    got = spatial.window(spatial.split(stat, plan, 4, dim=2), plan, 4, 3, 3,
                         "zeros", dim=2)
    for (lo, hi), g in zip(_rows(plan, 4), got):
        torch.testing.assert_close(g, whole[:, :, lo:hi + 6], rtol=0, atol=0)


@pytest.mark.parametrize("sp", SPS)
def test_window_packed16_edge(sp):
    """The packed head's reflect pad 3 in rows: the window with the phase
    reflection at the global edges, then each band's columns, is the
    whole ``packed16_reflect_pad3``."""
    plan, c = _plan(sp), 3
    x = torch.randn(2, SIZE // 4, 5, 16 * c)
    whole = tf.packed16_reflect_pad3(x, c)
    edge = lambda row, side: tf.packed16_edge(row, c, 1, side)
    got = spatial.window(spatial.split(x, plan, 4), plan, 4, 1, 1, edge)
    for (lo, hi), g in zip(_rows(plan, 4), got):
        g = torch.cat([tf.packed16_edge(g[:, :, :1], c, 2, "pre"), g,
                       tf.packed16_edge(g[:, :, -1:], c, 2, "post")], dim=2)
        torch.testing.assert_close(g, whole[:, lo:hi + 2], rtol=0, atol=0)


@pytest.mark.parametrize("groups,f", [(1, 1), (1, 4), (4, 2), (16, 4)])
@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_over_bands(sp, groups, f, relu):
    """Two-pass fp32 statistics over the whole image (phase groups pooled)
    against ``layers.instance_norm`` / ``instance_norm_plain``."""
    plan = _plan(sp)
    x = torch.from_numpy((np.random.default_rng(groups + f).standard_normal(
        (2, SIZE // f, 6, 8 * groups)) * 3 + 1).astype(np.float32))
    got = spatial.gather(spatial.instance_norm(
        spatial.split(x, plan, f), relu=relu, groups=groups), "cpu")
    ref = instance_norm_plain(x, relu=relu, phases=groups) if groups > 1 \
        else (torch.relu(instance_norm(x)) if relu else instance_norm(x))
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sp", SPS)
def test_cbam_over_bands(sp):
    """The channel gate's pools over all bands and the 7x7 gate on the
    exchanged 2-channel map against ``cbam_plain`` of the whole image."""
    plan = _plan(sp)
    rng = np.random.default_rng(sp)
    y = torch.from_numpy(rng.standard_normal((2, SIZE // 4, 6, 32))
                         .astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((32, 2)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((2, 32)).astype(np.float32))
    wsa = torch.from_numpy(rng.standard_normal((7, 7, 2, 1))
                           .astype(np.float32))
    got = spatial.gather(spatial.cbam(spatial.split(y, plan, 4), plan, 4,
                                      w1, w2, lambda dev: wsa), "cpu")
    torch.testing.assert_close(got, cbam_plain(y, w1, w2, wsa), rtol=1e-6,
                               atol=1e-6)


def test_split_and_gather_are_differentiable():
    plan = _plan(4)
    x = torch.randn(2, SIZE, 4, 3, requires_grad=True)
    w = torch.randn(2, SIZE, 4, 3)
    y = spatial.gather(spatial.split(x, plan), "cpu")
    assert torch.equal(y, x)
    (y * w).sum().backward()
    assert torch.equal(x.grad, w)


# ------------------------------------------------------------- forwards
@functools.lru_cache(maxsize=None)
def _jax_params(seed, cbam=True, in_ch=1, blocks=2):
    gen = JaxGenerator(in_ch, blocks, BASE, use_cbam=cbam, dtype=jnp.float32)
    p = jax.jit(gen.init)(jax.random.PRNGKey(seed),
                          jnp.zeros((1, SIZE, SIZE, in_ch)))
    return jax.tree_util.tree_map(np.asarray, p["params"])


@functools.lru_cache(maxsize=None)
def _jax_forward(forward, cbam, in_ch):
    p = _jax_params(0, cbam, in_ch)
    x = _input(in_ch)
    if forward == "module":
        gen = JaxGenerator(in_ch, 2, BASE, use_cbam=cbam, dtype=jnp.float32)
        return np.asarray(gen.apply({"params": p}, jnp.asarray(x)))
    return np.asarray(jf.generator_apply_packed(
        p, jnp.asarray(x), num_residual_blocks=2, use_cbam=cbam,
        dtype=jnp.float32, trunk="xla"))


def _input(in_ch, n=2, seed=1):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, SIZE, SIZE, in_ch)).astype(np.float32)


MODELS = [(True, 1), (False, 1), (True, 3)]
MODEL_IDS = ["cbam", "no-cbam", "cbam-3ch"]


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("cbam,in_ch", MODELS, ids=MODEL_IDS)
@pytest.mark.parametrize("forward", banded.FORWARDS)
def test_banded_forward_matches_jax(forward, cbam, in_ch, sp):
    """The serving wrapper (weights laid out once per device) against the
    JAX package's whole-image forward."""
    sd = generator_state_dict_from_jax(_jax_params(0, cbam, in_ch))
    gen = banded.BandedGenerator(sd, devices=["cpu"] * sp,
                                 dtype=torch.float32, forward=forward)
    with torch.no_grad():
        got = gen(torch.from_numpy(_input(in_ch)))
    assert got.shape == (2, SIZE, SIZE, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_forward(forward, cbam,
                                                         in_ch), **FWD_TOL)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@functools.lru_cache(maxsize=None)
def _grad_generator():
    return Generator.from_state_dict(init_generator_state_dict(4, 3, BASE, 2),
                                     trunk="plain")


def _grads(fn, remat):
    """Parameter and input gradients of a row-weighted loss of fn's output
    (``_grad_generator``'s parameters)."""
    gen = _grad_generator()
    gen.zero_grad()
    x = torch.from_numpy(_input(3)).requires_grad_(True)
    y = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    (y * torch.linspace(-1, 1, SIZE)[None, :, None, None]).sum().backward()
    return torch.cat([p.grad.reshape(-1) for p in gen.parameters()]), x.grad


@functools.lru_cache(maxsize=None)
def _whole_grads(forward):
    gen = _grad_generator()
    whole = gen if forward == "module" else functools.partial(
        tf.generator_apply_packed, gen, trunk="xla", encoder_fused=False)
    return _grads(whole, False)


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("forward", banded.FORWARDS)
@pytest.mark.parametrize("remat", [False, True])
def test_banded_gradients_match_the_port(forward, sp, remat):
    """Parameter and input gradients of a row-weighted loss through the
    banded training forward, plain and under ``checkpoint``, against the
    unbanded port's (the module, or ``generator_apply_packed(trunk=
    "xla")``), 3-channel stem with CBAM."""
    ref_p, ref_x = _whole_grads(forward)
    got_p, got_x = _grads(lambda x: banded.banded_apply(
        _grad_generator(), x, ["cpu"] * sp, forward=forward), remat)
    assert _rel(got_p, ref_p) < GRAD_REL
    assert _rel(got_x, ref_x) < GRAD_REL


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("dp,sp,n", [(2, 4, 8), (1, 8, 8), (2, 2, 5),
                                     (3, 3, 8), (1, 1, 1)])
def test_data_sp_mesh_matches_jax(dp, sp, n):
    """The first dp * sp devices in rows of sp, or JAX's error."""
    devs = ["cpu"] * n
    if dp * sp > n:
        with pytest.raises(ValueError, match=f"mesh {dp}x{sp} exceeds {n} "
                                             "devices"):
            jmesh.data_sp_mesh(dp, sp, jax.devices()[:n])
        with pytest.raises(ValueError, match=f"mesh {dp}x{sp} exceeds {n} "
                                             "devices"):
            data_sp_mesh(dp, sp, devs)
        return
    got = data_sp_mesh(dp, sp, devs)
    assert mesh_shape(got) == (dp, sp)
    assert jmesh.data_sp_mesh(dp, sp, jax.devices()[:n]).devices.shape \
        == (dp, sp)
    assert got == ((torch.device("cpu"),) * sp,) * dp


@pytest.mark.parametrize("height,sp,match", [
    (30, 2, "divide by 4"), (16, 8, "fewer than sp"), (8, 3, "fewer")])
def test_band_plan_refusals(height, sp, match):
    with pytest.raises(ValueError, match=match):
        spatial.band_plan(height, ["cpu"] * sp)


@pytest.mark.parametrize("trunk,kw", [("tail", {}), ("chain", {}),
                                      ("plain", {"fused_norm": True})])
def test_banded_training_refuses_kernel_generators(trunk, kw):
    """A generator whose forward holds kernels raises under sp, as the JAX
    engine refuses them: train with the plain trunk."""
    sd = init_generator_state_dict(0, 1, BASE, 1)
    gen = Generator.from_state_dict(sd, trunk=trunk, **kw)
    with pytest.raises(ValueError, match="only the plain trunk"):
        banded.banded_apply(gen, torch.zeros(1, SIZE, SIZE, 1),
                            ["cpu", "cpu"])
