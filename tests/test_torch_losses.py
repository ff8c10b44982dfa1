"""The port's loss suite, loss filters and discriminator against the JAX
package on the CPU, in fp32.

Inputs are made from a seed with numpy and handed to both sides. The loss
terms are held at rtol 1e-5 (fp32 sums in another order), the filters and
the discriminator at atol 1e-5, with and without a per-sample weight
vector and its n_real (the wrap-padded final batch).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.config import LossConfig, TrainConfig
from ducosy_tpu.losses import basic as jbasic
from ducosy_tpu.losses import contrast as jcontrast
from ducosy_tpu.losses import ssim as jssim
from ducosy_tpu.losses import suite as jsuite
from ducosy_tpu.models.discriminator import Discriminator as JaxDiscriminator
from ducosy_tpu.ops import filters as jfilters
from ducosy_tpu_torch.losses import basic, contrast, ssim, suite
from ducosy_tpu_torch.models.convert import (
    discriminator_state_dict_from_jax,
    init_discriminator_state_dict,
)
from ducosy_tpu_torch.models.discriminator import Discriminator
from ducosy_tpu_torch.ops import filters

N, S = 3, 32
WEIGHTS = [None, np.array([1.0, 1.0, 0.0], np.float32)]   # last row padded
T = torch.from_numpy


def _images(seed, n=N, s=S, channel=False):
    rng = np.random.default_rng(seed)
    shape = (n, s, s, 1) if channel else (n, s, s)
    return [rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(3)]


def _close(got, ref, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _both(w):
    return (None, None) if w is None else (T(w), jnp.asarray(w))


@pytest.mark.parametrize("w", WEIGHTS, ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", ["wmean", "wstd_bessel"])
def test_weighted_statistics_match_jax(name, w):
    x, *_ = _images(0)
    tw, jw = _both(w)
    _close(getattr(basic, name)(T(x), tw), getattr(jbasic, name)(x, jw))


@pytest.mark.parametrize("w", WEIGHTS, ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", ["mse", "l1", "gradient_loss"])
def test_pair_losses_match_jax(name, w):
    p, t, _ = _images(1)
    tw, jw = _both(w)
    _close(getattr(basic, name)(T(p), T(t), tw),
           getattr(jbasic, name)(jnp.asarray(p), jnp.asarray(t), jw))


@pytest.mark.parametrize("w", WEIGHTS, ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", ["lsgan_real", "lsgan_fake"])
def test_lsgan_terms_match_jax(name, w):
    logits = np.random.default_rng(2).normal(size=(N, 2, 2, 1)) \
        .astype(np.float32)
    tw, jw = _both(w)
    _close(getattr(basic, name)(T(logits), tw),
           getattr(jbasic, name)(jnp.asarray(logits), jw))


@pytest.mark.parametrize("name,arg", [("box_blur", 7), ("avg_pool", 8),
                                      ("sobel_edges", None)])
def test_loss_filters_match_jax(name, arg):
    x, *_ = _images(3)
    args = () if arg is None else (arg,)
    _close(getattr(filters, name)(T(x), *args),
           getattr(jfilters, name)(jnp.asarray(x), *args), rtol=0, atol=1e-5)


@pytest.mark.parametrize("w", WEIGHTS, ids=["unweighted", "weighted"])
def test_contrast_attention_and_region_match_jax(w):
    p, t, s = _images(4)
    tw, jw = _both(w)
    _close(contrast.contrast_attention_loss(T(p), T(t), T(s), sample_weight=tw),
           jcontrast.contrast_attention_loss(*map(jnp.asarray, (p, t, s)),
                                             sample_weight=jw))
    _close(contrast.contrast_region_loss(T(p), T(t), T(s), sample_weight=tw),
           jcontrast.contrast_region_loss(*map(jnp.asarray, (p, t, s)),
                                          sample_weight=jw))


@pytest.mark.parametrize("w", WEIGHTS, ids=["unweighted", "weighted"])
def test_contrast_edge_matches_jax(w):
    """The top-k set is k = 10% of the real samples' pixels; padded rows
    are pushed to -inf (contrast.py:53-93)."""
    p, t, _ = _images(5)
    tw, jw = _both(w)
    n_real = None if w is None else 2
    _close(contrast.contrast_edge_loss(T(p), T(t), sample_weight=tw,
                                       n_real=n_real),
           jcontrast.contrast_edge_loss(jnp.asarray(p), jnp.asarray(t),
                                        sample_weight=jw, n_real=n_real))


def test_contrast_edge_needs_n_real_with_weights():
    p, t, _ = _images(5)
    with pytest.raises(ValueError, match="n_real"):
        contrast.contrast_edge_loss(T(p), T(t), sample_weight=T(WEIGHTS[1]))


@pytest.mark.parametrize("w", WEIGHTS, ids=["unweighted", "weighted"])
@pytest.mark.parametrize("channel", [False, True], ids=["nhw", "nhwc"])
def test_ssim_matches_jax(channel, w):
    x, y, _ = _images(6, channel=channel)
    tw, jw = _both(w)
    _close(ssim.ssim(T(x), T(y), sample_weight=tw),
           jssim.ssim(jnp.asarray(x), jnp.asarray(y), sample_weight=jw))
    _close(ssim.ssim_loss(T(x), T(y)),
           jssim.ssim_loss(jnp.asarray(x), jnp.asarray(y)))


@functools.lru_cache(maxsize=None)
def _jax_disc(base):
    disc = JaxDiscriminator(1, base)
    params = jax.jit(disc.init)(jax.random.PRNGKey(base),
                                jnp.zeros((1, S, S, 1)))["params"]
    return disc, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("base", [8, 16])
def test_discriminator_matches_flax(base):
    """PatchGAN forward from converted params, with non-zero biases, atol
    1e-5: the asymmetric (2, 1) head padding and IN on convs 2-4."""
    disc, params = _jax_disc(base)
    rng = np.random.default_rng(base)
    params = jax.tree_util.tree_map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
    x, *_ = _images(7, channel=True)
    ref = disc.apply({"params": params}, jnp.asarray(x))
    net = Discriminator(1, base)
    net.load_state_dict({k: T(v) for k, v in
                         discriminator_state_dict_from_jax(params).items()})
    got = net(T(x))
    assert got.shape == ref.shape == (N, S // 16, S // 16, 1)
    _close(got, ref, rtol=0, atol=1e-5)


def test_discriminator_init_matches_layout():
    """The seeded numpy init has the reference key layout and loads."""
    sd = init_discriminator_state_dict(0, 1, 8)
    net = Discriminator(1, 8)
    assert set(net.state_dict()) == set(sd) == {
        f"model.{i}.{k}" for i in (0, 2, 5, 8, 12) for k in ("weight", "bias")}
    net.load_state_dict({k: T(v) for k, v in sd.items()})
    assert abs(float(sd["model.5.weight"].std()) - 0.02) < 2e-3


def _suite_inputs(seed):
    rng = np.random.default_rng(seed)
    img = lambda: rng.uniform(-1, 1, (N, S, S, 1)).astype(np.float32)
    logits = lambda: rng.normal(size=(N, 2, 2, 1)).astype(np.float32)
    names = ("real_a", "real_b", "fake_a", "fake_b", "rec_a", "rec_b",
             "id_a", "id_b")
    kw = {k: img() for k in names}
    kw.update(d_a_fake_logits=logits(), d_b_fake_logits=logits())
    return kw


CFG = TrainConfig()


@pytest.mark.parametrize("w", WEIGHTS, ids=["unweighted", "weighted"])
def test_generator_loss_matches_jax(w):
    """All nine terms and the total, rtol 1e-5."""
    kw = _suite_inputs(8)
    tw, jw = _both(w)
    n_real = None if w is None else 2
    got = suite.generator_loss(**{k: T(v) for k, v in kw.items()}, cfg=CFG,
                               loss_cfg=LossConfig(), sample_weight=tw,
                               n_real=n_real)
    ref = jsuite.generator_loss(**{k: jnp.asarray(v) for k, v in kw.items()},
                                cfg=CFG, sample_weight=jw, n_real=n_real)
    for name, a, b in zip(ref._fields, got, ref):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("w", WEIGHTS, ids=["unweighted", "weighted"])
def test_discriminator_and_validation_losses_match_jax(w):
    kw = _suite_inputs(9)
    tw, jw = _both(w)
    _close(suite.discriminator_loss(T(kw["d_a_fake_logits"]),
                                    T(kw["d_b_fake_logits"]), tw),
           jsuite.discriminator_loss(jnp.asarray(kw["d_a_fake_logits"]),
                                     jnp.asarray(kw["d_b_fake_logits"]), jw))
    _close(suite.validation_generator_loss(
        **{k: T(v) for k, v in kw.items()}, cfg=CFG, sample_weight=tw),
        jsuite.validation_generator_loss(
            **{k: jnp.asarray(v) for k, v in kw.items()}, cfg=CFG,
            sample_weight=jw))


def test_generator_loss_gradient_matches_jax():
    """d total / d fake_b (the contrast terms' input) at rtol 1e-4 of its
    largest entry."""
    kw = _suite_inputs(10)

    def jloss(fb):
        args = {k: jnp.asarray(v) for k, v in kw.items()}
        args["fake_b"] = fb
        return jsuite.generator_loss(**args, cfg=CFG).total

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(kw["fake_b"])))
    args = {k: T(v) for k, v in kw.items()}
    args["fake_b"].requires_grad_()
    suite.generator_loss(**args, cfg=CFG).total.backward()
    got = args["fake_b"].grad.numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))
