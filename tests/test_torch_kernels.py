"""Plain versions of the port's kernels against the JAX package's Pallas
kernels, on the CPU, and the port's autograd Functions against jax.vjp.

The Pallas kernels run in interpret mode here, as tests/test_pallas.py and
tests/test_conv_in.py run them; the port's CUDA kernels themselves run only
on the card (chip_smoke.py compares each with its plain version there).
Inputs are made from a seed with numpy; all in fp32.
"""
import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.ops.pallas.cbam_block import (
    _analytic_tail_bwd,
    block_tail_bwd_pallas,
    block_tail_fused as jax_block_tail_fused,
    block_tail_pallas,
)
from ducosy_tpu.ops.pallas.conv_in import residual_chain_pallas
from ducosy_tpu.ops.pallas.instance_norm import (
    instance_norm_bwd_pallas,
    instance_norm_fused as jax_instance_norm_fused,
    instance_norm_pallas,
    reflect_pad_adjoint as jax_reflect_pad_adjoint,
)
from ducosy_tpu_torch.models.layers import reflect_pad_adjoint
from ducosy_tpu_torch.ops.kernels import _build
from ducosy_tpu_torch.ops.kernels import block_tail as k4
from ducosy_tpu_torch.ops.kernels import instance_norm as k2
from ducosy_tpu_torch.ops.kernels import residual_chain as k1

EPS = 1e-5
T = torch.from_numpy


def _chain_inputs(k, n=2, hw=14, c=32, seed=0):
    rng = np.random.default_rng(seed)
    r = c // 16
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    return (f(n, hw, hw, c), f(k, 3, 3, c, c, std=0.1), f(k, 3, 3, c, c, std=0.1),
            f(k, c, r, std=0.3), f(k, r, c, std=0.3), f(k, 7, 7, 2, 1, std=0.3),
            f(k, c, std=2.0), f(k, c, std=2.0))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("pad", [0, 1])
def test_instance_norm_plain_matches_pallas(relu, pad):
    """K2's plain version vs instance_norm_pallas (interpret), atol 1e-5."""
    x = np.random.default_rng(1).normal(0.5, 2.0, (2, 16, 16, 64)) \
        .astype(np.float32)
    ref = instance_norm_pallas(jnp.asarray(x), relu=relu, pad=pad,
                               interpret=True)
    got = k2.instance_norm_plain(torch.from_numpy(x), relu=relu, pad=pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("pad", [0, 1])
def test_residual_chain_plain_matches_pallas(k, pad):
    """K1 (K6 at k=1): the plain version, WITH conv biases, vs the bias-free
    residual_chain_pallas (interpret) on a (2, 14, 14, 32) carry. The
    biases cancel under each InstanceNorm, so only rounding differs:
    atol 2e-4."""
    xp, was, wbs, w1s, w2s, wsas, b1s, b2s = _chain_inputs(k)
    ref = residual_chain_pallas(*map(jnp.asarray, (xp, was, wbs, w1s, w2s,
                                                   wsas)),
                                pad=pad, interpret=True)
    t = [torch.from_numpy(a) for a in (xp, was, wbs, w1s, w2s, wsas, b1s, b2s)]
    got = k1.residual_chain_plain(*t[:6], pad=pad, b1s=t[6], b2s=t[7])
    assert got.shape == ref.shape == (2, 12 + 2 * pad, 12 + 2 * pad, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=0)


def test_wrappers_run_plain_on_cpu_without_counting():
    """A CPU tensor takes the plain version, and no launch is counted."""
    xp, *ws, _, _ = [torch.from_numpy(a) for a in _chain_inputs(3)]
    before = (k1.residual_chain.launches, k2.instance_norm.launches)
    torch.testing.assert_close(k1.residual_chain(xp, *ws, pad=0),
                               k1.residual_chain_plain(xp, *ws, pad=0),
                               rtol=0, atol=0)
    torch.testing.assert_close(k2.instance_norm(xp, relu=True, pad=1),
                               k2.instance_norm_plain(xp, relu=True, pad=1),
                               rtol=0, atol=0)
    assert (k1.residual_chain.launches, k2.instance_norm.launches) == before


def test_wrappers_refuse_other_devices():
    """Neither wrapper falls back: a tensor that is on neither the CPU nor
    a CUDA card is refused before any build or launch."""
    xp = torch.empty((1, 10, 10, 64), device="meta")
    w = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        k2.instance_norm(xp, relu=True, pad=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k1.residual_chain(xp, w(1, 3, 3, 64, 64), w(1, 3, 3, 64, 64),
                          w(1, 64, 4), w(1, 4, 64), w(1, 7, 7, 2, 1))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler failure surfaces as RuntimeError with nvcc's output, and
    the log is kept beside the would-be library."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: deliberate' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="deliberate"):
            _build.load_library("residual_chain")
    finally:
        _build.load_library.cache_clear()
    assert "deliberate" in _build.build_log("residual_chain")
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_path_follows_sources(tmp_path, monkeypatch):
    """An edited source gets a new library name, never a stale build."""
    src = tmp_path / "csrc"
    src.mkdir()
    for p in _build.CSRC_DIR.iterdir():
        (src / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    before = _build.library_path("instance_norm")
    with open(src / "common.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path("instance_norm") != before
    assert os.path.dirname(before) == str(_build.BUILD_DIR)


# ------------------------------------------------------------- training
def _in_bwd_inputs(pad, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 2.0, (2, 16, 16, 64)).astype(np.float32)
    g = rng.normal(0.0, 1.0, (2, 16 + 2 * pad, 16 + 2 * pad, 64)) \
        .astype(np.float32)
    return x, g


@pytest.mark.parametrize("pad", [1, 2])
def test_reflect_pad_adjoint_matches_jax(pad):
    g = np.random.default_rng(pad).normal(size=(2, 10, 12, 3)) \
        .astype(np.float32)
    np.testing.assert_allclose(reflect_pad_adjoint(T(g), pad).numpy(),
                               np.asarray(jax_reflect_pad_adjoint(
                                   jnp.asarray(g), pad)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("pad", [0, 1])
def test_instance_norm_bwd_plain_matches_pallas(relu, pad):
    """K3's plain version vs instance_norm_bwd_pallas (interpret), atol
    1e-5."""
    x, g = _in_bwd_inputs(pad)
    ref = instance_norm_bwd_pallas(jnp.asarray(x), jnp.asarray(g), relu=relu,
                                   pad=pad, interpret=True)
    got = k2.instance_norm_bwd_plain(T(x), T(g), relu=relu, pad=pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("pad", [0, 1])
def test_instance_norm_fused_matches_jax_vjp(relu, pad):
    """The port's K2/K3 autograd Function on the CPU vs jax.vjp of
    instance_norm_fused: forward and dx, atol 1e-5."""
    x, g = _in_bwd_inputs(pad, seed=3)
    y, vjp = jax.vjp(lambda a: jax_instance_norm_fused(a, relu, EPS, pad),
                     jnp.asarray(x))
    xt = T(x).requires_grad_()
    out = k2.instance_norm_fused(xt, relu=relu, pad=pad)
    out.backward(T(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=1e-5, rtol=0)


def _tail_inputs(pad, x_pad, seed=4, ties=False):
    """h (2, 12, 12, 32), the padded skip, R = 2 weights, and g. With
    ``ties``, channels 1-2 copy channel 0 (and w2's columns copy column 0,
    so their gates match): t ties across channels at every pixel; and the
    per-channel max of h is written at two more pixels: y ties across
    pixels at its max."""
    rng = np.random.default_rng(seed)
    n, hw, c, r = 2, 12, 32, 2
    f = lambda *s, std=1.0, mean=0.0: rng.normal(mean, std, s) \
        .astype(np.float32)
    h = f(n, hw, hw, c, std=1.5, mean=0.3)
    w2 = f(r, c, std=0.3)
    if ties:
        h[..., 1:3] = h[..., :1]
        w2[:, 1:3] = w2[:, :1]
        h[:, 0, 0] = h[:, 5, 7] = h.max(axis=(1, 2))
    return (h, f(n, hw + 2 * x_pad, hw + 2 * x_pad, c), f(c, r, std=0.3), w2,
            f(7, 7, 2, 1, std=0.3), f(n, hw + 2 * pad, hw + 2 * pad, c))


TAIL_CASES = [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("pad,x_pad", TAIL_CASES)
def test_block_tail_plain_matches_pallas(pad, x_pad):
    """K4's plain version vs block_tail_pallas (interpret), atol 1e-5."""
    h, x, w1, w2, wsa, _ = _tail_inputs(pad, x_pad)
    ref = block_tail_pallas(*map(jnp.asarray, (h, x, w1, w2, wsa)), pad=pad,
                            x_pad=x_pad, interpret=True)
    got = k4.block_tail_plain(*map(T, (h, x, w1, w2, wsa)), pad=pad,
                              x_pad=x_pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def _check_tail_bwd(pad, x_pad, ties):
    h, x, w1, w2, wsa, g = _tail_inputs(pad, x_pad, ties=ties)
    refs = (block_tail_bwd_pallas(*map(jnp.asarray, (h, g, w1, w2, wsa)),
                                  pad=pad, x_pad=x_pad, interpret=True),
            _analytic_tail_bwd(*map(jnp.asarray, (h, w1, w2, wsa, g)), EPS,
                               pad, x_pad))
    got = k4.block_tail_bwd_plain(*map(T, (h, g, w1, w2, wsa)), pad=pad,
                                  x_pad=x_pad)
    for ref in refs:
        for name, a, b in zip(("dh", "dx", "dw1", "dw2", "dwsa"), got, ref):
            assert a.shape == b.shape, name
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                       rtol=0, err_msg=name)


@pytest.mark.parametrize("pad,x_pad", TAIL_CASES)
def test_block_tail_bwd_plain_matches_pallas_and_analytic(pad, x_pad):
    """K5's plain version vs block_tail_bwd_pallas (interpret) and the
    analytic adjoint _analytic_tail_bwd: every cotangent, atol 1e-4."""
    _check_tail_bwd(pad, x_pad, ties=False)


def test_block_tail_bwd_plain_splits_tied_maxima():
    """With forced ties in both max pools the gradient splits equally among
    the tied maxima, as the JAX package's adjoints split it."""
    h, *_ = _tail_inputs(1, 1, ties=True)
    assert (h[..., 1] == h[..., 0]).all()
    assert (h.max(axis=(1, 2)) == h[:, 0, 0]).all()
    _check_tail_bwd(1, 1, ties=True)


@pytest.mark.parametrize("pad,x_pad", TAIL_CASES)
def test_block_tail_fused_matches_jax_vjp(pad, x_pad):
    """The port's K4/K5 autograd Function on the CPU vs jax.vjp of
    block_tail_fused: forward atol 1e-5, every gradient atol 1e-4."""
    h, x, w1, w2, wsa, g = _tail_inputs(pad, x_pad, seed=5)
    y, vjp = jax.vjp(lambda *a: jax_block_tail_fused(*a, EPS, pad, x_pad),
                     *map(jnp.asarray, (h, x, w1, w2, wsa)))
    ts = [T(a).requires_grad_() for a in (h, x, w1, w2, wsa)]
    out = k4.block_tail_fused(*ts, pad=pad, x_pad=x_pad)
    out.backward(T(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               atol=1e-5, rtol=0)
    for t, ref in zip(ts, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=0)


def test_training_wrappers_run_plain_on_cpu_without_counting():
    h, x, w1, w2, wsa, g = map(T, _tail_inputs(1, 1))
    xi, gi = map(T, _in_bwd_inputs(1))
    counters = (k2.instance_norm_bwd, k4.block_tail, k4.block_tail_bwd)
    before = [f.launches for f in counters]
    torch.testing.assert_close(
        k2.instance_norm_bwd(xi, gi, relu=True, pad=1),
        k2.instance_norm_bwd_plain(xi, gi, relu=True, pad=1), rtol=0, atol=0)
    torch.testing.assert_close(
        k4.block_tail(h, x, w1, w2, wsa, pad=1, x_pad=1),
        k4.block_tail_plain(h, x, w1, w2, wsa, pad=1, x_pad=1), rtol=0, atol=0)
    for a, b in zip(k4.block_tail_bwd(h, g, w1, w2, wsa, pad=1, x_pad=1),
                    k4.block_tail_bwd_plain(h, g, w1, w2, wsa, pad=1,
                                            x_pad=1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [f.launches for f in counters] == before


def test_training_wrappers_refuse_other_devices():
    """No fallback in the training kernels either."""
    m = lambda *s: torch.empty(s, device="meta")
    h, xp = m(1, 8, 8, 64), m(1, 10, 10, 64)
    w = (m(64, 4), m(4, 64), m(7, 7, 2, 1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        k2.instance_norm_bwd(h, xp, relu=True, pad=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k4.block_tail(h, xp, *w, pad=1, x_pad=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k4.block_tail_bwd(h, xp, *w, pad=1, x_pad=1)
