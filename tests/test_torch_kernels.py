"""Plain versions of the port's kernels against the JAX package's Pallas
kernels, on the CPU.

The Pallas kernels run in interpret mode here, as tests/test_pallas.py and
tests/test_conv_in.py run them; the port's CUDA kernels themselves run only
on the card (chip_smoke.py compares each with its plain version there).
Inputs are made from a seed with numpy.
"""
import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.ops.pallas.conv_in import residual_chain_pallas
from ducosy_tpu.ops.pallas.instance_norm import instance_norm_pallas
from ducosy_tpu_torch.ops.kernels import _build
from ducosy_tpu_torch.ops.kernels import instance_norm as k2
from ducosy_tpu_torch.ops.kernels import residual_chain as k1


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
