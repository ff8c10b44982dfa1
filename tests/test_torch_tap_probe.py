"""P3 (the int8 / bf16 tap-matmul probe) on the CPU.

The TPU probe (scripts/probe_int8_mosaic.py) sums ``taps`` products a @ b
into one accumulator inside one pallas_call: ``_kernel`` int8 -> int32,
``_kernel_bf16`` bf16 -> fp32. The port's ``tap_matmul`` runs its kernel on
the card and its plain version on the CPU. What a CPU can hold of it: the
plain path against the probe's own Pallas kernels in interpret mode, at 1, 9
and 36 taps on shapes the kernel's tile plan takes; the plan itself at the
probe's shape, its shared memory, and its refusals; that a CUDA tensor
reaches the kernel's entry point and nothing else, and the by-parts probe
its own entry points uncounted; and that a tensor on neither the CPU nor a
card is refused. Inputs are made from a seed with numpy; tolerances are
stated per test.
"""
import contextlib
import functools
import importlib.util
import os
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ducosy_tpu_torch.ops.kernels import _build
from ducosy_tpu_torch.ops.kernels import tap_probe as tap

PROBE = Path(__file__).resolve().parents[1] / "scripts" / \
    "probe_int8_mosaic.py"
PROBE_SHAPE = (16384, 256, 256)
# (m, k, n) the kernel's plan takes in both dtypes: one and two chunks of
# int8 K (two and four of bf16), one and two blocks of rows
SHAPES = [(128, 128, 256), (256, 256, 256)]
BF16_RTOL = 1e-5   # of max |ref|: fp32 sums in another order


@functools.cache
def _probe_module():
    """scripts/probe_int8_mosaic.py as a module. Loading it puts the repo on
    sys.path and sets a default compilation-cache directory in the
    environment; both are put back (jax, imported already, reads neither)."""
    saved_env, saved_path = dict(os.environ), list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location("probe_int8_mosaic",
                                                      PROBE)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(saved_env)
        sys.path[:] = saved_path
    return mod


def _operands(m, k, n, dtype, seed):
    """a (m, k), b (k, n) as the probe draws them: int8 in [-127, 127] or
    standard normals rounded to bf16 (as jnp arrays and as torch tensors of
    the same values)."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        a = rng.integers(-127, 128, (m, k)).astype(np.int8)
        b = rng.integers(-127, 128, (k, n)).astype(np.int8)
        return (jnp.asarray(a), jnp.asarray(b),
                torch.from_numpy(a), torch.from_numpy(b))
    ja = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    jb = jnp.asarray(rng.standard_normal((k, n)), jnp.bfloat16)
    to_t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16)
    return ja, jb, to_t(ja), to_t(jb)


# ---- the plain path against the probe's Pallas kernels


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("taps", [1, 9, 36])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_tap_matmul_matches_the_probe_kernel(dtype, taps, shape):
    """tap_matmul on CPU tensors (the plain version, uncounted) against the
    probe's _kernel / _kernel_bf16 through pl.pallas_call in interpret mode:
    int8 exact; bf16 within 1e-5 of max |ref| (the probe adds one fp32
    product a tap, the plain version scales one product by taps)."""
    m, k, n = shape
    tap.tap_plan(m, k, n, torch.int8 if dtype == "int8" else torch.bfloat16)
    mod = _probe_module()
    ja, jb, ta, tb = _operands(m, k, n, dtype, seed=taps + m)
    kern = mod._kernel if dtype == "int8" else mod._kernel_bf16
    out_t = jnp.int32 if dtype == "int8" else jnp.float32
    ref = np.asarray(pl.pallas_call(
        functools.partial(kern, taps=taps),
        out_shape=jax.ShapeDtypeStruct((m, n), out_t), interpret=True)(ja, jb))
    before = tap.tap_matmul.launches
    got = tap.tap_matmul(ta, tb, taps)
    assert tap.tap_matmul.launches == before
    assert got.shape == (m, n)
    if dtype == "int8":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=BF16_RTOL * np.abs(ref).max())


# ---- the tile plan


@pytest.mark.parametrize("dtype,chunk_k,chunks,smem", [
    (torch.int8, 128, 2, 384 * 256 + 1024),
    (torch.bfloat16, 64, 4, 384 * 256 * 2 + 1024)], ids=["int8", "bf16"])
def test_plan_at_the_probe_shape(dtype, chunk_k, chunks, smem):
    """At (16384, 256) x (256, 256): 128 blocks of 128 rows x all 256
    columns, K in chunks of 128 bytes, both operands resident in at most
    the 227 KB a block may use."""
    m, k, n = PROBE_SHAPE
    plan = tap.tap_plan(m, k, n, dtype)
    assert plan == tap.TapPlan(blocks=128, chunk_k=chunk_k, chunks=chunks,
                               smem=smem)
    assert plan.smem <= tap.SMEM_MAX == 227 * 1024


@pytest.mark.parametrize("dtype,k_max", [(torch.int8, 512),
                                         (torch.bfloat16, 256)],
                         ids=["int8", "bf16"])
def test_plan_keeps_the_largest_k_within_shared_memory(dtype, k_max):
    """The largest K the plan takes (both operands resident: 384 rows of K
    elements) fills no more than a block's shared memory, and one chunk more
    is refused."""
    size = 1 if dtype == torch.int8 else 2
    plan = tap.tap_plan(128, k_max, 256, dtype)
    assert plan.smem == 384 * k_max * size + 1024 <= tap.SMEM_MAX
    assert plan.chunks * plan.chunk_k == k_max
    with pytest.raises(ValueError, match="shared memory"):
        tap.tap_plan(128, k_max + plan.chunk_k, 256, dtype)


@pytest.mark.parametrize("m,k,n,dtype,err", [
    (100, 256, 256, torch.int8, ValueError),       # M not a multiple of 128
    (0, 256, 256, torch.int8, ValueError),
    (128, 256, 128, torch.int8, ValueError),       # N other than 256
    (128, 256, 512, torch.int8, ValueError),
    (128, 64, 256, torch.int8, ValueError),        # K below one int8 chunk
    (128, 96, 256, torch.bfloat16, ValueError),    # K not a bf16 chunk
    (128, 320, 256, torch.bfloat16, ValueError),   # 245 KB of operands
    (128, 256, 256, torch.float32, TypeError),
    (128, 256, 256, torch.float16, TypeError),
], ids=["m-ragged", "m-zero", "n-128", "n-512", "k-int8", "k-bf16",
        "smem", "fp32", "fp16"])
def test_plan_refuses_what_the_kernel_cannot_take(m, k, n, dtype, err):
    with pytest.raises(err, match="tap_probe kernel"):
        tap.tap_plan(m, k, n, dtype)


# ---- the wrappers' devices and entry points


def test_wrapper_refuses_a_tensor_on_neither_the_cpu_nor_a_card():
    """No fallback: a meta tensor is refused before any build or launch,
    by the path and by the probe."""
    a = torch.empty((128, 256), dtype=torch.int8, device="meta")
    b = torch.empty((256, 256), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tap.tap_matmul(a, b, 9)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tap.probe(a, b, 9, 1)


class _DeviceAs:
    """A meta tensor that reports another device; everything else is the
    tensor's."""

    def __init__(self, t, device):
        self._t, self.device = t, torch.device(device)

    def __getattr__(self, name):
        return getattr(self._t, name)


def _cuda(*shape, dtype):
    return _DeviceAs(torch.empty(shape, dtype=dtype, device="meta"), "cuda:0")


class _Fake:
    """Stands in for the built library: every function a recorder."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        def record(*args):
            self.calls.append((fn, args))
            return 0
        setattr(self, fn, record)
        return record


@pytest.fixture
def fake_card(monkeypatch):
    """A CUDA-typed call on a CPU box: the library is a recorder, the
    device context and the stream are stand-ins, and the plain version
    raises if it is reached."""
    fake = _Fake()
    monkeypatch.setattr(_build, "load_library", lambda name: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))

    def plain(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(tap, "tap_matmul_plain", plain)
    tap._lib.cache_clear()
    yield fake
    tap._lib.cache_clear()


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16],
                         ids=["int8", "bf16"])
def test_cuda_tensor_reaches_the_kernel_entry_point_only(dtype, fake_card):
    """The path hands both operands as they are (no transpose launch) to
    ducosy_tap_probe once, counts one launch and returns an (m, n) int32
    or fp32 out."""
    m, k, n = PROBE_SHAPE
    before = tap.tap_matmul.launches
    out = tap.tap_matmul(_cuda(m, k, dtype=dtype), _cuda(k, n, dtype=dtype),
                         9)
    assert tap.tap_matmul.launches == before + 1
    tap.tap_matmul.launches = before
    ((fn, args),) = fake_card.calls
    assert fn == "ducosy_tap_probe"
    assert args[3:] == (m, k, 9, int(dtype == torch.int8), 0)
    assert out.shape == (m, n)
    assert out.dtype == (torch.int32 if dtype == torch.int8
                         else torch.float32)


@pytest.mark.parametrize("design,parts,fn", [
    (1, 7, "ducosy_tap_probe_parts"), (1, 2, "ducosy_tap_probe_parts"),
    (0, 7, "ducosy_tap_probe_original")], ids=["whole", "mmas", "original"])
def test_probe_reaches_its_entry_points_uncounted(design, parts, fn,
                                                  fake_card):
    """probe calls the by-parts entry point with its parts, or the original
    kernels' entry point, and counts nothing."""
    m, k, n = PROBE_SHAPE
    before = tap.tap_matmul.launches
    tap.probe(_cuda(m, k, dtype=torch.int8), _cuda(k, n, dtype=torch.int8),
              36, design, parts)
    assert tap.tap_matmul.launches == before
    ((called, args),) = fake_card.calls
    assert called == fn
    tail = (m, k, 36, 1, parts, 0) if design else (m, k, n, 36, 1, 0)
    assert args[3:] == tail


@pytest.mark.parametrize("design,parts", [(2, 7), (1, 0), (1, 5), (1, 8),
                                          (0, 1)],
                         ids=["design", "parts-0", "parts-5", "parts-8",
                              "original-part"])
def test_probe_refuses_unknown_designs_and_parts(design, parts, fake_card):
    m, k, n = PROBE_SHAPE
    with pytest.raises(ValueError, match="tap_probe probe"):
        tap.probe(_cuda(m, k, dtype=torch.int8),
                  _cuda(k, n, dtype=torch.int8), 9, design, parts)
    assert fake_card.calls == []


@pytest.mark.parametrize("a,b,taps,err", [
    ((128, 256, torch.int8), (256, 256, torch.bfloat16), 9, TypeError),
    ((128, 256, torch.float32), (256, 256, torch.float32), 9, TypeError),
    ((128, 256, torch.int8), (128, 256, torch.int8), 9, ValueError),
    ((128, 256, torch.int8), (256, 256, torch.int8), 0, ValueError),
    ((100, 256, torch.int8), (256, 256, torch.int8), 9, ValueError),
    ((128, 256, torch.int8), (256, 128, torch.int8), 9, ValueError),
], ids=["mixed", "fp32", "inner", "taps", "plan-m", "plan-n"])
@pytest.mark.parametrize("design", [None, 0, 1], ids=["path", "original",
                                                      "kernel"])
def test_cuda_call_refuses_what_the_kernel_does_not_take(design, a, b, taps,
                                                         err, fake_card):
    """Refused by the path and by both probe designs before anything is
    built or launched."""
    ta, tb = _cuda(*a[:2], dtype=a[2]), _cuda(*b[:2], dtype=b[2])
    with pytest.raises(err, match="tap_probe kernel"):
        if design is None:
            tap.tap_matmul(ta, tb, taps)
        else:
            tap.probe(ta, tb, taps, design)
    assert fake_card.calls == []
