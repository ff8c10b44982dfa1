"""The conv launch that K1, K6, K7 and K8 share (``conv3x3``), the weight
re-layout the kernel wrappers do for it, the tile geometry of its scratch,
and what the wrappers admit, on the CPU.

The same numpy inputs (made from a seed) go through the JAX package's conv
(``_conv_taps``, the loop inside the Pallas kernels, which is plain jnp and
runs on the CPU as it stands; and the conv of ``_xla_conv_in``) and through
the port's ``conv3x3``, which runs its plain version for CPU tensors.
Shapes are small (C = 64, up to 12 x 20 pixels). Tolerances per test.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.ops.pallas.conv_in import _conv_taps
from ducosy_tpu_torch.ops import quant as q
from ducosy_tpu_torch.ops.kernels import _build
from ducosy_tpu_torch.ops.kernels import conv_in as k7
from ducosy_tpu_torch.ops.kernels import residual_chain as k1

T = torch.from_numpy
C = 64
# (H, W): 128 pixels fill one tile exactly; 240 leave a last tile of 112
SHAPES = {"exact": (8, 16), "ragged": (12, 20)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(h, w, seed=0, n=2, c=C):
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    return f(n, h + 2, w + 2, c), f(3, 3, c, c, std=0.05)


def _hwio(wk, dt):
    """``kernel_weights`` undone: (..., 9, C, C) back to HWIO."""
    c = wk.shape[-1]
    if wk.dtype == torch.int8 or dt == torch.bfloat16:
        wk = wk.transpose(-1, -2)
    return wk.reshape(*wk.shape[:-3], 3, 3, c, c).contiguous()


def _taps(xp, w):
    """The JAX package's tap loop on (N, H+2, W+2, C) and HWIO w."""
    n, hp, wp, c = xp.shape
    wf = w.reshape(9 * c, c)
    return np.stack([np.asarray(_conv_taps(xp[i], wf, hp - 2, wp - 2))
                     for i in range(n)])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3x3_matches_the_jax_conv(dtype, shape):
    """``conv3x3`` on the CPU (its plain version) against ``_conv_taps`` and
    against the conv of ``_xla_conv_in`` in fp32. Operands in ``dtype``,
    fp32 sums on every side: summation order only, rtol 1e-5 (atol 1e-5 for
    the sums near zero)."""
    h, w = SHAPES[shape]
    x, wt = _inputs(h, w)
    xj = jnp.asarray(x, JDT[dtype])
    wj = jnp.asarray(wt, JDT[dtype])
    got = k7.conv3x3(T(x).to(TDT[dtype]), T(wt))
    assert got.acc.shape == (2, h * w, C) and got.acc.dtype == torch.float32
    np.testing.assert_allclose(got.acc.numpy(), _taps(xj, wj), rtol=1e-5,
                               atol=1e-5)
    ref = jax.lax.conv_general_dilated(
        xj.astype(jnp.float32), wj.astype(jnp.float32), (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(got.acc.numpy().reshape(2, h, w, C),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_conv3x3_int8_is_exact(shape):
    """int8 x int8: the int32 sums of ``_conv_taps`` exactly."""
    h, w = SHAPES[shape]
    rng = np.random.default_rng(3)
    x8 = rng.integers(-128, 128, (2, h + 2, w + 2, C), dtype=np.int8)
    w8 = rng.integers(-127, 128, (3, 3, C, C), dtype=np.int8)
    got = k7.conv3x3(T(x8), T(w8))
    ref = _taps(jnp.asarray(x8), jnp.asarray(w8))
    assert ref.dtype == np.int32
    np.testing.assert_array_equal(got.acc.numpy(), ref.astype(np.float32))
    with pytest.raises(TypeError, match="int8 weights"):
        k7.conv3x3(T(x8), T(w8).float())


@pytest.mark.parametrize("shape", SHAPES)
def test_partials_merge_to_the_image_statistics(shape):
    """The per-tile (mean, M2, max) of ``conv3x3`` merge (Chan) to the
    whole image's mean, centred sum of squares and max: rtol 1e-5."""
    h, w = SHAPES[shape]
    x, wt = _inputs(h, w, seed=1)
    sc = k7.conv3x3(T(x), T(wt))
    pm, pq, px = (p.numpy().astype(np.float64) for p in sc.partials)
    acc = sc.acc.numpy().astype(np.float64)
    cnt, mean, m2 = 0.0, 0.0, 0.0
    for t in range(pm.shape[1]):
        nb = min(k7.TILE_M, h * w - t * k7.TILE_M)
        d = pm[:, t] - mean
        mean = mean + d * nb / (cnt + nb)
        m2 = m2 + pq[:, t] + d * d * cnt * nb / (cnt + nb)
        cnt += nb
    assert cnt == h * w
    np.testing.assert_allclose(mean, acc.mean(axis=1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        m2, ((acc - acc.mean(axis=1, keepdims=True)) ** 2).sum(axis=1),
        rtol=1e-5)
    np.testing.assert_array_equal(px.max(axis=1), acc.max(axis=1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("stacked", [False, True], ids=["one", "stack"])
def test_kernel_weights_layout_round_trips(stacked, dtype):
    """bf16 and int8 go to (tap, Cout, Cin), fp32 stays (tap, Cin, Cout);
    the inverse permutation gives the HWIO weights back exactly."""
    rng = np.random.default_rng(4)
    lead = (3,) if stacked else ()
    if dtype == "int8":
        w = T(rng.integers(-127, 128, lead + (3, 3, C, C), dtype=np.int8))
        dt = torch.bfloat16             # int8 keeps its layout whatever dt
    else:
        w = T(rng.standard_normal(lead + (3, 3, C, C)).astype(np.float32))
        dt = TDT[dtype]
    wk = k7.kernel_weights(w, dt)
    assert wk.shape == lead + (9, C, C) and wk.is_contiguous()
    assert wk.dtype == (torch.int8 if dtype == "int8" else dt)
    first = wk[0] if stacked else wk
    src = (w[0] if stacked else w).to(wk.dtype)
    tap, co, ci = 5, 7, 11
    want = src[tap // 3, tap % 3, ci, co]
    at = (tap, ci, co) if dtype == "float32" else (tap, co, ci)
    assert first[at] == want
    back = _hwio(wk, dt)
    assert back.shape == w.shape
    assert torch.equal(back, w.to(wk.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relayout_leaves_the_plain_versions_unchanged(dtype):
    """The plain versions take HWIO weights; weights that went through the
    kernels' layout and back give the same results, bit for bit."""
    dt = TDT[dtype]
    h, w = SHAPES["ragged"]
    rng = np.random.default_rng(5)
    f = lambda *s, std=1.0: T((rng.standard_normal(s) * std)
                              .astype(np.float32))
    r = C // 16
    xp = f(2, h + 2, w + 2, C).to(dt)
    was, wbs = f(2, 3, 3, C, C, std=0.05), f(2, 3, 3, C, C, std=0.05)
    rest = (f(2, C, r, std=0.1), f(2, r, C, std=0.1),
            f(2, 7, 7, 2, 1, std=0.1))
    trip = lambda t: _hwio(k7.kernel_weights(t, dt), dt)
    assert torch.equal(k1.residual_chain_plain(xp, was, wbs, *rest),
                       k1.residual_chain_plain(xp, trip(was), trip(wbs),
                                               *rest))
    t = k7.conv3x3_in_plain(xp, was[0])
    assert torch.equal(t, k7.conv3x3_in_plain(xp, trip(was[0])))
    tail = [a[0] for a in rest]
    assert torch.equal(
        k7.conv_block_tail_plain(t, xp, wbs[0], *tail),
        k7.conv_block_tail_plain(t, xp, trip(wbs[0]), *tail))
    wq, ws = q.quantize_weights_int8(wbs[0])
    t8 = k7.conv3x3_in_plain(xp, was[0], int8_scale=q.INT8_NORM_SCALE)
    kw = dict(in_int8=True, w_scale=ws)
    assert torch.equal(
        k7.conv_block_tail_plain(t8, xp, wq, *tail, **kw),
        k7.conv_block_tail_plain(t8, xp, trip(wq), *tail, **kw))


def _constant(name, text):
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m, name
    return int(m.group(1))


@pytest.mark.parametrize("hw", [(8, 16), (16, 16), (12, 20), (50, 70)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_scratch_matches_the_tile_geometry_of_the_sources(hw):
    """``make_scratch`` (and K1, which sizes its partials by the same
    constants) against TILE_M / TILE_N of csrc/common.cuh, at shapes that
    fill their last tile and shapes that do not; and the ring of
    csrc/conv3x3.cuh at its widest tile fits a Hopper block's 227 KB."""
    common = (_build.CSRC_DIR / "common.cuh").read_text()
    tile_m, tile_n = _constant("TILE_M", common), _constant("TILE_N", common)
    assert (k7.TILE_M, k7.TILE_N) == (tile_m, tile_n)
    assert (k1.TILE_M, k1.TILE_N) == (tile_m, tile_n)
    h, w = hw
    tiles = -(-h * w // tile_m)
    sc = k7.make_scratch(2, h, w, C, "cpu")
    assert sc.acc.shape == (2, h * w, C) and sc.acc.dtype == torch.float32
    assert sc.partials.shape == (3, 2, tiles, C)
    assert sc.stats.shape == (3, 2, C)
    assert (tiles - 1) * tile_m < h * w <= tiles * tile_m
    loop = (_build.CSRC_DIR / "conv3x3.cuh").read_text()
    stages, align = _constant("RING_STAGES", loop), _constant("RING_ALIGN", loop)
    assert stages >= 3
    assert stages * (tile_m + 256) * 128 + align <= 232448


def _w(c):
    """(3, 3, c, c) weights without their memory: the checks read shapes."""
    return torch.empty(1).expand(3, 3, c, c)


@pytest.mark.parametrize("c", range(64, 1025, 64))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_wrappers_admit_every_width_they_admitted(dtype, c):
    """Every C that is a multiple of 64 up to 1024 passes the shape, dtype
    and layout checks of K7/K8 (and K1 for the float dtypes), at an odd
    spatial size: the only complaint about a CPU tensor is its device."""
    dt = torch.int8 if dtype == "int8" else TDT[dtype]
    xp = torch.empty((1, 5, 9, c), dtype=dt)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k7._check_input("conv3x3_in", xp, _w(c).to(dt), 1)
    if dtype != "int8":
        r = max(c // 16, 1)
        stack = lambda *s: torch.empty(1).expand(2, *s)
        with pytest.raises(ValueError, match="CUDA tensors"):
            k1._validate(xp, stack(3, 3, c, c), stack(3, 3, c, c),
                         stack(c, r), stack(r, c), stack(7, 7, 2, 1), 0,
                         False)


@pytest.mark.parametrize("case", [
    "c_not_multiple", "c_too_wide", "dtype", "int8_with_float_weights",
    "float_with_int8_weights", "not_contiguous", "too_small", "pad",
    "weight_shape", "rank"])
def test_wrappers_refuse_before_any_build(case, monkeypatch):
    """Outside what the kernels take, the wrappers raise from their checks;
    no build is attempted (``_build.build`` would raise here)."""
    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(_build, "build", no_build)
    c, dt, wdt, pad, err = 64, torch.float32, torch.float32, 1, ValueError
    xp = torch.empty((1, 6, 6, c))
    w = _w(c)
    if case == "c_not_multiple":
        xp, w = torch.empty((1, 6, 6, 96)), _w(96)
    elif case == "c_too_wide":
        xp, w = torch.empty((1, 6, 6, 1088)), _w(1088)
    elif case == "dtype":
        xp, w, err = xp.to(torch.float16), w.to(torch.float16), TypeError
    elif case == "int8_with_float_weights":
        xp, err = xp.to(torch.int8), TypeError
    elif case == "float_with_int8_weights":
        w, err = w.to(torch.int8), TypeError
    elif case == "not_contiguous":
        xp = torch.empty((1, 6, 6, 2 * c))[..., ::2]
    elif case == "too_small":
        xp = torch.empty((1, 3, 6, c))
    elif case == "pad":
        pad = 2
    elif case == "weight_shape":
        w = torch.empty(1).expand(3, 3, c, 2 * c)
    elif case == "rank":
        xp = torch.empty((6, 6, c))
    with pytest.raises(err) as e7:
        k7._check_input("conv3x3_in", xp, w, pad)
    assert "CUDA tensors" not in str(e7.value)
    if case in ("int8_with_float_weights", "float_with_int8_weights"):
        return                          # K1 takes int8 only as quant wbs
    k = 2
    r = 4
    stack = lambda t: t.expand(k, *t.shape)
    cc = xp.shape[-1]
    with pytest.raises(err) as e1:
        k1._validate(xp, stack(w), stack(w),
                     torch.empty(1).expand(k, cc, r),
                     torch.empty(1).expand(k, r, cc),
                     torch.empty(1).expand(k, 7, 7, 2, 1), pad, False)
    assert "CUDA tensors" not in str(e1.value)


def test_cuda_wrappers_do_not_fall_back_on_the_cpu_path():
    """``conv3x3`` counts a launch only where it launches: the CPU path
    leaves every counter alone."""
    before = (k7.conv3x3.launches, k7.conv3x3_in.launches,
              k1.residual_chain.launches)
    x, wt = _inputs(*SHAPES["exact"])
    k7.conv3x3(T(x), T(wt))
    k7.conv3x3_in(T(x), T(wt))
    assert before == (k7.conv3x3.launches, k7.conv3x3_in.launches,
                      k1.residual_chain.launches)


@pytest.mark.parametrize("dtype,c,parts", [
    ("float32", 256, 7), ("bfloat16", 128, 7), ("bfloat16", 256, 3),
    ("bfloat16", 256, 8)], ids=["dtype", "width", "no-mma-bit", "range"])
def test_probe_refuses_what_it_has_no_kernel_for(dtype, c, parts):
    """The timing probe exists for bf16 at C a multiple of 256 and five
    values of ``parts``; anything else raises before the device check."""
    xp = torch.empty((1, 6, 6, c), dtype=TDT[dtype])
    with pytest.raises(ValueError, match="conv3x3_probe: "):
        k7.conv3x3_probe(xp, _w(c), parts, None)
