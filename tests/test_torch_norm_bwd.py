"""K3 (the InstanceNorm backward of each training block's first norm) on the
CPU.

K3 runs on the card as three launches on K2's tile plan: K2's statistics
launch, the masked, folded gradient sums per tile merged by the last block
of a sample, and the apply. What a CPU can hold of it: a plain model of
that decomposition (the plan's tiles, per-tile partials merged in order, the
border pixels' mirror terms added in fp32) against the Pallas kernel in
interpret mode and against the plain version; the plan at the training
shape; that the wrapper and the by-parts probe refuse what the kernel does
not take before anything is built; that a CPU tensor takes the plain version
uncounted and a CUDA tensor reaches the kernel's entry point and nothing
else; the ctypes declarations of the entry points; and the autograd
Function against jax.vjp. Inputs are made from a seed with numpy; tolerances
are stated per test.
"""
import contextlib
import ctypes
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.ops.pallas.instance_norm import (
    instance_norm_bwd_pallas,
    instance_norm_fused as jax_instance_norm_fused,
)
from ducosy_tpu_torch.models.layers import reflect_pad_adjoint
from ducosy_tpu_torch.ops.kernels import _build
from ducosy_tpu_torch.ops.kernels import instance_norm as k2

EPS = 1e-5
T = torch.from_numpy
H100_SMS = 132
TRAIN_SHAPE = (8, 128, 128, 256)

# Shapes on which the plan's tiles span image rows: (3, 75, 93, 64) and
# (2, 37, 41, 192) end a sample with a part-full tile; (2, 50, 70, 64) cuts
# it into 14 full tiles of 250 pixels; (2, 12, 20, 192) and (2, 16, 16, 256)
# are one tile a sample.
MODEL_SHAPES = [(2, 50, 70, 64), (3, 75, 93, 64), (2, 37, 41, 192),
                (2, 12, 20, 192), (2, 16, 16, 256)]


def _inputs(shape, pad, seed=0):
    """x ~ N(0.5, 2), as the other K3 tests draw it, and a unit cotangent of
    the padded output. The Pallas kernel's E[x^2] - E[x]^2 variance loses
    digits where a channel's mean is large against its spread (mean 6 at
    spread 0.5 puts it 1e-4 from the centred statistics); these inputs keep
    the comparison to its summation order."""
    n, h, w, c = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 2.0, shape).astype(np.float32)
    g = rng.standard_normal((n, h + 2 * pad, w + 2 * pad, c)) \
        .astype(np.float32)
    return x, g


def _fold(g, h, w, pad):
    """The cotangent folded onto the interior in the kernel's order: its own
    place, then for rows 1 and h - 2 the pad row that mirrors them, then the
    mirrored columns 0 and w + 1, each summed over its rows first."""
    if not pad:
        return g.clone()
    v = g[:, 1:h + 1, 1:w + 1].clone()
    v[:, 1] += g[:, 0, 1:w + 1]
    v[:, h - 2] += g[:, h + 1, 1:w + 1]
    for j, col in ((1, 0), (w - 2, w + 1)):
        s = g[:, 1:h + 1, col].clone()
        s[:, 1] += g[:, 0, col]
        s[:, h - 2] += g[:, h + 1, col]
        v[:, :, j] += s
    return v


def _k3_model(x, g, relu, pad, sms=H100_SMS):
    """K3 as its launches decompose it, in fp32 PyTorch: K2's plan cuts each
    sample into tiles of pixels x all channels; a tile reports (count, mean,
    centred M2) of x and, with the statistics, sum(g) and sum(g * y) of its
    folded, masked cotangent; the last block of a sample merges the tiles in
    order (Chan's formula for the statistics, plain sums for the
    gradients); the apply writes dx per pixel."""
    n, h, w, c = x.shape
    pl = k2.plan(n, h, w, c, 4, sms)
    hw = h * w
    xs = x.reshape(n, hw, c)
    gs = _fold(g, h, w, pad).reshape(n, hw, c)
    tiles = [(t * pl.tile, min(hw, (t + 1) * pl.tile))
             for t in range(pl.tiles)]
    cnt = torch.zeros(n, 1)
    mean = torch.zeros(n, c)
    m2 = torch.zeros(n, c)
    for lo, hi in tiles:                       # in_stats, merged in order
        part = xs[:, lo:hi]
        nb = float(hi - lo)
        pm = part.mean(dim=1)
        pq = (part - pm[:, None]).square().sum(dim=1)
        tot = cnt + nb
        d = pm - mean
        mean = mean + d * (nb / tot)
        m2 = m2 + pq + d * d * (cnt * nb / tot)
        cnt = tot
    rstd = 1.0 / torch.sqrt(torch.clamp(m2 / hw, min=0.0) + EPS)
    y = (xs - mean[:, None]) * rstd[:, None]
    gm = gs * (y > 0) if relu else gs
    sg = torch.zeros(n, c)
    sgy = torch.zeros(n, c)
    for lo, hi in tiles:                       # bwd_sums, merged in order
        sg = sg + gm[:, lo:hi].sum(dim=1)
        sgy = sgy + (gm[:, lo:hi] * y[:, lo:hi]).sum(dim=1)
    mg, mgy = sg / hw, sgy / hw
    dx = (gm - mg[:, None] - y * mgy[:, None]) * rstd[:, None]
    return dx.reshape(n, h, w, c)


# ---- (a) the decomposition against the Pallas kernel and the plain version


@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", MODEL_SHAPES,
                         ids=["x".join(map(str, s)) for s in MODEL_SHAPES])
def test_decomposition_matches_pallas_and_plain(shape, relu, pad):
    """The tile decomposition K3's launches compute, in fp32, against
    instance_norm_bwd_pallas (interpret) and instance_norm_bwd_plain, atol
    1e-5 (fp32 statistics and sums in another order; the Pallas kernel's
    variance is E[x^2] - E[x]^2)."""
    x, g = _inputs(shape, pad, seed=sum(shape) + 2 * pad + relu)
    got = _k3_model(T(x), T(g), relu, pad).numpy()
    ref = instance_norm_bwd_pallas(jnp.asarray(x), jnp.asarray(g), relu=relu,
                                   pad=pad, interpret=True)
    plain = k2.instance_norm_bwd_plain(T(x), T(g), relu=relu, pad=pad)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, plain.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(2, 5, 7, 64), (1, 3, 3, 64),
                                   (1, 2, 9, 64)],
                         ids=["5x7", "3x3", "2x9"])
def test_fold_equals_the_pad_adjoint_bit_for_bit(shape):
    """The fold in the kernel's order (the first mirror term staged, the
    others added in reflect_pad_adjoint's order) gives the plain version's
    bits, also where a row is both row 1 and row h - 2 (h = 3) or rows 0
    and 1 both fold (h = 2)."""
    n, h, w, c = shape
    g = T(np.random.default_rng(h * w).standard_normal(
        (n, h + 2, w + 2, c)).astype(np.float32))
    assert torch.equal(_fold(g, h, w, 1), reflect_pad_adjoint(g, 1))


# ---- (b) the launch plan


def test_plan_at_the_training_shape():
    """K3 launches on K2's plan: at (8, 128, 128, 256) on 132 SMs the whole
    batch at once, 16 tiles of 1024 pixels a sample (128 blocks a launch),
    in bf16 and fp32 alike; the plan is a pure function of shape, item size
    and SM count."""
    for itemsize in (2, 4):
        pl = k2.plan(*TRAIN_SHAPE, itemsize, H100_SMS)
        assert pl == k2.Plan(8, 16, 1024, 132)
        assert pl == k2.plan(*TRAIN_SHAPE, itemsize, H100_SMS)
        assert pl.group * pl.tiles <= H100_SMS


@pytest.mark.parametrize("shape", MODEL_SHAPES,
                         ids=["x".join(map(str, s)) for s in MODEL_SHAPES])
def test_model_shapes_cut_as_stated(shape):
    """The tiles of each model shape cover its pixels once, the whole batch
    at once, and span image rows; the two ragged ones end a sample with a
    part-full tile."""
    n, h, w, c = shape
    pl = k2.plan(n, h, w, c, 4, H100_SMS)
    last = h * w - (pl.tiles - 1) * pl.tile
    assert 0 < last <= pl.tile and pl.tile > w and pl.group == n
    assert (last < pl.tile) == (shape in [(3, 75, 93, 64), (2, 37, 41, 192)])


# ---- (c) refusals before any build


class _DeviceAs:
    """A meta tensor that reports another device and a 16-byte aligned
    address; everything else is the tensor's."""

    def __init__(self, t, device):
        self._t, self.device = t, torch.device(device)

    def __getattr__(self, name):
        return getattr(self._t, name)

    def data_ptr(self):
        return 0


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _cuda(t):
    return _DeviceAs(t, "cuda:0")


BAD_G = {
    "shape": (_cuda(_meta(1, 8, 8, 64)), "instance_norm_bwd kernel: g"),
    "dtype": (_cuda(_meta(1, 10, 10, 64, dtype=torch.float32)),
              "instance_norm_bwd kernel: g"),
    "device": (_meta(1, 10, 10, 64), "instance_norm_bwd kernel: g"),
    "strided": (_cuda(_meta(1, 10, 64, 10).transpose(2, 3)),
                "instance_norm_bwd kernel: g"),
}


@pytest.fixture
def no_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "load_library", refuse)


@pytest.mark.parametrize("entry", ["wrapper", "probe"])
@pytest.mark.parametrize("case", sorted(BAD_G))
def test_malformed_g_is_refused_before_any_build(case, entry, no_build):
    """A g of the wrong shape, dtype or device, or not contiguous, raises
    before any library is built, in the wrapper (uncounted) and the
    probe."""
    g, match = BAD_G[case]
    x = _cuda(_meta(1, 8, 8, 64))
    before = k2.instance_norm_bwd.launches
    with pytest.raises(ValueError, match=match):
        if entry == "wrapper":
            k2.instance_norm_bwd(x, g, relu=True, pad=1)
        else:
            k2.probe_bwd(x, g, 1, 7)
    assert k2.instance_norm_bwd.launches == before


@pytest.mark.parametrize("design,parts", [(3, 7), (-1, 7), (1, 0), (0, 8)])
def test_probe_refuses_a_bad_design_or_parts(design, parts, no_build):
    x, g = _cuda(_meta(1, 8, 8, 64)), _cuda(_meta(1, 10, 10, 64))
    with pytest.raises(ValueError, match="design"):
        k2.probe_bwd(x, g, design, parts)


def test_wrapper_refuses_a_width_beyond_the_tile_plan(no_build):
    """C above one block's 16-byte lanes (4096 in bf16) is refused, as K2
    refuses it."""
    x = _cuda(_meta(1, 4, 4, 8192))
    g = _cuda(_meta(1, 6, 6, 8192))
    with pytest.raises(ValueError, match="above 4096"):
        k2.instance_norm_bwd(x, g, relu=True, pad=1)


# ---- (d) CPU plain and uncounted; CUDA reaches only the entry point


def test_cpu_tensors_take_the_plain_version_uncounted():
    x, g = _inputs((2, 9, 11, 64), 1, seed=7)
    xt, gt = T(x).to(torch.bfloat16), T(g).to(torch.bfloat16)
    before = k2.instance_norm_bwd.launches
    assert torch.equal(k2.instance_norm_bwd(xt, gt, relu=True, pad=1),
                       k2.instance_norm_bwd_plain(xt, gt, relu=True, pad=1))
    assert k2.instance_norm_bwd.launches == before


class _Recorder:
    """Stands in for a ctypes function: takes restype and argtypes, records
    each call and returns 0 (no CUDA error)."""

    def __init__(self, name, calls):
        self._name, self._calls = name, calls

    def __call__(self, *args):
        self._calls.append((self._name, args))
        return 0


class _FakeBwd:
    """Stands in for the built library: every function a recorder."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        rec = _Recorder(fn, self.calls)
        setattr(self, fn, rec)
        return rec


@pytest.fixture
def fake_card(monkeypatch):
    """A CUDA-typed call on a CPU box: the library is a recorder, the card
    has 132 SMs, the device context and the stream are stand-ins, and the
    plain version raises if it is reached."""
    fake = _FakeBwd()
    monkeypatch.setattr(_build, "load_library", lambda name: fake)
    monkeypatch.setattr(k2, "_sms", lambda index: H100_SMS)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))

    def plain(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(k2, "instance_norm_bwd_plain", plain)
    k2._bwd_lib.cache_clear()
    yield fake
    k2._bwd_lib.cache_clear()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_cuda_tensor_reaches_the_kernel_entry_point_only(dtype, fake_card):
    """The wrapper hands a CUDA tensor to ducosy_instance_norm_bwd (never the
    probe, never the plain version) with K2's plan at the training shape,
    counts one launch and returns a dx of x's shape and dtype."""
    n, h, w, c = TRAIN_SHAPE
    x = _cuda(_meta(*TRAIN_SHAPE, dtype=dtype))
    g = _cuda(_meta(n, h + 2, w + 2, c, dtype=dtype))
    before = k2.instance_norm_bwd.launches
    dx = k2.instance_norm_bwd(x, g, relu=True, pad=1)
    assert k2.instance_norm_bwd.launches == before + 1
    k2.instance_norm_bwd.launches = before
    assert [fn for fn, _ in fake_card.calls] == ["ducosy_instance_norm_bwd"]
    args = fake_card.calls[0][1]
    assert args[12:18] == (n, h, w, c, 1, 1)
    assert args[18] == pytest.approx(EPS)
    assert args[19:23] == (8, 16, 1024, int(dtype == torch.bfloat16))
    assert dx.shape == TRAIN_SHAPE and dx.dtype == dtype


@pytest.mark.parametrize("design", [0, 1, 2])
def test_probe_reaches_the_probe_entry_point_uncounted(design, fake_card):
    """probe_bwd calls the by-parts entry point with its design and parts,
    and counts nothing."""
    x, g = _cuda(_meta(2, 16, 16, 64)), _cuda(_meta(2, 18, 18, 64))
    before = k2.instance_norm_bwd.launches
    k2.probe_bwd(x, g, design, 5)
    assert k2.instance_norm_bwd.launches == before
    ((fn, args),) = fake_card.calls
    assert fn == "ducosy_instance_norm_bwd_probe"
    assert args[22:24] == (design, 5)


# ---- (e) the ctypes declarations of the entry points

_DECL = re.compile(r'extern\s+"C"\s+int\s+(ducosy_\w+)\s*\(([^)]*)\)')


def test_entry_points_are_declared_with_their_argument_types(monkeypatch):
    """Each extern "C" entry point of csrc/instance_norm_bwd.cu is declared
    to ctypes with one argument type a C parameter: c_void_p for a pointer,
    c_int for an int, c_float for a float, and an int return."""
    text = re.sub(r"//[^\n]*", "",
                  (_build.CSRC_DIR / "instance_norm_bwd.cu").read_text())
    sigs = {fn: [" ".join(p.split()) for p in params.split(",")]
            for fn, params in _DECL.findall(text)}
    assert set(sigs) == {"ducosy_instance_norm_bwd",
                         "ducosy_instance_norm_bwd_probe"}

    class Fake:
        def __getattr__(self, fn):
            ns = types.SimpleNamespace()
            setattr(self, fn, ns)
            return ns

    fake = Fake()
    monkeypatch.setattr(_build, "load_library", lambda name: fake)
    k2._bwd_lib.__wrapped__()
    for fn, params in sigs.items():
        decl = getattr(fake, fn)
        assert decl.restype is ctypes.c_int
        want = [ctypes.c_void_p if "*" in p else
                {"int": ctypes.c_int, "float": ctypes.c_float}[p.split()[0]]
                for p in params]
        assert decl.argtypes == want, fn


# ---- (f) the autograd Function against jax.vjp


def test_autograd_function_matches_jax_vjp_at_a_ragged_shape():
    """instance_norm_fused (K2 forward, K3 backward; their plain versions on
    the CPU) against jax.vjp of the JAX package's instance_norm_fused at
    (3, 75, 93, 64), ReLU, pad 1: forward and dx, atol 1e-5."""
    x, g = _inputs((3, 75, 93, 64), 1, seed=11)
    y, vjp = jax.vjp(lambda a: jax_instance_norm_fused(a, True, EPS, 1),
                     jnp.asarray(x))
    xt = T(x).requires_grad_()
    out = k2.instance_norm_fused(xt, relu=True, pad=1)
    out.backward(T(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=1e-5, rtol=0)
