"""The two routes of K7 (conv3x3_in), K8 (conv_block_tail) and K1
(residual_chain) in the port, on the CPU.

What a CPU can hold of kernels that run only on a card: the pure route
choice (``conv_route``, ``sample_groups``) over shapes, dtypes and co-resident
block counts; the scratch each route gets; every ``extern "C"`` signature of
``csrc/`` against the ctypes signature its wrapper declares (a mismatch
would otherwise show only on the card); that the wrappers refuse a CPU tensor
without building and never run a plain version for a tensor that is not on
the CPU; and, at one shape per route, the wrappers (their plain versions
here) against the Pallas kernels in interpret mode on the same numpy-seeded
inputs. Tolerances are stated per test.
"""
import ctypes
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.ops.pallas.conv_in import (
    conv3x3_in_pallas,
    conv_block_tail_pallas,
    residual_chain_pallas,
)
from ducosy_tpu_torch.ops import quant as q
from ducosy_tpu_torch.ops.kernels import _build
from ducosy_tpu_torch.ops.kernels import block_tail as k4
from ducosy_tpu_torch.ops.kernels import conv_in as k7
from ducosy_tpu_torch.ops.kernels import instance_norm as k2
from ducosy_tpu_torch.ops.kernels import residual_chain as k1
from ducosy_tpu_torch.ops.kernels import tap_probe

T = torch.from_numpy
BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
S = q.INT8_NORM_SCALE
H100_BLOCKS = 132     # an H100 SXM: 132 SMs x 1 block of the conv kernel

# (h, w, c, dtype, blocks_resident, tail) -> route. 128 x 128 is the trunk
# shape of a 512^2 slice (128 tiles of 128 pixels); 48 x 68 and 18 x 22 are
# ragged like the shapes chip_smoke.py checks on the card (their pixels do
# not fill the last tile).
ROUTES = [
    ("trunk-k7", 128, 128, 256, BF16, 132, False, "resident"),
    ("trunk-k8", 128, 128, 256, BF16, 132, True, "resident"),
    ("trunk-k7-int8-in", 128, 128, 256, I8, 132, False, "resident"),
    ("trunk-k8-int8-taps", 128, 128, 256, I8, 132, True, "resident"),
    ("trunk-114-blocks-k7", 128, 128, 256, BF16, 114, False, "tiled"),
    ("trunk-114-blocks-k8", 128, 128, 256, BF16, 114, True, "tiled"),
    ("trunk-128-blocks", 128, 128, 256, BF16, 128, True, "resident"),
    ("trunk-127-blocks", 128, 128, 256, BF16, 127, True, "tiled"),
    ("trunk-fp32-k7", 128, 128, 256, F32, 132, False, "tiled"),
    ("trunk-fp32-k8", 128, 128, 256, F32, 132, True, "tiled"),
    ("no-cooperative-launch", 128, 128, 256, BF16, 0, False, "tiled"),
    ("ragged-128-k7", 48, 68, 128, BF16, 132, False, "resident"),
    ("ragged-128-k8", 48, 68, 128, BF16, 132, True, "resident"),
    ("ragged-192-k7", 48, 68, 192, BF16, 132, False, "resident"),
    ("ragged-192-k8", 48, 68, 192, BF16, 132, True, "tiled"),
    ("ragged-192-k7-too-wide", 48, 68, 192, BF16, 77, False, "tiled"),
    ("ragged-512-k7", 18, 22, 512, BF16, 132, False, "resident"),
    ("ragged-512-k8", 18, 22, 512, BF16, 132, True, "tiled"),
    ("c512-two-column-blocks", 96, 96, 512, BF16, 132, False, "tiled"),
    ("c64-k8", 32, 32, 64, I8, 132, True, "resident"),
    ("wide-k7", 32, 384, 256, BF16, 132, False, "resident"),
    ("wide-k8", 32, 384, 256, BF16, 132, True, "tiled"),
    ("w256-k8", 64, 256, 256, BF16, 132, True, "resident"),
    ("140-tiles-k7", 140, 128, 256, BF16, 132, False, "tiled"),
    ("140-tiles-k8", 140, 128, 256, I8, 132, True, "tiled"),
]


@pytest.mark.parametrize("h,w,c,dtype,blocks,tail,want",
                         [r[1:] for r in ROUTES], ids=[r[0] for r in ROUTES])
def test_conv_route_depends_on_shape_dtype_and_resident_blocks(
        h, w, c, dtype, blocks, tail, want):
    """Resident needs bf16 or int8, every block of a sample (tiles x C / BN)
    on the card at once and, for K8, C in (64, 128, 256); all else is
    tiled."""
    assert k7.conv_route(h, w, c, dtype, blocks, tail=tail) == want
    groups = k7.sample_groups(4, h, w, c, dtype, blocks, tail=tail)
    assert (groups > 0) == (want == "resident")


@pytest.mark.parametrize("n,h,w,c,blocks,want", [
    (16, 128, 128, 256, 132, 1),     # the trunk: one sample at a time
    (16, 128, 128, 256, 264, 2),     # a card twice the size holds two
    (2, 48, 68, 128, 132, 2),        # 26 tiles: both samples side by side
    (16, 48, 68, 128, 132, 5),       # 132 // 26
    (1, 18, 22, 512, 132, 1),        # never more groups than samples
    (16, 128, 128, 256, 127, 0),     # tiled
], ids=["trunk", "trunk-264", "ragged-n2", "ragged-n16", "n1", "tiled"])
def test_sample_groups_fill_the_card_without_exceeding_it(n, h, w, c, blocks,
                                                          want):
    groups = k7.sample_groups(n, h, w, c, BF16, blocks)
    assert groups == want
    bn = 256 if c % 256 == 0 else 128
    assert groups * -(-h * w // k7.TILE_M) * (c // bn) <= blocks
    assert groups <= k7.BARRIER_WORDS


@pytest.mark.parametrize("dtype,blocks,c,has_acc", [
    (BF16, 132, 256, False),    # K7 and K8 resident: no accumulator
    (BF16, 2, 256, True),       # fewer resident blocks than tiles: tiled
    (F32, 132, 256, True),      # the parity mode: tiled
    (BF16, 132, 512, True),     # K8 tiled at C = 512
    (None, 132, 256, True),     # a scratch for any call
    (BF16, None, 256, True),    # the CPU holds no resident block
], ids=["resident", "2-blocks", "fp32", "c512", "any", "cpu-default"])
def test_make_scratch_per_route(dtype, blocks, c, has_acc):
    """No (n, h*w, c) fp32 accumulator (268 MB at the trunk shape, N = 16)
    where both halves run resident; always the partials, the (n, h, w, 2)
    map and zeroed barrier words."""
    n, h, w = 2, 16, 24
    sc = k7.make_scratch(n, h, w, c, "cpu", dtype, blocks)
    if has_acc:
        assert sc.acc.shape == (n, h * w, c) and sc.acc.dtype == F32
    else:
        assert sc.acc is None
    assert sc.partials.shape == (3, n, 3, c)
    assert sc.stats.shape == (3, n, c)
    assert sc.map.shape == (n, h, w, 2) and sc.map.dtype == F32
    assert sc.barrier.dtype == torch.int64
    assert sc.barrier.numel() == k7.BARRIER_WORDS >= H100_BLOCKS
    assert not sc.barrier.any()


def test_trunk_scratch_holds_no_accumulator_on_an_h100():
    """At the trunk shape on 132 resident blocks the scratch of one generator
    call is under 3 MB where the tiled route's was 268 MB + partials."""
    sc = k7.make_scratch(16, 128, 128, 256, "meta", BF16, H100_BLOCKS)
    assert sc.acc is None
    nbytes = sum(t.numel() * t.element_size()
                 for t in (sc.partials, sc.stats, sc.map))
    assert nbytes < 9 * 2 ** 20
    tiled = k7.make_scratch(16, 128, 128, 256, "meta", F32, H100_BLOCKS)
    assert tiled.acc.numel() * 4 == 16 * 128 * 128 * 256 * 4


# ---- extern "C" signatures against the wrappers' ctypes signatures

_LOADERS = {"conv_in": k7._lib, "residual_chain": k1._lib,
            "instance_norm": k2._lib, "instance_norm_bwd": k2._bwd_lib,
            "block_tail": k4._lib, "block_tail_bwd": k4._bwd_lib,
            "tap_probe": tap_probe._lib}
_DECL = re.compile(r'extern\s+"C"\s+([\w\s]+?[\s\*]+)(ducosy_\w+)\s*\(([^)]*)\)')


def _c_signatures(name):
    """{function: (return type, [parameter types])} of csrc/<name>.cu."""
    text = re.sub(r"//[^\n]*", "", (_build.CSRC_DIR / f"{name}.cu").read_text())
    out = {}
    for ret, fn, params in _DECL.findall(text):
        types_ = []
        for prm in params.split(","):
            prm = " ".join(prm.split())
            types_.append("ptr" if "*" in prm else prm.rsplit(" ", 1)[0])
        out[fn] = (" ".join(ret.split()), types_)
    return out


class _FakeDll:
    """Stands in for the ctypes library: records what a loader declares."""

    def __getattr__(self, fn):
        ns = types.SimpleNamespace()
        setattr(self, fn, ns)
        return ns


def _declared(name, monkeypatch):
    fake = _FakeDll()
    monkeypatch.setattr(_build, "load_library", lambda lib: fake)
    _LOADERS[name].__wrapped__()
    return {fn: v for fn, v in vars(fake).items()}


def _matches(ctype, c_type) -> bool:
    if c_type == "ptr":
        return ctype is ctypes.c_void_p or issubclass(ctype, ctypes._Pointer)
    return {"int": ctypes.c_int, "float": ctypes.c_float}[c_type] is ctype


@pytest.mark.parametrize("name", sorted(_LOADERS))
def test_ctypes_signatures_match_the_extern_c_declarations(name, monkeypatch):
    """Every entry point of csrc/<name>.cu has a declared ctypes signature
    in its wrapper, with the same number of arguments, pointers where C has
    pointers, c_int for int and c_float for float, and the same return."""
    c_sigs = _c_signatures(name)
    declared = _declared(name, monkeypatch)
    assert c_sigs and set(c_sigs) == set(declared), (set(c_sigs),
                                                     set(declared))
    for fn, (ret, params) in c_sigs.items():
        argtypes = declared[fn].argtypes
        assert len(argtypes) == len(params), (fn, len(argtypes), len(params))
        for k, (a, prm) in enumerate(zip(argtypes, params)):
            assert _matches(a, prm), (fn, k, a, prm)
        want_ret = {"int": ctypes.c_int, "void": None}[ret]
        assert declared[fn].restype is want_ret, (fn, ret)


def test_every_source_with_entry_points_has_a_checked_loader():
    """No .cu under csrc/ escapes the signature test above."""
    names = {p.stem for p in _build.CSRC_DIR.glob("*.cu")}
    assert names == set(_LOADERS)
    shared = (_build.CSRC_DIR / "common.cuh").read_text()
    assert re.search(r'extern "C" const char\* ducosy_error_string\(int ',
                     shared)


# ---- the wrappers on a CPU box

def _inputs(c, h, w, seed, n=2):
    rng = np.random.default_rng(seed)
    r = max(c // 16, 1)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    return dict(xp=f(n, h + 2, w + 2, c), tp=f(n, h + 2, w + 2, c),
                w=f(3, 3, c, c, std=0.05), wb=f(3, 3, c, c, std=0.05),
                w1=f(c, r, std=0.1), w2=f(r, c, std=0.1),
                wsa=f(7, 7, 2, 1, std=0.1))


def test_launchers_refuse_a_cpu_tensor_without_building(monkeypatch):
    """The launch functions (what a CUDA tensor reaches) raise on a CPU
    tensor before any library is built or loaded, on either route."""
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", no_build)
    d = {k: T(v) for k, v in _inputs(64, 6, 6, 0).items()}
    tail = (d["w1"], d["w2"], d["wsa"])
    for dt in (F32, BF16):
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            k7.launch_conv3x3_in(d["xp"].to(dt), d["w"], relu=True, pad=1,
                                 int8_scale=None, eps=1e-5, scratch=None)
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            k7.launch_conv_block_tail(d["tp"].to(dt), d["xp"].to(dt), d["w"],
                                      *tail, pad=1, x_pad=1, in_int8=False,
                                      eps=1e-5, scratch=None)
    x256 = torch.zeros((1, 6, 6, 256), dtype=BF16)
    pw = k7.probe_weights(torch.zeros((3, 3, 256, 256)),
                          torch.zeros((256, 16)), torch.zeros((16, 256)),
                          torch.zeros((7, 7, 2, 1)))
    assert pw[0].shape == (9, 256, 256) and pw[3].shape == (2, 49)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        k7.resident_probe(x256, pw, 7, True, None)
    with pytest.raises(ValueError, match="parts 1-7"):
        k7.resident_probe(x256, pw, 8, True, None)
    assert k7.resident_blocks("cpu") == 0


def test_wrappers_never_run_a_plain_version_for_a_cuda_tensor(monkeypatch):
    """A tensor that is not on the CPU goes to the launcher or raises: with
    the plain versions and the launchers replaced, a meta tensor (no CPU
    data, no card needed) reaches only the launchers."""
    calls = []

    def plain(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    for name in ("conv3x3_in_plain", "conv_block_tail_plain"):
        monkeypatch.setattr(k7, name, plain)
        monkeypatch.setattr(k1, name, plain)
    monkeypatch.setattr(k1, "residual_chain_plain", plain)
    monkeypatch.setattr(k7, "launch_conv3x3_in",
                        lambda *a, **k: calls.append("k7"))
    monkeypatch.setattr(k7, "launch_conv_block_tail",
                        lambda *a, **k: calls.append("k8"))
    x = torch.empty((1, 6, 6, 64), dtype=BF16, device="meta")
    w = torch.empty((3, 3, 64, 64), device="meta")
    tail = (torch.empty((64, 4), device="meta"),
            torch.empty((4, 64), device="meta"),
            torch.empty((7, 7, 2, 1), device="meta"))
    before = (k7.conv3x3_in.launches, k7.conv_block_tail.launches,
              k1.residual_chain.launches)
    k7.conv3x3_in(x, w)
    k7.conv_block_tail(x, x, w, *tail)
    assert calls == ["k7", "k8"]
    assert (k7.conv3x3_in.launches, k7.conv_block_tail.launches) == \
        (before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        k1.residual_chain(x, w[None], w[None], *(t[None] for t in tail))
    assert k1.residual_chain.launches == before[2]
    k7.conv3x3_in.launches, k7.conv_block_tail.launches = before[:2]


# One shape per route on an H100: 12 x 20 x 64 takes the resident route for
# K7, K8 and K1 in bf16 and int8 (2 tiles); fp32 at any shape and C = 192
# for K8 take the tiled one. On the CPU both run the plain versions, held
# here against the Pallas kernels in interpret mode.
PARITY = [("resident-shape", 64, 12, 20), ("tiled-shape", 192, 6, 10)]


def _jnp(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("c,h,w", [p[1:] for p in PARITY],
                         ids=[p[0] for p in PARITY])
def test_k7_and_k8_match_pallas_at_a_shape_of_each_route(c, h, w):
    """fp32 through K7 then K8 on K7's output vs conv3x3_in_pallas and
    conv_block_tail_pallas (interpret): rtol 1e-4, atol 1e-5 on K7 (fp32
    summation order) and on K8 fed the reference's own t."""
    want_k8 = "resident" if c == 64 else "tiled"
    assert k7.conv_route(h, w, c, BF16, H100_BLOCKS, tail=True) == want_k8
    assert k7.conv_route(h, w, c, F32, H100_BLOCKS, tail=True) == "tiled"
    d = _inputs(c, h, w, 5)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    ref_t = conv3x3_in_pallas(j["xp"], j["w"], pad=1, interpret=True)
    got_t = k7.conv3x3_in(T(d["xp"]), T(d["w"]), pad=1)
    np.testing.assert_allclose(got_t.numpy(), _jnp(ref_t), rtol=1e-4,
                               atol=1e-5)
    ref = conv_block_tail_pallas(ref_t, j["xp"], j["wb"], j["w1"], j["w2"],
                                 j["wsa"], pad=1, x_pad=1, interpret=True)
    got = k7.conv_block_tail(T(np.asarray(ref_t)), T(d["xp"]), T(d["wb"]),
                             T(d["w1"]), T(d["w2"]), T(d["wsa"]), pad=1,
                             x_pad=1)
    assert got.shape == (2, h + 2, w + 2, c)
    np.testing.assert_allclose(got.numpy(), _jnp(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("c,h,w", [p[1:] for p in PARITY],
                         ids=[p[0] for p in PARITY])
def test_k7_int8_write_matches_pallas_at_a_shape_of_each_route(c, h, w):
    """K7's int8 write (what K1q and quant mega put between the halves) vs
    the TPU kernel's: codes equal on >= 99.9%, never more than a step
    apart."""
    d = _inputs(c, h, w, 5)
    ref = conv3x3_in_pallas(jnp.asarray(d["xp"]), jnp.asarray(d["w"]), pad=1,
                            int8_scale=S, interpret=True)
    got = k7.conv3x3_in(T(d["xp"]), T(d["w"]), pad=1, int8_scale=S)
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(ref, np.int32))
    assert diff.max() <= 1 and float(np.mean(diff == 0)) >= 0.999


@pytest.mark.parametrize("c,h,w", [p[1:] for p in PARITY],
                         ids=[p[0] for p in PARITY])
@pytest.mark.parametrize("pad", [0, 1])
def test_k1_matches_pallas_at_a_shape_of_each_route(c, h, w, pad):
    """K1 (two blocks) vs residual_chain_pallas (interpret), fp32: rtol
    1e-4, atol 1e-5."""
    k = 2
    ds = [_inputs(c, h, w, 11 + i) for i in range(k)]
    st = lambda key: np.stack([d[key] for d in ds])
    args = (ds[0]["xp"], st("w"), st("wb"), st("w1"), st("w2"), st("wsa"))
    ref = residual_chain_pallas(*map(jnp.asarray, args), pad=pad,
                                interpret=True)
    got = k1.residual_chain(*map(T, args), pad=pad)
    assert got.shape == (2, h + 2 * pad, w + 2 * pad, c)
    np.testing.assert_allclose(got.numpy(), _jnp(ref), rtol=1e-4, atol=1e-5)
