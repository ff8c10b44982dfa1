"""The two routes of K4 (block_tail) and K5 (block_tail_bwd) in the port, on
the CPU.

What a CPU can hold of kernels that run only on a card: the pure route
choice (``tail_route``, ``tail_groups``) over shapes, dtypes and co-resident
block counts; the scratch each route gets; that the entry points of the
resident kernels are declared to ctypes; that the wrappers refuse a CPU or a
malformed tensor before any build and never run a plain version for a
tensor that is not on the CPU; plain emulations of what the resident K5
computes per block (the 7x7 spatial-gate adjoint from the map rows within 6
of a 128-pixel tile, and the gather that folds the output cotangent for dx)
against the whole-image versions the tiled route and the plain version use;
and, at one shape per route, the plain versions against the Pallas kernels
in interpret mode on the same numpy-seeded inputs. Tolerances are stated per
test.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

from ducosy_tpu.ops.pallas.cbam_block import (
    block_tail_bwd_pallas,
    block_tail_pallas,
)
from ducosy_tpu_torch.models.layers import reflect_pad_adjoint
from ducosy_tpu_torch.ops.kernels import _build
from ducosy_tpu_torch.ops.kernels import block_tail as k4
from ducosy_tpu_torch.ops.kernels import conv_in as k7

T = torch.from_numpy
BF16, F32 = torch.bfloat16, torch.float32
H100_BLOCKS = 132     # an H100 SXM: 132 SMs x 1 block of the resident kernels
A100_BLOCKS = 114     # a card with fewer SMs than the trunk's 128 tiles

# (h, w, c, dtype, blocks_resident) -> route. 128 x 128 x 256 is the
# training trunk of a 512^2 slice (128 tiles of 128 pixels).
ROUTES = [
    ("trunk", 128, 128, 256, BF16, H100_BLOCKS, "resident"),
    ("trunk-114-sms", 128, 128, 256, BF16, A100_BLOCKS, "tiled"),
    ("trunk-fp32", 128, 128, 256, F32, H100_BLOCKS, "tiled"),
    ("trunk-fp32-114-sms", 128, 128, 256, F32, A100_BLOCKS, "tiled"),
    ("no-cooperative-launch", 128, 128, 256, BF16, 0, "tiled"),
    ("c192", 50, 70, 192, BF16, H100_BLOCKS, "tiled"),
    ("c128-ragged", 50, 70, 128, BF16, H100_BLOCKS, "resident"),
    ("c64-ragged-114-sms", 75, 93, 64, BF16, A100_BLOCKS, "resident"),
    ("c512", 18, 22, 512, BF16, H100_BLOCKS, "tiled"),
    ("w256", 64, 256, 256, BF16, H100_BLOCKS, "resident"),
    ("w384", 32, 384, 256, BF16, H100_BLOCKS, "tiled"),
    ("140-tiles", 140, 128, 256, BF16, H100_BLOCKS, "tiled"),
    ("128-tiles-128-blocks", 128, 128, 64, BF16, 128, "resident"),
    ("128-tiles-127-blocks", 128, 128, 64, BF16, 127, "tiled"),
]


@pytest.mark.parametrize("h,w,c,dtype,blocks,want", [r[1:] for r in ROUTES],
                         ids=[r[0] for r in ROUTES])
def test_tail_route_depends_on_shape_dtype_and_resident_blocks(
        h, w, c, dtype, blocks, want):
    """Resident needs bf16, C in (64, 128, 256) (one block holds every
    channel of its pixels), W <= 256 and every tile of a sample on the card
    at once; all else is tiled. The route is K8's (conv_route with tail)."""
    assert k4.tail_route(h, w, c, dtype, blocks) == want
    assert k7.conv_route(h, w, c, dtype, blocks, tail=True) == want
    assert (k4.tail_groups(8, h, w, c, dtype, blocks) > 0) == \
        (want == "resident")


@pytest.mark.parametrize("n,h,w,c,blocks,want", [
    (8, 128, 128, 256, H100_BLOCKS, 1),    # the trunk: a sample at a time
    (8, 128, 128, 256, 264, 2),            # a card twice the size holds two
    (2, 50, 70, 128, H100_BLOCKS, 2),      # 28 tiles: both side by side
    (16, 50, 70, 128, H100_BLOCKS, 4),     # 132 // 28
    (8, 128, 128, 256, A100_BLOCKS, 0),    # tiled
], ids=["trunk", "trunk-264", "ragged-n2", "ragged-n16", "tiled"])
def test_tail_groups_fill_the_card_without_exceeding_it(n, h, w, c, blocks,
                                                        want):
    groups = k4.tail_groups(n, h, w, c, BF16, blocks)
    assert groups == want
    assert groups * -(-h * w // k4.TILE_M) <= blocks
    assert groups <= k7.BARRIER_WORDS


# (resident, backward) -> the scratch's shapes at (n, h, w, c) = (2, 16, 24,
# 64): 3 tiles of 128 pixels
SCRATCH = [
    ("k4-tiled", False, False, (3, 2, 3, 64), (3, 2, 64), None, None),
    ("k4-resident", True, False, (3, 2, 3, 64), (3, 2, 64), (2, 384, 2),
     None),
    ("k5-tiled", False, True, (3, 2, 3, 64), (4, 2, 64), (2, 4, 16, 24),
     None),
    ("k5-resident", True, True, (6, 2, 3, 64), (7, 2, 64), (2, 2, 384, 2),
     (2, 3, 98)),
]


@pytest.mark.parametrize("resident,backward,part,stats,maps,pdwsa",
                         [s[1:] for s in SCRATCH], ids=[s[0] for s in SCRATCH])
def test_tail_scratch_per_route(resident, backward, part, stats, maps, pdwsa):
    """fp32 partials, per-channel vectors and per-pixel maps sized for the
    route; zeroed barrier words (one per group) only where the kernel is
    cooperative."""
    sc = k4.tail_scratch(2, 16, 24, 64, "cpu", resident=resident,
                         backward=backward, groups=2)
    assert sc.partials.shape == part and sc.partials.dtype == F32
    assert sc.stats.shape == stats and sc.stats.dtype == F32
    assert (sc.maps is None) == (maps is None)
    if maps is not None:
        assert sc.maps.shape == maps and sc.maps.dtype == F32
    assert (sc.pdwsa is None) == (pdwsa is None)
    if pdwsa is not None:
        assert sc.pdwsa.shape == pdwsa
    if resident:
        assert sc.barrier.shape == (2,) and sc.barrier.dtype == torch.int64
        assert not sc.barrier.any()
    else:
        assert sc.barrier is None


def test_resident_scratch_at_the_training_shape_is_small():
    """The resident K5's scratch at (8, 128, 128, 256) is under 16 MB beside
    the 136 MB of h and g it reads."""
    sc = k4.tail_scratch(8, 128, 128, 256, "meta", resident=True,
                         backward=True)
    nbytes = sum(t.numel() * t.element_size() for t in sc)
    assert nbytes < 16 * 2 ** 20


# ---- the resident entry points, declared to ctypes

_RESIDENT_ENTRIES = {
    "block_tail": ("ducosy_block_tail_resident",
                   "ducosy_block_tail_resident_blocks"),
    "block_tail_bwd": ("ducosy_block_tail_bwd_resident",
                       "ducosy_block_tail_bwd_resident_blocks"),
}


@pytest.mark.parametrize("name", sorted(_RESIDENT_ENTRIES))
def test_resident_entry_points_are_declared(name, monkeypatch):
    """Each source defines its resident kernel's entry point and occupancy
    query, and the loader declares both (their argument types are held to
    the C declarations by test_torch_conv_resident's signature test)."""
    text = (_build.CSRC_DIR / f"{name}.cu").read_text()
    declared = {}

    class Fake:
        def __getattr__(self, fn):
            ns = type("NS", (), {})()
            declared[fn] = ns
            setattr(self, fn, ns)
            return ns

    monkeypatch.setattr(_build, "load_library", lambda lib: Fake())
    (k4._lib if name == "block_tail" else k4._bwd_lib).__wrapped__()
    for fn in _RESIDENT_ENTRIES[name]:
        assert re.search(rf'extern "C" int {fn}\(', text), fn
        assert declared[fn].restype is not None and declared[fn].argtypes


# ---- the wrappers on a CPU box


def _tail_inputs(n, h, w, c, pad, x_pad, seed=0):
    rng = np.random.default_rng(seed)
    r = max(c // 16, 1)
    f = lambda *s, std=1.0, mean=0.0: rng.normal(mean, std, s) \
        .astype(np.float32)
    return (f(n, h, w, c, std=1.5, mean=0.3),
            f(n, h + 2 * x_pad, w + 2 * x_pad, c), f(c, r, std=0.3),
            f(r, c, std=0.3), f(7, 7, 2, 1, std=0.3),
            f(n, h + 2 * pad, w + 2 * pad, c))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_launchers_refuse_a_cpu_tensor_without_building(dtype, monkeypatch):
    """The launch functions (what a CUDA tensor reaches) raise on a CPU
    tensor before any library is built or loaded, on either route."""
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", no_build)
    h, x, w1, w2, wsa, g = (T(a) for a in _tail_inputs(1, 6, 6, 64, 1, 1))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        k4.launch_block_tail(h.to(dtype), x.to(dtype), w1, w2, wsa, pad=1,
                             x_pad=1, eps=1e-5)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        k4.launch_block_tail_bwd(h.to(dtype), g.to(dtype), w1, w2, wsa,
                                 pad=1, x_pad=1, eps=1e-5)
    assert k4.resident_blocks("cpu") == 0
    assert k4.resident_blocks("cpu", backward=True) == 0


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


BAD = [
    ("int8", dict(h=_meta(1, 8, 8, 64, dtype=torch.int8)), TypeError,
     "float32 or bfloat16"),
    ("c96", dict(h=_meta(1, 8, 8, 96), x=_meta(1, 10, 10, 96),
                 g=_meta(1, 10, 10, 96), w1=_meta(96, 6, dtype=F32),
                 w2=_meta(6, 96, dtype=F32)), ValueError,
     "C a multiple of 64"),
    ("second-shape", dict(x=_meta(1, 8, 8, 64), g=_meta(1, 8, 8, 64)),
     ValueError, "second input"),
    ("second-dtype", dict(x=_meta(1, 10, 10, 64, dtype=F32),
                          g=_meta(1, 10, 10, 64, dtype=F32)), ValueError,
     "second input"),
    ("w1-shape", dict(w1=_meta(64, 5, dtype=F32)), ValueError, "w2 is"),
    ("wsa-shape", dict(wsa=_meta(7, 7, 1, 2, dtype=F32)), ValueError,
     "wsa is"),
    ("pad-2", dict(pad=2, g=_meta(1, 12, 12, 64)), ValueError,
     "pads 0 or 1"),
]


class _DeviceAs:
    """A meta tensor that reports another device and a 16-byte aligned
    address; everything else is the tensor's."""

    def __init__(self, t, device):
        self._t, self.device = t, torch.device(device)

    def __getattr__(self, name):
        return getattr(self._t, name)

    def data_ptr(self):
        return 0


@pytest.mark.parametrize("args,exc,match", [b[1:] for b in BAD],
                         ids=[b[0] for b in BAD])
@pytest.mark.parametrize("backward", [False, True], ids=["k4", "k5"])
def test_wrappers_refuse_malformed_inputs(args, exc, match, backward):
    """What the kernels do not take raises in the launchers' first step
    (_validate, before any build): dtype, C, the second input's shape and
    dtype, the weights' shapes, the pads. Meta tensors that report a CUDA
    device stand in for CUDA tensors: no card needed."""
    kw = dict(h=_meta(1, 8, 8, 64), x=_meta(1, 10, 10, 64),
              g=_meta(1, 10, 10, 64), w1=_meta(64, 4, dtype=F32),
              w2=_meta(4, 64, dtype=F32), wsa=_meta(7, 7, 2, 1, dtype=F32),
              pad=1)
    kw.update(args)
    cuda = lambda t: _DeviceAs(t, "cuda")
    pad = kw["pad"]
    other, other_pad = (kw["g"], pad) if backward else (kw["x"], 1)
    with pytest.raises(exc, match=match):
        k4._validate("block_tail_bwd" if backward else "block_tail",
                     cuda(kw["h"]), cuda(other), other_pad, cuda(kw["w1"]),
                     cuda(kw["w2"]), cuda(kw["wsa"]), pad)


def test_validation_takes_a_well_formed_call():
    """The same stand-ins, well formed, pass (so each refusal above is the
    one its case names)."""
    cuda = lambda t: _DeviceAs(t, "cuda")
    w = [cuda(t) for t in (_meta(64, 4, dtype=F32), _meta(4, 64, dtype=F32),
                           _meta(7, 7, 2, 1, dtype=F32))]
    for other_pad in (0, 1):
        k4._validate("block_tail", cuda(_meta(1, 8, 8, 64)),
                     cuda(_meta(1, 8 + 2 * other_pad, 8 + 2 * other_pad, 64)),
                     other_pad, *w, 1)


@pytest.mark.parametrize("backward", [False, True], ids=["k4", "k5"])
def test_wrappers_never_run_a_plain_version_for_a_cuda_tensor(backward,
                                                              monkeypatch):
    """A tensor that is not on the CPU goes to the launcher and is counted:
    with the plain versions and the launchers replaced, a meta tensor
    reaches only the launcher."""
    calls = []

    def plain(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(k4, "block_tail_plain", plain)
    monkeypatch.setattr(k4, "block_tail_bwd_plain", plain)
    monkeypatch.setattr(k4, "launch_block_tail",
                        lambda *a, **k: calls.append("k4"))
    monkeypatch.setattr(k4, "launch_block_tail_bwd",
                        lambda *a, **k: calls.append("k5"))
    h, xp = _meta(1, 8, 8, 64), _meta(1, 10, 10, 64)
    w = (_meta(64, 4, dtype=F32), _meta(4, 64, dtype=F32),
         _meta(7, 7, 2, 1, dtype=F32))
    fn = k4.block_tail_bwd if backward else k4.block_tail
    before = fn.launches
    fn(h, xp, *w, pad=1, x_pad=1)
    assert calls == ["k5" if backward else "k4"]
    assert fn.launches == before + 1
    fn.launches = before


# ---- what the resident K5 computes per block, emulated plainly


def _tile_rows(m0, rows, w):
    return m0 // w, (m0 + rows - 1) // w


def _block_local_adjoint(stat, dgs, wsa):
    """The resident K5's 7x7 adjoint, tile by tile, as its blocks compute
    it: a 128-pixel tile stages the map rows within 6 of its own, computes
    gs and dz = dgs gs (1 - gs) over the rows within 3 (z of such a pixel
    needs the stats within 3 of it), then dstat at its own pixels from that
    dz and its own partial of dwsa (dz at its pixels times the stats within
    reach). Zero padding only at the image's edges: every window stays
    inside the staged rows. Returns gs and dstat (N, k, H, W) assembled from
    the tiles' own pixels, and the per-tile dwsa partials (tiles, 7, 7, 2,
    1)."""
    n, _, h, w = stat.shape
    wt = k4.hwio_to_oihw(wsa)
    gs_out = torch.full((n, 1, h, w), float("nan"))
    dstat_out = torch.full((n, 2, h, w), float("nan"))
    partials = []
    for m0 in range(0, h * w, k4.TILE_M):
        rows = min(k4.TILE_M, h * w - m0)
        ra, rb = _tile_rows(m0, rows, w)
        lo6, hi6 = max(ra - 6, 0), min(rb + 7, h)
        lo3, hi3 = max(ra - 3, 0), min(rb + 4, h)
        s = stat[:, :, lo6:hi6]                       # the staged rows
        z = F.conv2d(s, wt, padding=3)[:, :, lo3 - lo6:hi3 - lo6]
        gs = torch.sigmoid(z)
        dz = dgs[:, :, lo3:hi3] * gs * (1 - gs)       # the dz rows
        dstat = conv2d_input((n, 2, hi3 - lo3, w), wt, dz, padding=3)
        own = torch.zeros(h * w, dtype=torch.bool)
        own[m0:m0 + rows] = True
        own = own.reshape(h, w)
        dz_own = torch.zeros((n, 1, hi6 - lo6, w))
        dz_own[:, :, lo3 - lo6:hi3 - lo6] = dz * own[lo3:hi3]
        dz_own *= own[lo6:hi6]
        partials.append(conv2d_weight(s, wt.shape, dz_own, padding=3)
                        .permute(2, 3, 1, 0))
        sel = own[lo3:hi3]
        gs_out[:, :, lo3:hi3][..., sel] = gs[..., sel]
        dstat_out[:, :, lo3:hi3][..., sel] = dstat[..., sel]
    return gs_out, dstat_out, torch.stack(partials)


@pytest.mark.parametrize("h,w", [(12, 128), (20, 24), (9, 200), (5, 7),
                                 (30, 100)],
                         ids=["rows-128", "ragged-24", "straddle-200",
                              "small", "straddle-3-rows"])
def test_block_local_adjoint_matches_the_whole_image_adjoint(h, w):
    """Each tile's gs, dz and dstat from the map rows within 6 of it equal
    the whole-image 7x7 adjoint (_spatial_adjoint, which the tiled route
    and the plain version run) at its pixels, and the tiles' dwsa partials
    sum to its dwsa: fp32, atol 1e-5 (dwsa, sums of some thousand terms of
    size ~20 in another order: also rtol 1e-5)."""
    rng = np.random.default_rng(3)
    stat = T(rng.normal(0, 1, (2, 2, h, w)).astype(np.float32))
    dgs = T(rng.normal(0, 1, (2, 1, h, w)).astype(np.float32))
    wsa = T(rng.normal(0, 0.3, (7, 7, 2, 1)).astype(np.float32))
    gs_ref, dstat_ref, dwsa_ref = k4._spatial_adjoint(stat, dgs, wsa)
    gs, dstat, partials = _block_local_adjoint(stat, dgs, wsa)
    assert partials.shape[0] == -(-h * w // k4.TILE_M)
    torch.testing.assert_close(gs, gs_ref, atol=1e-6, rtol=0)
    torch.testing.assert_close(dstat, dstat_ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(partials.sum(dim=0), dwsa_ref, atol=1e-5,
                               rtol=1e-5)


def _gather_fold(g, pad, x_pad):
    """dx as the resident K5 writes it: each interior pixel gathers the 1,
    2 or 4 places of g (N, H+2pad, W+2pad, C) that the reflect pad mirrored
    onto it, summed in fp32, and writes the sum at its place in dx; with
    x_pad 1 each edge pixel also writes the zero border places beside it.
    Returns dx and how often each place of it was written."""
    n, hp, wp, c = g.shape
    h, w = hp - 2 * pad, wp - 2 * pad
    dx = torch.full((n, h + 2 * x_pad, w + 2 * x_pad, c), float("nan"))
    writes = torch.zeros(dx.shape[1:3], dtype=torch.int64)
    g = g.to(torch.float32)
    for a in range(h):
        for b in range(w):
            if pad:
                ro = [a + 1] + ([0] if a == 1 else []) + \
                    ([h + 1] if a == h - 2 else [])
                co = [b + 1] + ([0] if b == 1 else []) + \
                    ([w + 1] if b == w - 2 else [])
            else:
                ro, co = [a], [b]
            s = sum(g[:, r, q] for r in ro for q in co)
            dx[:, a + x_pad, b + x_pad] = s
            writes[a + x_pad, b + x_pad] += 1
            if x_pad:
                ro = [a + 1] + ([0] if a == 0 else []) + \
                    ([h + 1] if a == h - 1 else [])
                co = [b + 1] + ([0] if b == 0 else []) + \
                    ([w + 1] if b == w - 1 else [])
                for i, r in enumerate(ro):
                    for j, q in enumerate(co):
                        if i + j:
                            dx[:, r, q] = 0.0
                            writes[r, q] += 1
    return dx, writes


@pytest.mark.parametrize("pad,x_pad", [(0, 0), (0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("h,w", [(6, 9), (2, 2)], ids=["6x9", "2x2"])
def test_gather_fold_of_dx_matches_the_reflect_pad_adjoint(pad, x_pad, h, w):
    """The kernel's per-pixel gather of dx equals the wrapper's fp32 fold
    (reflect_pad_adjoint then _embed) that the tiled route and the plain
    version compute, every place of dx written exactly once: rtol 1e-6
    (the four terms of a crossing summed in another order)."""
    rng = np.random.default_rng(11)
    g = T(rng.normal(0, 1, (2, h + 2 * pad, w + 2 * pad, 8))
          .astype(np.float32))
    dx, writes = _gather_fold(g, pad, x_pad)
    ref = k4._embed(reflect_pad_adjoint(g, pad), x_pad)
    assert (writes == 1).all()
    torch.testing.assert_close(dx, ref, rtol=1e-6, atol=1e-6)


# ---- the plain versions against the Pallas kernels, one shape per route

# On an H100 (132 resident blocks) in bf16: 12 x 20 x 64 (2 tiles) takes the
# resident route, 8 x 16 x 192 the tiled one. (At 6 x 10 x 192, 4 x 40 x 64
# and other shapes whose pixels do not fill whole rows of the Pallas
# kernel's blocks, block_tail_bwd_pallas in interpret mode departs from the
# analytic adjoint _analytic_tail_bwd in dh by up to 8; the plain version
# agrees with the analytic one to 1e-5 there: a fault of the reference,
# not of the port, noted in ROADMAP.md.) On the CPU both run the plain
# versions, held here against the Pallas kernels in interpret mode (fp32).
PARITY = [("resident-shape", 12, 20, 64), ("tiled-shape", 8, 16, 192)]
PADS = [(1, 1), (0, 1)]     # blocks 1-8, block 9 of the trunk


def test_parity_shapes_take_the_routes_they_stand_for():
    for name, h, w, c in PARITY:
        assert k4.tail_route(h, w, c, BF16, H100_BLOCKS) == \
            name.split("-")[0]


@pytest.mark.parametrize("pad,x_pad", PADS)
@pytest.mark.parametrize("h,w,c", [p[1:] for p in PARITY],
                         ids=[p[0] for p in PARITY])
def test_k4_plain_matches_pallas_at_a_shape_of_each_route(h, w, c, pad,
                                                          x_pad):
    """block_tail (its plain version on the CPU) vs block_tail_pallas
    (interpret): fp32, atol 1e-5."""
    hh, x, w1, w2, wsa, _ = _tail_inputs(2, h, w, c, pad, x_pad, seed=4)
    ref = block_tail_pallas(*map(jnp.asarray, (hh, x, w1, w2, wsa)), pad=pad,
                            x_pad=x_pad, interpret=True)
    got = k4.block_tail(*map(T, (hh, x, w1, w2, wsa)), pad=pad, x_pad=x_pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("pad,x_pad", PADS)
@pytest.mark.parametrize("h,w,c", [p[1:] for p in PARITY],
                         ids=[p[0] for p in PARITY])
def test_k5_plain_matches_pallas_at_a_shape_of_each_route(h, w, c, pad,
                                                          x_pad):
    """block_tail_bwd (its plain version on the CPU) vs
    block_tail_bwd_pallas (interpret): every cotangent, fp32, atol 1e-4;
    the weight gradients (sums over N H W pixels of values up to ~100 at
    C = 192, in another order) also rtol 1e-5."""
    hh, _, w1, w2, wsa, g = _tail_inputs(2, h, w, c, pad, x_pad, seed=6)
    ref = block_tail_bwd_pallas(*map(jnp.asarray, (hh, g, w1, w2, wsa)),
                                pad=pad, x_pad=x_pad, interpret=True)
    got = k4.block_tail_bwd(*map(T, (hh, g, w1, w2, wsa)), pad=pad,
                            x_pad=x_pad)
    for name, a, b in zip(("dh", "dx", "dw1", "dw2", "dwsa"), got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-5 if name.startswith("dw") else 0,
                                   err_msg=name)
