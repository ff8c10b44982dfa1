"""K2 (InstanceNorm forward) and its placement in the port's serving forward,
on the CPU.

What a CPU can hold of a kernel that runs only on a card: the serving
forward with the stem, down1, down2, up1 and up2 norms on K2's wrapper (its
plain version here) against the previous composition, bit for bit, and
against the JAX packed forward; the plain version against the Pallas kernel
in interpret mode at C = 64 and a ragged H x W; the launch plan that the
wrapper hands the kernel; and that the wrapper refuses what the kernel does
not take before anything is built. Inputs are made from a seed with numpy;
tolerances are stated per test.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.models.fused import generator_apply_packed
from ducosy_tpu.models.generator import Generator as JaxGenerator
from ducosy_tpu.ops.pallas.instance_norm import instance_norm_pallas
from ducosy_tpu_torch.models import generator as gen_module
from ducosy_tpu_torch.models.convert import (
    generator_state_dict_from_jax,
    init_generator_state_dict,
)
from ducosy_tpu_torch.models.generator import Generator
from ducosy_tpu_torch.models.layers import instance_norm as plain_in
from ducosy_tpu_torch.models.layers import reflect_pad
from ducosy_tpu_torch.ops.kernels import _build
from ducosy_tpu_torch.ops.kernels import instance_norm as k2

T = torch.from_numpy
BLOCKS, BASE, SIZE = 2, 16, 32
H100_SMS, H100_L2 = 132, 50 * 2 ** 20


def _case(seed=0, n=2):
    rng = np.random.default_rng(seed)
    sd = init_generator_state_dict(seed, 1, BASE, BLOCKS)
    for key in sd:
        if key.endswith(".bias"):
            sd[key] = rng.normal(0, 0.1, sd[key].shape).astype(np.float32)
    return sd, rng.uniform(-1, 1, (n, SIZE, SIZE, 1)).astype(np.float32)


def _spy_k2(monkeypatch, composition: bool):
    """Replace the generator's K2 module by one that records every
    instance_norm call's pad and runs K2's wrapper, or, with
    ``composition``, the forward as it was before K2 took the stem, up1 and
    up2 norms: torch.relu(instance_norm(h)) at pad 0 (down1 gives the same
    bits either way), K2 at down2's pad 1."""
    pads = []

    def spy(h, *, relu, pad):
        pads.append(pad)
        if composition and pad == 0:
            assert relu
            return torch.relu(plain_in(h))
        return k2.instance_norm(h, relu=relu, pad=pad)

    fake = types.SimpleNamespace(**{k: getattr(k2, k) for k in dir(k2)
                                    if not k.startswith("__")})
    fake.instance_norm = spy
    monkeypatch.setattr(gen_module, "k2", fake)
    return pads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("trunk", ["chain", "mega"])
def test_serving_norms_on_k2_equal_the_previous_composition(trunk, dtype,
                                                            monkeypatch):
    """chain and mega: every encoder/decoder norm goes through K2's wrapper
    (five calls a forward: four at pad 0, down2's at pad 1), and the output
    equals, bit for bit, the forward with the stem, up1 and up2 norms as
    torch.relu(instance_norm(h)): ReLU and the rounding to the compute
    dtype commute."""
    sd, x = _case()
    gen = Generator.from_state_dict(sd, trunk=trunk,
                                    compute_dtype=dtype).eval()
    outs = {}
    for composition in (False, True):
        pads = _spy_k2(monkeypatch, composition)
        with torch.inference_mode():
            outs[composition] = gen(T(x))
        assert sorted(pads) == [0, 0, 0, 0, 1], pads
    assert outs[False].dtype == torch.float32
    assert torch.equal(outs[False], outs[True])


@pytest.mark.parametrize("trunk,quant,want", [
    ("chain", "trunk", [0, 0, 0, 0, 1]), ("mega", "trunk", [0, 0, 0, 0, 1]),
    ("chain", "full", [1]), ("mega", "full", [1]), ("tail", None, []),
    ("plain", None, []), ("tail", "trunk", [])])
def test_k2_placement_per_trunk_and_quant(trunk, quant, want, monkeypatch):
    """K2's instance_norm calls a serving forward makes: five under
    quant=None and "trunk" on chain and mega; down2's alone under "full"
    (its stem, down1, up1 and up2 norms quantize the fp32 value,
    ops/quant.py in_relu_int8); none on the tail and plain trunks, whose
    encoder/decoder norms stay plain as the JAX train step's
    encoder_fused=False leaves them."""
    sd, x = _case(1)
    gen = Generator.from_state_dict(sd, trunk=trunk, quant=quant).eval()
    pads = _spy_k2(monkeypatch, composition=False)
    with torch.inference_mode():
        gen(T(x))
    assert sorted(pads) == want


@pytest.mark.parametrize("trunk,jax_trunk", [("chain", "chain1"),
                                             ("mega", "mega")])
def test_serving_forward_matches_jax_packed(trunk, jax_trunk):
    """The port's serving forward (K2's wrapper at every encoder/decoder
    norm, its plain version here) vs generator_apply_packed at fp32 on the
    same JAX-initialised weights, converted by generator_state_dict_from_jax:
    atol 1e-3, the bound test_torch_conv_in.py holds the mega forward to
    (fp32 convolutions of two frameworks, summation order). Two blocks: the
    port's chain trunk runs one block per K1 call there, as chain1."""
    params = jax.tree_util.tree_map(np.asarray, JaxGenerator(
        1, BLOCKS, BASE).init(jax.random.PRNGKey(3),
                              jnp.zeros((1, SIZE, SIZE, 1)))["params"])
    x = np.random.default_rng(3).uniform(-1, 1, (2, SIZE, SIZE, 1)) \
        .astype(np.float32)
    ref = np.asarray(generator_apply_packed(
        params, jnp.asarray(x), num_residual_blocks=BLOCKS,
        dtype=jnp.float32, trunk=jax_trunk))
    gen = Generator.from_state_dict(generator_state_dict_from_jax(params),
                                    trunk=trunk).eval()
    with torch.inference_mode():
        got = gen(T(x))
    assert got.shape == (2, SIZE, SIZE, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("pad", [0, 1])
def test_instance_norm_plain_matches_pallas_ragged_c64(relu, pad):
    """K2's plain version vs instance_norm_pallas (interpret) at C = 64 and
    19 x 23 pixels (437: no multiple of a tile), atol 1e-5 (fp32 statistics
    on both sides, summation order)."""
    x = np.random.default_rng(4).normal(0.5, 2.0, (2, 19, 23, 64)) \
        .astype(np.float32)
    ref = instance_norm_pallas(jnp.asarray(x), relu=relu, pad=pad,
                               interpret=True)
    got = k2.instance_norm_plain(T(x), relu=relu, pad=pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


# (n, h, w, c) of K2's calls: the serving norms (stem = up2, down1 = up1,
# down2), the training trunk's, a 1024^2 slice's stem, a ragged shape and
# the phase-pooled width chip_smoke.py holds
PLAN_SHAPES = {"stem": (16, 512, 512, 64), "down1": (16, 256, 256, 128),
               "down2": (16, 128, 128, 256), "train": (8, 128, 128, 256),
               "stem-1024": (16, 1024, 1024, 64), "ragged": (3, 75, 93, 64),
               "phases": (16, 128, 128, 512), "n1": (1, 20, 24, 512)}


@pytest.mark.parametrize("sms", [H100_SMS, 114], ids=["sxm", "pcie"])
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_plan_cuts_every_sample_into_tiles_one_a_block(name, itemsize, sms):
    """The plan takes at least one sample at a time and never more than the
    co-resident blocks hold (group x tiles <= blocks, one block per SM);
    its tiles cover every pixel once, none empty, at most 128 a sample (the
    partials a channel that one block merges)."""
    n, h, w, c = PLAN_SHAPES[name]
    pl = k2.plan(n, h, w, c, itemsize, sms)
    assert pl.blocks == sms
    assert 1 <= pl.group <= n and pl.group * pl.tiles <= pl.blocks
    assert 1 <= pl.tiles <= k2.MAX_TILES
    assert (pl.tiles - 1) * pl.tile < h * w <= pl.tiles * pl.tile
    if n <= sms:
        assert pl.group == n          # the whole batch at once


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_plan_with_a_group_budget_fits_it(name, itemsize):
    """With group_bytes (the L2-resident form the by-parts reading measures,
    70% of an H100's 50 MB L2) a group's input fits the budget, or the group
    is one sample; and the tiles obey the same rules."""
    n, h, w, c = PLAN_SHAPES[name]
    budget = int(0.7 * H100_L2)
    pl = k2.plan(n, h, w, c, itemsize, H100_SMS, budget)
    sample = h * w * c * itemsize
    assert pl.group >= 1
    assert pl.group == 1 or pl.group * sample <= budget
    assert (pl.group + 1) * sample > budget or pl.group == n
    assert pl.group * pl.tiles <= pl.blocks and pl.tiles <= k2.MAX_TILES
    assert (pl.tiles - 1) * pl.tile < h * w <= pl.tiles * pl.tile


def test_plan_at_the_serving_shapes_on_an_h100():
    """The plan chip_smoke.py reads beside each time: N = 16 on 132 SMs
    takes 8 tiles a sample (128 blocks busy), a training batch of 8 16."""
    assert k2.plan(16, 512, 512, 64, 2, H100_SMS) == k2.Plan(16, 8, 32768,
                                                              132)
    assert k2.plan(16, 128, 128, 256, 2, H100_SMS) == k2.Plan(16, 8, 2048,
                                                               132)
    assert k2.plan(8, 128, 128, 256, 2, H100_SMS) == k2.Plan(8, 16, 1024,
                                                              132)


BAD = {"c96": ((1, 8, 8, 96), torch.bfloat16, {}, "multiple of 64"),
       "c8192-bf16": ((1, 8, 8, 8192), torch.bfloat16, {}, "above 4096"),
       "c4096-fp32": ((1, 8, 8, 4096), torch.float32, {}, "above 2048"),
       "pad2": ((1, 8, 8, 64), torch.bfloat16, {"pad": 2}, "pad=2"),
       "pad1-h1": ((1, 1, 8, 64), torch.bfloat16, {"pad": 1},
                   "reflect needs"),
       "3d": ((8, 8, 64), torch.bfloat16, {}, "NHWC"),
       "fp16": ((1, 8, 8, 64), torch.float16, {}, "float32 or bfloat16"),
       "phases5": ((1, 8, 8, 192), torch.bfloat16, {"phases": 5},
                   "phases=5")}


@pytest.mark.parametrize("shape,dtype,kw,match", BAD.values(), ids=BAD)
def test_wrapper_refuses_a_bad_shape_before_any_build(shape, dtype, kw, match,
                                                      monkeypatch):
    """A tensor that is not on the CPU (meta here: no data, no card) with a
    shape, dtype or option the kernel does not take raises before any
    library is built or loaded; a good one is refused only for its device."""
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "load_library", no_build)
    before = k2.instance_norm.launches
    x = torch.empty(shape, dtype=dtype, device="meta")
    err = TypeError if dtype == torch.float16 else ValueError
    with pytest.raises(err, match=match):
        k2.instance_norm(x, relu=True, **kw)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        k2.instance_norm(torch.empty((1, 8, 8, 64), dtype=torch.bfloat16,
                                     device="meta"), relu=True, pad=1)
    assert k2.instance_norm.launches == before


def test_cpu_tensors_take_the_plain_version_uncounted():
    """A CPU tensor runs instance_norm_plain (the int8 write its plain
    version too), counts no launch and builds nothing."""
    x = T(np.random.default_rng(5).normal(0, 1, (2, 9, 11, 64))
          .astype(np.float32)).to(torch.bfloat16)
    before = (k2.instance_norm.launches, k2.instance_norm_int8.launches)
    assert torch.equal(k2.instance_norm(x, relu=True, pad=1),
                       k2.instance_norm_plain(x, relu=True, pad=1))
    assert torch.equal(k2.instance_norm_int8(x, pad=1),
                       k2.instance_norm_int8_plain(x, pad=1))
    assert torch.equal(k2.instance_norm(x, relu=True),
                       reflect_pad(torch.relu(plain_in(x)), 0))
    assert (k2.instance_norm.launches,
            k2.instance_norm_int8.launches) == before
