"""The port's packed (space-to-depth) and fused forwards (models/fused.py)
against the JAX package's on the CPU, at a small size: 32^2 slices, base 8
(a 32-channel trunk), 2 residual blocks, fp32, numpy inputs from a seed,
weights crossing through ``generator_state_dict_from_jax``.

Held:
  - each layout helper and weight transform exactly (atol 1e-6 on values
    ~1; the taps are summed in the JAX loop's order, so they agree to the
    bit in practice);
  - ``_conv_int8``'s int32 accumulator exactly, its output at rtol 1e-6;
  - ``generator_apply_packed`` for every trunk and quant mode, and
    ``generator_apply_fused``, at rtol 1e-4, atol 1e-5 (the JAX package's
    own forward tolerance, tests/test_fused_forward.py): JAX on the CPU
    runs its XLA fallbacks, the port its kernels' plain versions;
  - the "pallas" trunk's gradients through K2/K3 and K4/K5's autograd
    Functions at JAX's own packed-trunk bound (tests/test_fused_forward.py:
    rtol 5e-3, atol 6e-5 + 2e-3 max).
The engine and the train step on the packed forward:
tests/test_torch_packed_engine.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.models import fused as jf
from ducosy_tpu.models.generator import Generator as JaxGenerator
from ducosy_tpu_torch.models import fused as tf
from ducosy_tpu_torch.models.convert import generator_state_dict_from_jax
from ducosy_tpu_torch.models.generator import Generator
from ducosy_tpu_torch.ops.quant import conv_int8_dynamic, int_conv, \
    quantize_weights_int8

BASE, BLOCKS, SIZE = 8, 2, 32
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
EXACT = dict(rtol=0, atol=1e-6)


def _rng(seed=0):
    return np.random.default_rng(seed)


@functools.lru_cache(maxsize=None)
def _jax_params(seed, cbam=True, in_ch=1, blocks=BLOCKS):
    gen = JaxGenerator(in_ch, blocks, BASE, use_cbam=cbam, dtype=jnp.float32)
    p = jax.jit(gen.init)(jax.random.PRNGKey(seed),
                          jnp.zeros((1, SIZE, SIZE, in_ch)))
    return jax.tree_util.tree_map(np.asarray, p["params"])


def _input(seed=1, n=2, in_ch=1):
    return _rng(seed).uniform(-1, 1, (n, SIZE, SIZE, in_ch)).astype(
        np.float32)


# ------------------------------------------------ layouts and transforms
@pytest.mark.parametrize("name", ["_s2d2", "_d2s2", "_d2s4"])
def test_layout_helper_matches_jax(name):
    x = _rng(2).standard_normal((2, 8, 12, 32)).astype(np.float32)
    if name == "_d2s4":
        got, ref = tf._d2s(torch.from_numpy(x), 4), jf._d2s(jnp.asarray(x), 4)
    else:
        got = getattr(tf, name)(torch.from_numpy(x))
        ref = getattr(jf, name)(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


TRANSFORMS = {"s2d_conv_kernel": 7, "subpixel_kernel": 3,
              "down_conv_packed_kernel": 3, "up_packed_kernel": 3,
              "up2_packed_kernel": 3, "head_packed_kernel": 7}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_weight_transform_matches_jax(name):
    """Exact in fp32; the phase-major channel order included."""
    k = TRANSFORMS[name]
    w = _rng(3).standard_normal((k, k, 3, 5)).astype(np.float32)
    got = getattr(tf, name)(torch.from_numpy(w)).numpy()
    ref = np.asarray(getattr(jf, name)(jnp.asarray(w)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **EXACT)


def test_weight_transforms_are_differentiable():
    """Training transforms the weights in each forward: the gradient of a
    transformed kernel reaches its source (each tap's count of uses)."""
    w = torch.ones((3, 3, 2, 2), requires_grad=True)
    tf.up2_packed_kernel(w).sum().backward()
    assert w.grad.sum().item() == 9 * 2 * 2 * 16


@pytest.mark.parametrize("fill", [0, -128])
def test_packed16_reflect_pad3_matches_jax(fill):
    """The border phases of the packed head pad: max |d| over every value
    (an off-by-one moves only the outer 3 true pixels)."""
    x = _rng(4).integers(-127, 127, (2, 6, 5, 16 * 3)).astype(np.float32)
    got = tf.packed16_reflect_pad3(torch.from_numpy(x), 3, fill).numpy()
    ref = np.asarray(jf.packed16_reflect_pad3(jnp.asarray(x), 3, fill))
    np.testing.assert_array_equal(got, ref)
    # on a true image packed by 4, the pad is ReflectionPad2d(3) inside a
    # ring of ``fill``
    img = torch.from_numpy(_rng(5).standard_normal((1, 24, 20, 3)).astype(
        np.float32))
    packed = img.reshape(1, 6, 4, 5, 4, 3).permute(0, 1, 3, 2, 4, 5) \
        .reshape(1, 6, 5, 48)
    pad = tf._d2s(tf.packed16_reflect_pad3(packed, 3, fill), 4)
    assert pad.shape == (1, 32, 28, 3)
    torch.testing.assert_close(pad[:, 1:-1, 1:-1], tf.reflect_pad(img, 3),
                               rtol=0, atol=0)
    ring = torch.cat([pad[:, 0].flatten(), pad[:, -1].flatten(),
                      pad[:, :, 0].flatten(), pad[:, :, -1].flatten()])
    assert bool((ring == fill).all())


def test_stem_s2d_and_subpixel_match_jax():
    x = _rng(6).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    w = (_rng(7).standard_normal((7, 7, 3, 16)) * 0.1).astype(np.float32)
    b = (_rng(8).standard_normal(16) * 0.1).astype(np.float32)
    got = tf.stem_s2d(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), ref_pad=3, dtype=torch.float32)
    ref = jf.stem_s2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      ref_pad=3, dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    x = _rng(9).uniform(-1, 1, (2, 16, 16, 8)).astype(np.float32)
    w = (_rng(10).standard_normal((3, 3, 8, 4)) * 0.1).astype(np.float32)
    got = tf.upsample_conv_subpixel(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(b[:4]),
                                    dtype=torch.float32)
    ref = jf.upsample_conv_subpixel(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b[:4]), dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("groups", [1, 4, 16])
def test_packed_norms_match_jax(groups):
    """packed_in_relu (with and without ReLU) at rtol 1e-5; the int8 write
    on the shifted grid: codes equal on >= 99.9%, never one step apart more
    (fp32 statistics one ulp apart)."""
    x = _rng(11).standard_normal((2, 6, 7, 16 * groups)).astype(np.float32)
    for relu in (True, False):
        got = tf.packed_in_relu(torch.from_numpy(x), groups, relu)
        ref = jf.packed_in_relu(jnp.asarray(x), groups, relu)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    got = tf.packed_in_relu_int8(torch.from_numpy(x), groups).numpy()
    ref = np.asarray(jf.packed_in_relu_int8(jnp.asarray(x), groups))
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1 and float(np.mean(d == 0)) >= 0.999


def test_conv_int8_dynamic_matches_jax():
    """The XLA trunk's dynamic requant: the int32 accumulator of the
    per-sample quantized activations exactly, the dequantized output at
    rtol 1e-6; each sample's scale is its own (changing sample 1 leaves
    sample 0's output as it was)."""
    rng = _rng(12)
    x = rng.standard_normal((3, 10, 9, 32)).astype(np.float32)
    x[1] *= 40.0                                     # another amax
    w = (rng.standard_normal((3, 3, 32, 16)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(16) * 0.1).astype(np.float32)
    ref = np.asarray(jf._conv_int8(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b)))
    wq, ws = quantize_weights_int8(torch.from_numpy(w))
    xt = torch.from_numpy(x)
    got = conv_int8_dynamic(xt, wq, ws, torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    # the accumulator: JAX's XLA int8 conv of the same codes
    xs = np.maximum(np.abs(x).max(axis=(1, 2, 3), keepdims=True),
                    1e-12) / 127.0
    xq = np.array(jnp.round(jnp.asarray(x) / jnp.asarray(xs))
                  .astype(jnp.int8))
    acc_ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq.numpy()), (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    acc = int_conv(torch.from_numpy(xq), wq).numpy()
    np.testing.assert_array_equal(acc, acc_ref)
    x2 = x.copy()
    x2[1] *= 3.0
    again = conv_int8_dynamic(torch.from_numpy(x2), wq, ws,
                              torch.from_numpy(b))
    torch.testing.assert_close(again[0], got[0], rtol=0, atol=0)


# ------------------------------------------------------------- forwards
PACKED_TRUNKS = ["xla", "pallas", "mega", "mono", "chain1", "chain2"]


@pytest.mark.parametrize("quant", [None, "trunk", "full"])
@pytest.mark.parametrize("trunk", PACKED_TRUNKS)
def test_generator_apply_packed_matches_jax(trunk, quant):
    """CBAM, 2 blocks; every trunk with every quant mode (the kernel trunks
    through their wrappers' plain versions)."""
    p = _jax_params(0)
    x = _input()
    ref = jf.generator_apply_packed(p, jnp.asarray(x), num_residual_blocks=2,
                                    dtype=jnp.float32, trunk=trunk,
                                    quant=quant)
    got = tf.generator_apply_packed(generator_state_dict_from_jax(p),
                                    torch.from_numpy(x),
                                    num_residual_blocks=2,
                                    dtype=torch.float32, trunk=trunk,
                                    quant=quant)
    assert got.shape == (2, SIZE, SIZE, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


@pytest.mark.parametrize("encoder_fused", [True, False])
def test_packed_forward_three_channels_matches_module(encoder_fused):
    """A mask-conditioned (3-channel) generator: the packed forward from the
    port's module equals the port's module forward and JAX's packed one."""
    p = _jax_params(1, in_ch=3)
    x = _input(13, in_ch=3)
    gen = Generator.from_state_dict(generator_state_dict_from_jax(p),
                                    trunk="plain")
    with torch.no_grad():
        got = tf.generator_apply_packed(gen, torch.from_numpy(x),
                                        trunk="pallas",
                                        encoder_fused=encoder_fused)
        mod = gen(torch.from_numpy(x))
    ref = jf.generator_apply_packed(p, jnp.asarray(x), num_residual_blocks=2,
                                    dtype=jnp.float32, trunk="pallas",
                                    encoder_fused=encoder_fused)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)
    np.testing.assert_allclose(got.numpy(), mod.numpy(), **FWD_TOL)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_generator_apply_fused_matches_jax(use_pallas):
    p = _jax_params(0)
    x = _input(14)
    ref = jf.generator_apply_fused(p, jnp.asarray(x), num_residual_blocks=2,
                                   dtype=jnp.float32, use_pallas=use_pallas)
    got = tf.generator_apply_fused(generator_state_dict_from_jax(p),
                                   torch.from_numpy(x),
                                   dtype=torch.float32, use_pallas=use_pallas)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


@pytest.mark.parametrize("quant", [None, "full"])
def test_packed_generator_lays_weights_out_once(quant):
    """PackedGenerator (the engine's: weights transformed once, channels
    last) computes generator_apply_packed on the state dict."""
    sd = generator_state_dict_from_jax(_jax_params(0))
    x = torch.from_numpy(_input(15))
    pg = tf.PackedGenerator(sd, dtype=torch.float32, device="cpu",
                            trunk="chain2", quant=quant)
    assert pg.weights.convs["u1"].is_contiguous(
        memory_format=torch.channels_last)
    torch.testing.assert_close(
        pg(x), tf.generator_apply_packed(sd, x, trunk="chain2", quant=quant),
        rtol=0, atol=0)


@pytest.mark.parametrize("kw,match", [
    ({"trunk": "chain3"}, "chain length"),
    ({"trunk": "tail"}, "trunk must be"),
    ({"num_residual_blocks": 3}, "num_residual_blocks"),
    ({"quant": "int4"}, "quant must be"),
], ids=["chain-too-long", "module-trunk", "depth", "quant"])
def test_generator_apply_packed_refuses(kw, match):
    sd = generator_state_dict_from_jax(_jax_params(0))
    with pytest.raises(ValueError, match=match):
        tf.generator_apply_packed(sd, torch.from_numpy(_input()), **kw)


def test_auto_trunk_is_chosen_by_the_tensor_device():
    assert tf.resolve_trunk("auto", 9, "cpu") == ("xla", 1)
    assert tf.resolve_trunk("auto", 9, "cuda") == ("pallas", 1)
    assert tf.resolve_trunk("chain3", 9, "cpu") == ("chain", 3)
    assert tf.resolve_trunk("mono", 9, "cpu") == ("mono", 1)


def test_packed_pallas_trunk_gradients_match_jax():
    """The "pallas" trunk (the card's training trunk) under autograd: K2/K3
    and K4/K5's Functions on the CPU against JAX's packed pallas trunk with
    its custom VJPs, encoder_fused off as in training."""
    p = _jax_params(2)
    x, tgt = _input(16, n=1), _input(17, n=1)
    loss = lambda pp: jnp.mean((jf.generator_apply_packed(
        pp, jnp.asarray(x), num_residual_blocks=2, dtype=jnp.float32,
        trunk="pallas", encoder_fused=False) - jnp.asarray(tgt)) ** 2)
    ref = generator_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss))(p)))
    gen = Generator.from_state_dict(generator_state_dict_from_jax(p),
                                    trunk="plain")
    out = tf.generator_apply_packed(gen, torch.from_numpy(x), trunk="pallas",
                                    encoder_fused=False)
    ((out - torch.from_numpy(tgt)) ** 2).mean().backward()
    for name, prm in gen.named_parameters():
        a, b = ref[name], prm.grad.numpy()
        np.testing.assert_allclose(b, a, rtol=5e-3,
                                   atol=6e-5 + 2e-3 * np.abs(a).max(),
                                   err_msg=name)
