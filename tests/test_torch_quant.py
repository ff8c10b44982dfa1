"""Quantized serving in the port (quant="trunk" and quant="full") against the
JAX package, on the CPU.

The same numpy inputs (made from a seed) go through the JAX function and
its counterpart in ducosy_tpu_torch: the weight quantization, the static
int8 convs, K2's int8 write and phase pooling (plain version vs
instance_norm_pallas in interpret mode), K1q (plain version vs
residual_chain_pallas in interpret mode), the sub-pixel int8 up2, the whole
generator and run_patient. All in fp32. Tolerances are stated per test.
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.infer.engine import DualGeneratorEngine as JaxEngine
from ducosy_tpu.models.fused import (
    _conv_int8_static,
    _d2s,
    _s2d2,
    generator_apply_packed,
    up2_packed_kernel,
)
from ducosy_tpu.models.generator import Generator as JaxGenerator
from ducosy_tpu.models.torch_import import generator_params_from_torch
from ducosy_tpu.ops.pallas import instance_norm as jin
from ducosy_tpu.ops.pallas.conv_in import residual_chain_pallas
from ducosy_tpu_torch.infer.engine import DualGeneratorEngine
from ducosy_tpu_torch.models.convert import (
    generator_state_dict_from_jax,
    init_generator_state_dict,
)
from ducosy_tpu_torch.models.generator import Generator
from ducosy_tpu_torch.ops import quant as q
from ducosy_tpu_torch.ops.kernels import instance_norm as k2
from ducosy_tpu_torch.ops.kernels import residual_chain as k1
from ducosy_tpu_torch.ops.kernels import tap_probe

sys.path.insert(0, os.path.dirname(__file__))
from synth import chest_hu  # noqa: E402

T = torch.from_numpy
BASE, SIZE = 8, 32
S = q.INT8_NORM_SCALE


def _codes_agree(got, ref, share=0.999):
    """int8 codes: equal on >= ``share`` of elements, never more than one
    code apart (a one-ulp difference of the fp32 statistics can move a value
    across a rounding boundary of the grid)."""
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(ref).astype(
        np.int32))
    assert d.max() <= 1, d.max()
    assert float(np.mean(d == 0)) >= share, float(np.mean(d == 0))


def test_grid_constants_match_jax():
    assert (q.INT8_GRID, q.INT8_ZERO_POINT, q.INT8_NORM_SCALE) == \
        (jin.INT8_GRID, jin.INT8_ZERO_POINT, jin.INT8_NORM_SCALE)


@pytest.mark.parametrize("shape", [(3, 3, 16, 24), (7, 7, 3, 8)])
def test_quantize_weights_matches_jax(shape):
    """int8 codes equal, scales equal (both are one fp32 division of the
    same max); an all-zero output channel takes the 1e-12 floor."""
    w = np.random.default_rng(0).normal(0, 0.05, shape).astype(np.float32)
    w[..., 1] = 0.0
    wq, ws = jin.quantize_weights_int8(jnp.asarray(w), reduce_axes=(0, 1, 2))
    got_q, got_s = q.quantize_weights_int8(T(w))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ws))


def _packed_up2_codes(sub_q, cin, cout):
    """The port's sub-pixel int8 up2 weights (2, 2, Cin, 4 Cout) placed in
    up2_packed_kernel's (3, 3, 4 Cin, 16 Cout) layout: output phase (t, s)
    of the 4x grid takes phase (t % 2, s % 2), and tap (a, b) lands on the
    packed row fr = t // 2 + t % 2 + a - 1 (columns alike)."""
    out = np.zeros((3, 3, 4 * cin, 16 * cout), np.int8)
    for t in range(4):
        for s in range(4):
            p, qq = t % 2, s % 2
            for a in range(2):
                for b in range(2):
                    fr, fc = t // 2 + p + a - 1, s // 2 + qq + b - 1
                    ci = (fr % 2 * 2 + fc % 2) * cin
                    out[fr // 2 + 1, fc // 2 + 1, ci:ci + cin,
                        (t * 4 + s) * cout:(t * 4 + s + 1) * cout] = \
                        sub_q[a, b, :, (2 * p + qq) * cout:
                              (2 * p + qq + 1) * cout]
    return out


def _jax_quantized(params, r):
    """JAX's int8 weights of every quantized conv, from the fp32 params."""
    qz = lambda w: tuple(map(np.asarray, jin.quantize_weights_int8(
        jnp.asarray(w), reduce_axes=(0, 1, 2))))
    out = {n: qz(params[n]["kernel"]) for n in ("stem", "down1", "down2",
                                                 "head")}
    out["up2"] = qz(up2_packed_kernel(jnp.asarray(params["up2"]["kernel"],
                                                  jnp.float32)))
    cq = [qz(params[f"block{i}"]["conv2"]["kernel"]) for i in range(r)]
    out["conv2"] = tuple(np.stack(t) for t in zip(*cq))
    return out


def test_engine_quantizes_fp32_master_weights():
    """The bf16 engine's build-time int8 weights equal JAX's quantization of
    the fp32 params exactly: every conv of quant="full", the up2 kernel as
    its sub-pixel phases in the packed layout, scales to the bit. (Weights
    quantized after the cast to bf16 would differ by one code.)"""
    sd = init_generator_state_dict(3, 1, BASE, 3)
    params = generator_params_from_torch(sd, 3)
    eng = DualGeneratorEngine(sd, sd, img_size=SIZE, device="cpu",
                              compute_dtype=torch.bfloat16, quant="full")
    gen = eng.st_generator
    assert gen.model[1].weight.dtype == torch.bfloat16
    want = _jax_quantized(params, 3)
    for name in ("stem", "down1", "down2", "head", "conv2"):
        wq, ws = gen.qweights[name]
        assert wq.dtype == torch.int8 and ws.dtype == torch.float32, name
        np.testing.assert_array_equal(wq.numpy(), want[name][0], name)
        np.testing.assert_array_equal(ws.numpy(), want[name][1], name)
    sub_q, sub_s = (t.numpy() for t in gen.qweights["up2"])
    cin, cout = sub_q.shape[2], sub_q.shape[3] // 4
    np.testing.assert_array_equal(_packed_up2_codes(sub_q, cin, cout),
                                  want["up2"][0])
    phase = [2 * (t % 2) + s % 2 for t in range(4) for s in range(4)]
    np.testing.assert_array_equal(
        np.concatenate([sub_s[p * cout:(p + 1) * cout] for p in phase]),
        want["up2"][1])


@pytest.mark.parametrize("zero_point,stride", [(0, 1), (128, 1), (128, 2)])
def test_conv_int8_static_matches_jax(zero_point, stride):
    """Exactly equal: the same exact int32 accumulator (``torch._int_mm``
    here, XLA's int8 conv in JAX), then the same fp32 epilogue. The input is padded as the callers
    pad it: -128 on the shifted grid, 0 on the symmetric grid."""
    rng = np.random.default_rng(zero_point + stride)
    lo = -128 if zero_point else -127
    x8 = rng.integers(lo, 128, (2, 9, 9, 16)).astype(np.int8)
    x8 = np.pad(x8, ((0, 0), (1, 1), (1, 1), (0, 0)),
                constant_values=-zero_point)
    w = rng.normal(0, 0.1, (3, 3, 16, 24)).astype(np.float32)
    b = rng.normal(0, 0.1, (24,)).astype(np.float32)
    ref = _conv_int8_static(jnp.asarray(x8), jnp.asarray(w), jnp.asarray(b),
                            S, stride=stride, dtype=jnp.float32,
                            zero_point=zero_point)
    got = q.conv_int8_static(T(x8), *q.quantize_weights_int8(T(w)), T(b), S,
                             stride=stride, dtype=torch.float32,
                             zero_point=zero_point)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_upsample_conv_int8_matches_packed_up2():
    """The port's four sub-pixel phase convs on the true grid vs fused.py's
    packed up2 (up2_packed_kernel on the packed-4 input, d2s of the
    packed-16 output): exactly equal."""
    rng = np.random.default_rng(7)
    x8 = rng.integers(-128, 128, (2, 8, 8, 16)).astype(np.int8)
    w = rng.normal(0, 0.1, (3, 3, 16, 8)).astype(np.float32)
    h8 = jnp.pad(_s2d2(jnp.asarray(x8)), ((0, 0), (1, 1), (1, 1), (0, 0)),
                 constant_values=-128)
    ref = _d2s(_conv_int8_static(h8, up2_packed_kernel(jnp.asarray(w)), None,
                                 S, dtype=jnp.float32, zero_point=128), 4)
    wq, ws = q.quantize_weights_int8(q.subpixel_weights(T(w)))
    got = q.upsample_conv_int8(T(x8), wq, ws, S, dtype=torch.float32)
    assert got.shape == (2, 16, 16, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("pad,phases", [(0, 1), (1, 1), (1, 4)])
def test_instance_norm_int8_plain_matches_pallas(pad, phases):
    """K2's int8 write, plain version vs instance_norm_pallas(int8_scale,
    interpret): codes agree on >= 99.9%, at most one apart (the TPU kernel
    takes one-pass statistics). With phases=4 the float output of the
    phase-pooled norm is also held at atol 1e-5."""
    x = np.random.default_rng(pad + phases).normal(0.5, 2.0, (2, 16, 16, 64)) \
        .astype(np.float32)
    ref = jin.instance_norm_pallas(jnp.asarray(x), relu=True, pad=pad,
                                   phases=phases, int8_scale=S,
                                   interpret=True)
    got = k2.instance_norm_int8_plain(T(x), pad=pad, phases=phases)
    assert got.dtype == torch.int8 and got.shape == ref.shape
    _codes_agree(got.numpy(), ref)
    if phases > 1:
        ref = jin.instance_norm_pallas(jnp.asarray(x), relu=True, pad=pad,
                                       phases=phases, interpret=True)
        got = k2.instance_norm_plain(T(x), relu=True, pad=pad, phases=phases)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)


def test_instance_norm_int8_matches_jax_fallback():
    """The wrapper on a CPU tensor is the JAX CPU path
    (``instance_norm_int8``'s XLA fallback): codes agree as above."""
    x = np.random.default_rng(5).normal(0.0, 1.0, (2, 12, 12, 64)) \
        .astype(np.float32)
    ref = jin.instance_norm_int8(jnp.asarray(x), pad=1, scale=S)
    _codes_agree(k2.instance_norm_int8(T(x), pad=1).numpy(), ref)


def _chain_inputs(k, n=2, hw=14, c=32, seed=0):
    rng = np.random.default_rng(seed)
    r = c // 16
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    return (f(n, hw, hw, c), f(k, 3, 3, c, c, std=0.1),
            f(k, 3, 3, c, c, std=0.1), f(k, c, r, std=0.3),
            f(k, r, c, std=0.3), f(k, 7, 7, 2, 1, std=0.3))


def _quantize_stack(wbs):
    wq, ws = zip(*(q.quantize_weights_int8(T(w)) for w in wbs))
    return torch.stack(wq), torch.stack(ws)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("pad", [0, 1])
def test_residual_chain_quant_plain_matches_pallas(k, pad):
    """K1q: the plain version vs residual_chain_pallas(quant=True,
    interpret) on a (2, 14, 14, 32) carry, atol 2e-4, as K1's test: the
    plain version dequantizes conv2 and normalizes the result, the TPU
    kernel normalizes the int32 accumulator (IN absorbs the affine map up
    to rounding)."""
    xp, was, wbs, w1s, w2s, wsas = _chain_inputs(k)
    ref = residual_chain_pallas(*map(jnp.asarray, (xp, was, wbs, w1s, w2s,
                                                   wsas)),
                                pad=pad, quant=True, interpret=True)
    wq, ws = _quantize_stack(wbs)
    got = k1.residual_chain_plain(T(xp), T(was), wq, T(w1s), T(w2s), T(wsas),
                                  pad=pad, quant=True, wb_scales=ws)
    assert got.shape == ref.shape == (2, 12 + 2 * pad, 12 + 2 * pad, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=0)


def test_quant_intermediate_matches_k1q_write():
    """K1q's int8 intermediate (plain) vs the TPU kernel's write math on the
    same conv1 accumulator (conv_in.py:379-389): codes agree as above."""
    xp, was, *_ = _chain_inputs(1, seed=3)
    acc = jax.lax.conv_general_dilated(
        jnp.asarray(xp), jnp.asarray(was[0]), (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    mean = jnp.mean(acc, axis=(1, 2), keepdims=True)
    var = jnp.mean(jnp.square(acc - mean), axis=(1, 2), keepdims=True)
    y = jnp.maximum((acc - mean) * jax.lax.rsqrt(var + 1e-5), 0.0)
    qq = jnp.minimum(y * jnp.float32(255.0 / S) + 0.5, 255.0)
    ref = jin.reflect_pad_hw((qq.astype(jnp.int32) - 128).astype(jnp.int8),
                             1, h_axis=1)
    _codes_agree(k1.quant_intermediate_plain(T(xp), T(was[0])).numpy(), ref)


@pytest.mark.parametrize("quant", ["trunk", "full"])
@pytest.mark.parametrize("trunk,blocks,jax_trunk", [
    ("chain", 3, "chain3"), ("chain", 4, "chain3"), ("tail", 3, "pallas"),
    ("plain", 3, "pallas")])
def test_generator_quant_matches_jax_packed(quant, trunk, blocks, jax_trunk):
    """The port's quantized forward (true layout) vs generator_apply_packed
    (quant, fp32) on the same params with non-zero biases: rtol 1e-4, atol
    1e-5. The chain trunk (K1q's plain version) is held against the JAX
    chain3 trunk, which drops the trunk conv biases; the tail and plain
    trunks keep them, as the JAX trunk="pallas" does."""
    rng = np.random.default_rng(blocks)
    sd = init_generator_state_dict(blocks, 1, BASE, blocks)
    for key in sd:
        if key.endswith(".bias"):
            sd[key] = rng.normal(0, 0.1, sd[key].shape).astype(np.float32)
    params = generator_params_from_torch(sd, blocks)
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 1)).astype(np.float32)
    ref = generator_apply_packed(params, jnp.asarray(x),
                                 num_residual_blocks=blocks,
                                 dtype=jnp.float32, trunk=jax_trunk,
                                 quant=quant)
    gen = Generator.from_state_dict(sd, trunk=trunk, quant=quant).eval()
    with torch.inference_mode():
        got = gen(T(x))
    assert got.shape == (2, SIZE, SIZE, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_generator_quant_refuses_training():
    gen = Generator.from_state_dict(init_generator_state_dict(0, 1, BASE, 1),
                                    trunk="plain", quant="trunk")
    with pytest.raises(RuntimeError, match="no backward"):
        gen(torch.zeros((1, 16, 16, 1)))


@functools.lru_cache(maxsize=None)
def _jax_params(seed, blocks=3):
    p = jax.jit(JaxGenerator(1, blocks, BASE).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 1)))
    return jax.tree_util.tree_map(np.asarray, p["params"])


def _volume(z=6):
    hu = np.stack([chest_hu(SIZE, SIZE, z=i) for i in range(z)])
    return (hu + 1024.0).astype(np.int16)


@pytest.mark.parametrize("quant", ["trunk", "full"])
def test_run_patient_quant_matches_jax_engine(quant):
    """run_patient at quant vs the JAX engine's forward="packed",
    trunk="chain3" at the same quant, fp32, 6 slices, chunk 4: |d| <= 1
    stored unit on >= 99.9% of voxels, the bound the engine test uses."""
    params = [_jax_params(0), _jax_params(1)]
    jeng = JaxEngine(*params, img_size=SIZE, compute_dtype=jnp.float32,
                     forward="packed", trunk="chain3", quant=quant)
    ref = jeng.run_patient(_volume(), 1.0, -1024.0, chunk=4)
    eng = DualGeneratorEngine(
        *(generator_state_dict_from_jax(p) for p in params), img_size=SIZE,
        compute_dtype=torch.float32, device="cpu", quant=quant)
    assert eng.quant_calibration == jeng.quant_calibration
    got = eng.run_patient(_volume(), 1.0, -1024.0, chunk=4)
    assert got.dtype == np.int16 and got.shape == ref.shape
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert float(np.mean(d <= 1)) >= 0.999


def test_quant_wrappers_run_plain_on_cpu_without_counting():
    xp, was, wbs, w1s, w2s, wsas = map(T, _chain_inputs(1))
    wq, ws = _quantize_stack(wbs.numpy())
    counters = (k1.residual_chain, k2.instance_norm_int8, k2.instance_norm,
                tap_probe.tap_matmul)
    before = [f.launches for f in counters]
    kw = dict(pad=1, quant=True, wb_scales=ws)
    torch.testing.assert_close(
        k1.residual_chain(xp, was, wq, w1s, w2s, wsas, **kw),
        k1.residual_chain_plain(xp, was, wq, w1s, w2s, wsas, **kw),
        rtol=0, atol=0)
    torch.testing.assert_close(k2.instance_norm_int8(xp, pad=1),
                               k2.instance_norm_int8_plain(xp, pad=1),
                               rtol=0, atol=0)
    torch.testing.assert_close(k2.instance_norm(xp, relu=True, phases=4),
                               k2.instance_norm_plain(xp, relu=True,
                                                      phases=4),
                               rtol=0, atol=0)
    a = torch.randint(-127, 128, (16, 64), dtype=torch.int8)
    b = torch.randint(-127, 128, (64, 8), dtype=torch.int8)
    torch.testing.assert_close(tap_probe.tap_matmul(a, b, 9),
                               tap_probe.tap_matmul_plain(a, b, 9),
                               rtol=0, atol=0)
    assert [f.launches for f in counters] == before


def test_quant_wrappers_refuse_other_devices():
    """No fallback: a tensor on neither the CPU nor a card is refused
    before any build or launch."""
    m = lambda *s, dtype=torch.float32: torch.empty(s, device="meta",
                                                    dtype=dtype)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k2.instance_norm_int8(m(1, 8, 8, 64), pad=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k2.instance_norm(m(1, 8, 8, 64), relu=True, phases=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k1.residual_chain(m(1, 10, 10, 64), m(1, 3, 3, 64, 64),
                          m(1, 3, 3, 64, 64, dtype=torch.int8), m(1, 64, 4),
                          m(1, 4, 64), m(1, 7, 7, 2, 1), quant=True,
                          wb_scales=m(1, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tap_probe.tap_matmul(m(128, 64, dtype=torch.int8),
                             m(64, 64, dtype=torch.int8), 9)


def test_tap_matmul_plain_is_exact():
    """P3's plain version: the exact integer product x taps (int64 numpy),
    and the fp32 product x taps for bf16."""
    rng = np.random.default_rng(11)
    a = rng.integers(-127, 128, (128, 256)).astype(np.int8)
    b = rng.integers(-127, 128, (256, 64)).astype(np.int8)
    got = tap_probe.tap_matmul_plain(T(a), T(b), 36)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), (a.astype(np.int64) @ b.astype(np.int64)) * 36)
    af, bf = (torch.randn(s, dtype=torch.bfloat16) for s in ((128, 64),
                                                            (64, 64)))
    torch.testing.assert_close(tap_probe.tap_matmul_plain(af, bf, 9),
                               (af.float() @ bf.float()) * 9)
