"""K7 (conv3x3_in), K8 (conv_block_tail), their prototypes P1/P2 and the
generator's trunk="mega" in the port against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through the Pallas kernels in
interpret mode (as tests/test_conv_in.py runs them) and through the port's
wrappers, which run their plain versions for CPU tensors. Shapes are small
(C = 64, 14^2-16^2 pixels, 2-3 blocks). Tolerances are stated per test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.models.fused import generator_apply_packed
from ducosy_tpu.models.torch_import import generator_params_from_torch
from ducosy_tpu.ops.pallas.conv_in import (
    conv3x3_in_pallas,
    conv_block_tail_pallas,
)
from ducosy_tpu.ops.pallas.instance_norm import quantize_weights_int8 as jq
from ducosy_tpu_torch.models.convert import init_generator_state_dict
from ducosy_tpu_torch.models.generator import TRUNKS, Generator
from ducosy_tpu_torch.ops import quant as q
from ducosy_tpu_torch.ops.kernels import conv_in as k7
from ducosy_tpu_torch.ops.kernels import proto_conv_in as proto
from ducosy_tpu_torch.ops.kernels import residual_chain as k1

T = torch.from_numpy
N, HW, C = 2, 14, 64
S = q.INT8_NORM_SCALE
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    r = C // 16
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    return dict(xp=f(N, HW + 2, HW + 2, C), tp=f(N, HW + 2, HW + 2, C),
                w=f(3, 3, C, C, std=0.05), w1=f(C, r, std=0.1),
                w2=f(r, C, std=0.1), wsa=f(7, 7, 2, 1, std=0.1))


def _np(t):
    return t.to(torch.float32).numpy()


def _jnp(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _codes_agree(got, ref, share=0.999):
    """int8 codes equal on >= ``share`` of elements, never more than one
    step apart (fp32 statistics one ulp apart can move a value across a
    rounding boundary of the grid)."""
    d = np.abs(np.asarray(got).astype(np.int32)
               - np.asarray(ref).astype(np.int32))
    assert d.max() <= 1, d.max()
    assert float(np.mean(d == 0)) >= share, float(np.mean(d == 0))


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norelu"])
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3x3_in_matches_pallas(dtype, pad, relu):
    """K7 vs conv3x3_in_pallas (interpret). fp32: atol 1e-4 (summation
    order). bf16: the plain version rounds the conv output to bf16 before
    its norm, the TPU kernel normalizes the fp32 accumulator and rounds
    once: one bf16 ulp of the output, atol 2e-2 + rtol 2^-7."""
    d = _inputs()
    ref = conv3x3_in_pallas(jnp.asarray(d["xp"], JDT[dtype]),
                            jnp.asarray(d["w"]), relu=relu, pad=pad,
                            interpret=True)
    got = k7.conv3x3_in(T(d["xp"]).to(TDT[dtype]), T(d["w"]), relu=relu,
                        pad=pad)
    assert got.shape == ref.shape == (N, HW + 2 * pad, HW + 2 * pad, C)
    assert got.dtype == TDT[dtype]
    tol = dict(atol=1e-4, rtol=0) if dtype == "float32" else \
        dict(atol=2e-2, rtol=2.0 ** -7)
    np.testing.assert_allclose(_np(got), _jnp(ref), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pad", [0, 1])
def test_conv3x3_in_int8_write_matches_pallas(pad, dtype):
    """K7's int8 write at scale 12 vs the TPU kernel's: both quantize the
    fp32 normalized value before the pad; codes equal on >= 99.9%, never
    more than one step apart, and the pad copies codes."""
    d = _inputs(1)
    ref = conv3x3_in_pallas(jnp.asarray(d["xp"], JDT[dtype]),
                            jnp.asarray(d["w"]), pad=pad, int8_scale=S,
                            interpret=True)
    got = k7.conv3x3_in(T(d["xp"]).to(TDT[dtype]), T(d["w"]), pad=pad,
                        int8_scale=S)
    assert got.dtype == torch.int8 and got.shape == ref.shape
    _codes_agree(got.numpy(), ref)
    if pad:
        np.testing.assert_array_equal(got[:, 0].numpy(), got[:, 2].numpy())


@pytest.mark.parametrize("int8_scale", [S, None], ids=["int8-write", "cast"])
def test_conv3x3_in_int8_input_matches_pallas(int8_scale):
    """K7 on an int8 input with int8 weights (exact int32 taps on both
    sides): the int8 write's codes agree as above; without a scale both
    cast the normalized value to int8 (equal on >= 99.9%, one step where a
    value sits on an integer)."""
    d = _inputs(2)
    x8 = q.quantize_shifted(torch.relu(T(d["xp"])), S)
    wq, _ = q.quantize_weights_int8(T(d["w"]))
    ref = conv3x3_in_pallas(jnp.asarray(x8.numpy()), jnp.asarray(wq.numpy()),
                            pad=1, int8_scale=int8_scale, interpret=True)
    got = k7.conv3x3_in(x8, wq, pad=1, int8_scale=int8_scale)
    assert got.dtype == torch.int8
    _codes_agree(got.numpy(), ref)
    with pytest.raises(TypeError, match="int8 weights"):
        k7.conv3x3_in(x8, T(d["w"]))
    with pytest.raises(ValueError, match="relu"):
        k7.conv3x3_in(T(d["xp"]), T(d["w"]), relu=False, int8_scale=S)


@pytest.mark.parametrize("x_pad", [0, 1])
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_block_tail_matches_pallas(dtype, pad, x_pad):
    """K8 vs conv_block_tail_pallas (interpret). fp32 atol 1e-4; bf16 as
    K7's bound through the gates and the skip (two roundings more): atol
    4e-2 + rtol 2^-6, and mean |d| <= 2e-3."""
    d = _inputs(3)
    x = d["xp"] if x_pad else d["xp"][:, 1:-1, 1:-1]
    jd, td = JDT[dtype], TDT[dtype]
    ref = conv_block_tail_pallas(
        jnp.asarray(d["tp"], jd), jnp.asarray(x, jd), jnp.asarray(d["w"]),
        jnp.asarray(d["w1"]), jnp.asarray(d["w2"]), jnp.asarray(d["wsa"]),
        pad=pad, x_pad=x_pad, interpret=True)
    got = k7.conv_block_tail(
        T(d["tp"]).to(td), T(np.ascontiguousarray(x)).to(td), T(d["w"]),
        T(d["w1"]), T(d["w2"]), T(d["wsa"]), pad=pad, x_pad=x_pad)
    assert got.shape == ref.shape == (N, HW + 2 * pad, HW + 2 * pad, C)
    assert got.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _jnp(ref), atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(_np(got), _jnp(ref), atol=4e-2,
                                   rtol=2.0 ** -6)
        assert np.abs(_np(got) - _jnp(ref)).mean() <= 2e-3


@pytest.mark.parametrize("pad", [0, 1])
def test_conv_block_tail_in_int8_matches_pallas(pad):
    """K8 with in_int8 vs the TPU kernel, fp32, on K7's int8 write: the
    plain version dequantizes conv2 and normalizes the result, the TPU
    kernel normalizes the int32 accumulator (the IN absorbs the affine map
    up to rounding): atol 1e-2. The port's build-time weight codes are the
    ones the TPU wrapper quantizes in-graph."""
    d = _inputs(4)
    t8 = k7.conv3x3_in(T(d["xp"]), T(d["w"]), pad=1, int8_scale=S)
    wb = _inputs(5)["w"]
    wq, ws = q.quantize_weights_int8(T(wb))
    jwq, _ = jq(jnp.asarray(wb).reshape(9 * C, C))
    np.testing.assert_array_equal(wq.numpy().reshape(9 * C, C),
                                  np.asarray(jwq))
    ref = conv_block_tail_pallas(
        jnp.asarray(t8.numpy()), jnp.asarray(d["xp"]), jnp.asarray(wb),
        jnp.asarray(d["w1"]), jnp.asarray(d["w2"]), jnp.asarray(d["wsa"]),
        pad=pad, x_pad=1, in_int8=True, interpret=True)
    got = k7.conv_block_tail(t8, T(d["xp"]), wq, T(d["w1"]), T(d["w2"]),
                             T(d["wsa"]), pad=pad, x_pad=1, in_int8=True,
                             w_scale=ws)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-2,
                               rtol=0)
    with pytest.raises(ValueError, match="w_scale"):
        k7.conv_block_tail(t8, T(d["xp"]), wq, T(d["w1"]), T(d["w2"]),
                           T(d["wsa"]), in_int8=True)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "quant"])
def test_residual_chain_plain_is_its_two_halves(quant):
    """K1's plain version equals conv3x3_in_plain then conv_block_tail_plain
    per block, bit for bit, with biases."""
    rng = np.random.default_rng(6)
    d = _inputs(6)
    k = 2
    st = lambda key: torch.stack([T(_inputs(7 + j)[key]) for j in range(k)])
    was, wbs, w1s, w2s, wsas = (st(key) for key in ("w", "w", "w1", "w2",
                                                    "wsa"))
    wbs = st("w").flip(0)
    b1s, b2s = (T(rng.normal(0, 0.1, (k, C)).astype(np.float32))
                for _ in range(2))
    kw, scales = {}, [None] * k
    if quant:
        wbs, scales = (torch.stack(t) for t in zip(
            *(q.quantize_weights_int8(w) for w in wbs)))
        kw = dict(quant=True, wb_scales=scales)
    got = k1.residual_chain_plain(T(d["xp"]), was, wbs, w1s, w2s, wsas,
                                  pad=0, b1s=b1s, b2s=b2s, **kw)
    hp = T(d["xp"])
    for j in range(k):
        t = k7.conv3x3_in_plain(hp, was[j], pad=1, bias=b1s[j],
                                int8_scale=S if quant else None)
        hp = k7.conv_block_tail_plain(
            t, hp, wbs[j], w1s[j], w2s[j], wsas[j], pad=0 if j == k - 1 else 1,
            x_pad=1, in_int8=quant, w_scale=scales[j], bias=b2s[j])
    torch.testing.assert_close(got, hp, rtol=0, atol=0)


def _generator_case(blocks, in_ch=1, seed=0, n=2):
    rng = np.random.default_rng(seed + blocks)
    sd = init_generator_state_dict(seed + blocks, in_ch, 16, blocks)
    for key in sd:
        if key.endswith(".bias"):
            sd[key] = rng.normal(0, 0.1, sd[key].shape).astype(np.float32)
    x = rng.uniform(-1, 1, (n, 32, 32, in_ch)).astype(np.float32)
    return sd, x


@pytest.mark.parametrize("quant", [None, "trunk", "full"],
                         ids=["fp32", "trunk", "full"])
@pytest.mark.parametrize("blocks,in_ch", [(2, 1), (3, 1), (3, 3)],
                         ids=["2", "3", "3-stem3ch"])
def test_generator_mega_matches_jax_packed(blocks, in_ch, quant):
    """Generator(trunk="mega") vs generator_apply_packed(trunk="mega") at
    fp32 on the same weights (base 16 -> C = 64, non-zero biases, which both
    drop in the trunk). Without quant: atol 1e-3. Under quant="trunk" and
    "full": the bound the chain trunk is held to in test_torch_quant.py,
    rtol 1e-4 + atol 1e-5, on every sample. The seed is one at which no
    int8 code sits on a rounding boundary that the two frameworks' fp32
    statistics (a last ulp apart) would resolve differently; such a code
    moves its whole 32^2 sample by 1e-3 to 4e-2."""
    sd, x = _generator_case(blocks, in_ch, seed=5)
    params = generator_params_from_torch(sd, blocks)
    ref = np.asarray(generator_apply_packed(
        params, jnp.asarray(x), num_residual_blocks=blocks,
        dtype=jnp.float32, trunk="mega", quant=quant))
    gen = Generator.from_state_dict(sd, trunk="mega", quant=quant).eval()
    with torch.inference_mode():
        got = gen(T(x))
    assert got.shape == (len(x), 32, 32, 1) and got.dtype == torch.float32
    if quant is None:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("quant", [None, "trunk", "full"])
def test_mega_chain_plain_agree(quant):
    """mega == chain on the port side (the same plain functions in the same
    order), and == plain up to the trunk conv biases the InstanceNorms
    cancel: atol 1e-5 at fp32."""
    sd, x = _generator_case(3, seed=1)
    outs = {}
    for trunk in ("mega", "chain", "plain"):
        gen = Generator.from_state_dict(sd, trunk=trunk, quant=quant).eval()
        with torch.inference_mode():
            outs[trunk] = gen(T(x))
    torch.testing.assert_close(outs["mega"], outs["chain"], rtol=0, atol=0)
    torch.testing.assert_close(outs["mega"], outs["plain"], rtol=0,
                               atol=1e-5 if quant is None else 1e-2)


def test_mega_is_serving_only_and_listed():
    assert "mega" in TRUNKS
    gen = Generator.from_state_dict(init_generator_state_dict(0, 1, 16, 1),
                                    trunk="mega")
    with pytest.raises(RuntimeError, match="no backward"):
        gen(torch.zeros((1, 16, 16, 1)))


def test_wrappers_run_plain_on_cpu_without_counting():
    d = {k: T(v) for k, v in _inputs(8).items()}
    counters = (k7.conv3x3_in, k7.conv_block_tail, proto.conv3x3_in,
                proto.conv_block_tail)
    before = [f.launches for f in counters]
    tail = (d["w"], d["w1"], d["w2"], d["wsa"])
    for mod in (k7, proto):
        torch.testing.assert_close(mod.conv3x3_in(d["xp"], d["w"]),
                                   k7.conv3x3_in_plain(d["xp"], d["w"]),
                                   rtol=0, atol=0)
        torch.testing.assert_close(
            mod.conv_block_tail(d["tp"], d["xp"], *tail),
            k7.conv_block_tail_plain(d["tp"], d["xp"], *tail), rtol=0, atol=0)
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("fn", ["conv3x3_in", "conv_block_tail"])
def test_wrappers_refuse_other_devices(fn):
    """No fallback: a tensor on neither the CPU nor a card is refused before
    any build or launch."""
    d = {k: T(v).to("meta") for k, v in _inputs(9).items()}
    with pytest.raises(ValueError, match="CUDA"):
        if fn == "conv3x3_in":
            k7.conv3x3_in(d["xp"], d["w"])
        else:
            k7.conv_block_tail(d["tp"], d["xp"], d["w"], d["w1"], d["w2"],
                               d["wsa"])


def test_proto_parity_on_cpu():
    """The prototype script's parity check (scripts/proto_conv_in.py:205-231)
    through the port's P1/P2 on the CPU: P1 without a bias against the pair
    with a conv bias (the InstanceNorm cancels it), P2 against conv + K4,
    both below 1e-3; the bench needs a card."""
    errs = proto.parity(n=1, hw=16, c=64, device="cpu")
    assert set(errs) == {"conv_in", "conv_tail"}
    assert max(errs.values()) < 1e-3
    with pytest.raises(ValueError, match="CUDA"):
        proto.bench(8, device="cpu")
