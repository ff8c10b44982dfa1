"""The packed training step's weight layout, once a generator a step
(``train/step.py``, ``models/fused.py``), on the CPU: 32^2, base 8, 2
blocks, SOFT_TISSUE's 3-channel CBAM generators.

Held:
  - the step's generator gradients equal those of three
    ``generator_apply_packed(module, ...)`` calls a generator (a layout a
    forward) feeding the same loss, relative L2 <= 1e-5 a leaf, with and
    without remat, in fp32 and bf16 compute (the layout is fp32 either way,
    so only the order of its fp32 sums differs); in fp32 the biases of
    convs that feed an InstanceNorm, whose gradient is rounding noise
    about 0, within the noise bound (tests/test_torch_train.py's);
  - a fp32 layout cast by the forward gives the bf16 layout's output bit
    for bit;
  - the transforms' index tables are uploaded once a device (5), and a
    step lays out twice;
  - on a card (marker ``card``): a layout after the first one on a device
    runs under ``torch.cuda.set_sync_debug_mode("error")``.
"""
import numpy as np
import pytest
import torch

from ducosy_tpu_torch import trace
from ducosy_tpu_torch.config import SOFT_TISSUE, ModelConfig, \
    TrainConfig, replace
from ducosy_tpu_torch.losses.suite import generator_loss
from ducosy_tpu_torch.models import fused
from ducosy_tpu_torch.models.convert import init_generator_state_dict
from ducosy_tpu_torch.models.generator import Generator
from ducosy_tpu_torch.train.state import create_state
from ducosy_tpu_torch.train.step import forward_all, make_train_step

SIZE = 32
MODEL = ModelConfig(num_residual_blocks=2, base_channels=8,
                    disc_base_channels=8)
TABLES = 5      # stem, down1, up1, up2, head
NOISE_BOUND = 1e-5   # |grad| of a bias that feeds an InstanceNorm


def _cfg(dtype):
    return replace(TrainConfig(), img_size=SIZE, batch_size=2,
                   compute_dtype=dtype)


def _batch():
    g = torch.Generator().manual_seed(0)
    img = lambda c: torch.rand(2, SIZE, SIZE, c, generator=g) * 2 - 1
    return {"a": img(1), "b": img(1), "masks": (img(2) > 0).float()}


def _reference_grads(cfg, batch):
    """The generator loss's gradients with each forward laying its
    generator out anew."""
    state = create_state(cfg, SOFT_TISSUE, MODEL, device="cpu")
    apply = lambda g, x: fused.generator_apply_packed(g, x,
                                                      encoder_fused=False)
    fake_a, fake_b, id_a, id_b, rec_a, rec_b = forward_all(
        apply, state.g_a2b, state.g_b2a, batch)
    terms = generator_loss(
        real_a=batch["a"], real_b=batch["b"], fake_a=fake_a, fake_b=fake_b,
        rec_a=rec_a, rec_b=rec_b, id_a=id_a, id_b=id_b,
        d_a_fake_logits=state.d_a(fake_a), d_b_fake_logits=state.d_b(fake_b),
        cfg=cfg)
    params = list(state.opt_g.param_groups[0]["params"])
    return params, torch.autograd.grad(terms.total, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", [False, True])
def test_layout_once_gives_the_same_gradients(remat, dtype):
    cfg, batch = _cfg(dtype), _batch()
    state = create_state(cfg, SOFT_TISSUE, MODEL, device="cpu")
    params = list(state.opt_g.param_groups[0]["params"])
    names = [n for g in (state.g_a2b, state.g_b2a)
             for n, _ in g.named_parameters()]
    head = f"model.{19 + MODEL.num_residual_blocks}."
    before = [p.detach().clone() for p in params]
    make_train_step(cfg, remat=remat, gen_forward="packed")(state, batch)
    ref_params, ref = _reference_grads(cfg, batch)
    for p0, q in zip(before, ref_params):
        assert torch.equal(p0, q.detach())        # the same init
    for name, p, r in zip(names, params, ref):
        assert p.grad.dtype == torch.float32
        if dtype == "float32" and name.endswith(".bias") and \
                not name.startswith(head):
            assert r.abs().max() < NOISE_BOUND, name
            assert p.grad.abs().max() < NOISE_BOUND, name
            continue
        rel = (torch.linalg.vector_norm(p.grad - r)
               / torch.linalg.vector_norm(r).clamp_min(1e-30)).item()
        assert rel <= 1e-5, (name, rel)


def test_fp32_layout_cast_in_the_forward_is_the_bf16_layout():
    gen = Generator.from_state_dict(
        init_generator_state_dict(3, 3, base=8, blocks=2), trunk="plain")
    x = torch.rand(2, SIZE, SIZE, 3, generator=torch.Generator()
                   .manual_seed(1)) * 2 - 1
    with torch.no_grad():
        pw32 = fused.packed_weights(gen, dtype=torch.float32)
        want = fused.generator_apply_packed(
            fused.packed_weights(gen, dtype=torch.bfloat16), x)
        got = fused.generator_apply_packed(pw32, x, dtype=torch.bfloat16)
    assert fused.cast_packed(pw32, torch.float32) is pw32
    assert torch.equal(got, want)


def test_tables_upload_once_a_device_and_a_step_lays_out_twice(
        monkeypatch):
    monkeypatch.setattr(fused, "_indices", {})
    trace.reset()
    gen = Generator.from_state_dict(
        init_generator_state_dict(3, 3, base=8, blocks=2), trunk="plain")
    fused.packed_weights(gen, dtype=torch.float32)
    assert trace.counters()["fused.table_uploads"] == TABLES
    fused.generator_apply_packed(gen, torch.zeros(1, SIZE, SIZE, 3))
    cfg = _cfg("float32")
    state = create_state(cfg, SOFT_TISSUE, MODEL, device="cpu")
    before = trace.counters()["fused.pack_weights"]
    make_train_step(cfg, remat=False, gen_forward="packed")(state, _batch())
    got = trace.counters()
    assert got["fused.pack_weights"] - before == 2
    assert got["fused.table_uploads"] == TABLES
    trace.reset()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_a_layout_on_the_card_does_not_wait_on_the_stream(card):
    """After one warm-up layout (the tables' uploads), a differentiable
    layout of a card generator neither synchronizes nor copies from the
    host."""
    gen = Generator.from_state_dict(
        init_generator_state_dict(3, 3, base=8, blocks=2),
        trunk="plain").to(card)
    fused.lay_out(gen, dtype=torch.float32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pw = fused.lay_out(gen, dtype=torch.float32)
        fused.cast_packed(pw, torch.bfloat16)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(w.device == card and w.requires_grad
               for w in pw.convs.values())
    np.testing.assert_array_equal(
        pw.convs["hd"].detach().cpu().numpy(),
        fused.packed_weights({k: v.detach().cpu() for k, v in
                              gen.state_dict().items()},
                             dtype=torch.float32).convs["hd"].numpy())
