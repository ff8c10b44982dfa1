"""What "auto" names on a card and on the CPU, held against the JAX package
(``ducosy_tpu_torch/resolve.py``).

  (a) the serving resolver against the JAX engine's resolution, with
      ``ducosy_tpu.ops.pallas.pallas_available`` patched to answer True
      (``on_card=True``) and False (``on_card=False``), over every
      combination of forward, trunk, quant, img_size, blocks and CBAM: the
      same (forward, trunk, quant), or both raise, apart from the port's
      deliberate differences, which are held to the port's own answer.
      Only the JAX engine's constructor runs (tiny base widths; its
      forward is never called);
  (b) the deliberate differences by name: "tail" and "plain" keep the
      module forward under "auto", as do a named trunk and ``fused_norm``
      in training;
  (c) the training rule of ducosy_tpu/train/loop.py:188-192;
  (d) a CPU engine and a CPU train step built with no forward still run the
      module forward.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ducosy_tpu.infer.engine as jax_engine_module
from ducosy_tpu.infer.engine import DualGeneratorEngine as JaxEngine
from ducosy_tpu.models.fused import generator_apply_packed as jax_packed
from ducosy_tpu.models.torch_import import generator_params_from_torch
from ducosy_tpu_torch.config import SOFT_TISSUE, ModelConfig, TrainConfig, \
    replace
from ducosy_tpu_torch.infer.engine import DualGeneratorEngine
from ducosy_tpu_torch.models.convert import init_generator_state_dict
from ducosy_tpu_torch.resolve import serving_forward, training_forward
from ducosy_tpu_torch.train.state import create_state
from ducosy_tpu_torch.train.step import make_train_step

FORWARDS = ("auto", "module", "packed")
TRUNKS = ("auto", "xla", "pallas", "mega", "mono", "chain", "chain3")
QUANTS = (None, "trunk", "full")
SIZES = (64, 66)
BASE = 4


@pytest.fixture(scope="module")
def jax_params():
    """One JAX parameter tree per (blocks, CBAM): the port's seeded numpy
    init through the JAX package's importer."""
    return {(blocks, cbam): generator_params_from_torch(
        init_generator_state_dict(0, 1, BASE, blocks, cbam), blocks, cbam)
        for blocks in (2, 9) for cbam in (True, False)}


def _jax_resolution(params, forward, trunk, quant, img_size):
    try:
        eng = JaxEngine(params, params, img_size=img_size, forward=forward,
                        trunk=trunk, quant=quant)
    except ValueError:
        return "raise"
    return eng.forward_impl, eng.trunk, eng.quant


def _port_resolution(**kw):
    try:
        return serving_forward(**kw)
    except ValueError:
        return "raise"


def _deliberate(forward, trunk, quant, img_size, cbam, on_card):
    """The port's answer where it differs from the JAX engine on purpose
    (ROADMAP.md), else None: the module forward, named or resolved on the
    CPU, serves the port's module trunks "chain" and "mega" and, for CBAM
    checkpoints, the quant modes; forward="packed" named with img_size % 4
    raises (the JAX engine builds, and its packed forward returns the
    wrong size)."""
    module = forward == "module" or (forward == "auto" and not on_card)
    if module and cbam and (trunk in ("chain", "mega") or
                            (quant and trunk == "auto")):
        return "module", trunk, quant
    if forward == "packed" and img_size % 4:
        return "raise"
    return None


@pytest.mark.parametrize("cbam", [True, False])
@pytest.mark.parametrize("blocks", [2, 9])
@pytest.mark.parametrize("forward", FORWARDS)
@pytest.mark.parametrize("on_card", [True, False])
def test_serving_resolver_follows_the_jax_engine(jax_params, monkeypatch,
                                                 on_card, forward, blocks,
                                                 cbam):
    import ducosy_tpu.ops.pallas as jax_pallas

    monkeypatch.setattr(jax_pallas, "pallas_available", lambda: on_card)
    # the engine's stacked parameters feed only its forward, never run here
    monkeypatch.setattr(jax_engine_module, "_stack_params",
                        lambda a, b: (a, b))
    params = jax_params[(blocks, cbam)]
    deliberate = 0
    for trunk, quant, img_size in itertools.product(TRUNKS, QUANTS, SIZES):
        got = _port_resolution(forward=forward, trunk=trunk, quant=quant,
                               img_size=img_size, blocks=blocks, cbam=cbam,
                               on_card=on_card)
        jax_got = _jax_resolution(params, forward, trunk, quant, img_size)
        want = _deliberate(forward, trunk, quant, img_size, cbam, on_card)
        if want is None:
            want = jax_got
        elif want != jax_got:
            deliberate += 1
        assert got == want, (trunk, quant, img_size)
    # "auto" on a card follows the JAX engine on every case
    assert not (forward == "auto" and on_card and deliberate)


@pytest.mark.parametrize("on_card", [True, False])
def test_serving_defaults(on_card):
    """No forward, no trunk: packed chain3 on a card ("mono" below 3
    blocks), the module forward on the CPU; under quant the card serves
    packed too; fused_norm changes nothing."""
    want = ("packed", "chain3", None) if on_card else ("module", "auto", None)
    assert serving_forward(on_card=on_card) == want
    assert serving_forward(on_card=on_card, fused_norm=True) == want
    if on_card:
        assert serving_forward(blocks=2) == ("packed", "mono", None)
        assert serving_forward(quant="trunk") == ("packed", "chain3",
                                                  "trunk")
        assert serving_forward(trunk_int8=True) == ("packed", "chain3",
                                                    "trunk")
        assert serving_forward(cbam=False) == ("packed", "chain3", None)
        assert serving_forward(img_size=66) == ("module", "auto", None)
    else:
        assert serving_forward(on_card=False, quant="full") == (
            "module", "auto", "full")


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("on_card", [True, False])
def test_serving_resolver_under_sp(on_card, sp):
    """Under an sp axis, card or CPU: packed at trunk "xla" when img_size
    divides by 4; the kernel trunks, quant and fused_norm raise."""
    kw = dict(sp=sp, on_card=on_card)
    assert serving_forward(**kw) == ("packed", "xla", None)
    assert serving_forward("module", **kw) == ("module", "auto", None)
    for bad in (dict(trunk="chain3"), dict(quant="trunk"),
                dict(trunk_int8=True), dict(fused_norm=True),
                dict(img_size=66), dict(img_size=4 * sp - 4)):
        with pytest.raises(ValueError):
            serving_forward(**kw, **bad)


@pytest.mark.parametrize("trunk", ["tail", "plain"])
@pytest.mark.parametrize("on_card", [True, False])
def test_port_trunk_names_keep_the_module_forward(jax_params, on_card,
                                                  trunk):
    """(b) "tail" and "plain", names the JAX package does not have (its
    packed forward refuses them), keep the module forward under "auto";
    so do a named trunk and fused_norm in training."""
    with pytest.raises(ValueError, match="trunk must be"):
        jax_packed(jax_params[(2, True)], jnp.zeros((1, 64, 64, 1)),
                   num_residual_blocks=2, dtype=jnp.float32, trunk=trunk)
    assert serving_forward(trunk=trunk, on_card=on_card) == (
        "module", trunk, None)
    assert serving_forward(trunk=trunk, quant="trunk", on_card=on_card) == (
        "module", trunk, "trunk")
    with pytest.raises(ValueError, match="module trunk"):
        serving_forward("packed", trunk, on_card=on_card)
    assert training_forward("auto", trunk, on_card=on_card) == "module"
    assert training_forward("auto", fused_norm=True,
                            on_card=on_card) == "module"
    assert training_forward("packed", trunk, on_card=on_card) == "packed"


@pytest.mark.parametrize("img_size", [512, 64, 66, 510])
@pytest.mark.parametrize("on_card", [True, False])
def test_training_rule_follows_the_jax_loop(on_card, img_size):
    """(c) ducosy_tpu/train/loop.py:188-192, inline in train_cycle_gan:
    gen_forward "auto" is "packed" if pallas_available() and
    img_size % 4 == 0, else "module"; a named forward is kept."""
    jax_rule = "packed" if on_card and img_size % 4 == 0 else "module"
    assert training_forward(img_size=img_size, on_card=on_card) == jax_rule
    for named in ("module", "packed"):
        assert training_forward(named, img_size=img_size,
                                on_card=on_card) == named
    with pytest.raises(ValueError):
        training_forward("fused", on_card=on_card)


def test_cpu_engine_and_step_run_the_module_forward():
    """(d) On the CPU, an engine and a train step built with no forward
    run the module forward, as before."""
    sd = init_generator_state_dict(1, 1, 8, 2)
    eng = DualGeneratorEngine(sd, sd, device="cpu", img_size=32,
                              compute_dtype=torch.float32)
    assert (eng.forward_impl, eng.trunk, eng.quant) == ("module", "auto",
                                                        None)
    assert type(eng.st_generator).__name__ == "Generator"

    cfg = replace(TrainConfig(), img_size=32, batch_size=2,
                  compute_dtype="float32")
    model = ModelConfig(num_residual_blocks=1, base_channels=8,
                        disc_base_channels=8)
    state = create_state(cfg, SOFT_TISSUE, model, device="cpu")
    step = make_train_step(cfg, remat=False)
    assert step.gen_forward is None
    rng = np.random.default_rng(0)
    img = lambda: torch.from_numpy(
        rng.uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32))
    batch = {"a": img(), "b": img(), "masks": torch.from_numpy(
        (rng.uniform(size=(2, 32, 32, 2)) > 0.5).astype(np.float32))}
    metrics = step(state, batch)
    assert step.gen_forward == "module"
    assert all(np.isfinite(float(v)) for v in metrics.values())
