"""The reference (plain float32 PyTorch, nothing of the port) agrees with
the port's plain CPU modules at tiny widths: generator, discriminator, the
loss terms, a served series and a training step."""
import copy

import numpy as np
import pytest
import torch

from portbench.harness import inputs
from portbench.harness import serve_closed_loop as serve
from portbench.harness import train_pool as train
from portbench.reference import losses as ref_losses
from portbench.reference.nets import discriminator, generator

SEED = 2 ** 35 + 9
nhwc = lambda t: t.permute(0, 2, 3, 1)
nchw = lambda t: t.permute(0, 3, 1, 2)


def _gen_cfg(base=8, blocks=2):
    return {"base_channels": base, "num_residual_blocks": blocks,
            "cbam": True, "cbam_reduction": 16, "cbam_spatial_kernel": 7,
            "init_std": 0.02}


@pytest.mark.parametrize("in_ch", [1, 3])
def test_generator_matches_the_port(in_ch):
    from ducosy_tpu_torch.models.generator import Generator

    w = inputs.generator_weights(_gen_cfg(), in_ch, SEED, "cpu")
    port = Generator.from_state_dict(w, trunk="plain")
    x = torch.rand(2, 32, 32, in_ch, generator=torch.Generator()
                   .manual_seed(1)) * 2 - 1
    with torch.no_grad():
        got = nhwc(generator(w, nchw(x)))
        want = port(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_discriminator_matches_the_port():
    from ducosy_tpu_torch.models.discriminator import Discriminator

    w = inputs.discriminator_weights({"base_channels": 8, "init_std": 0.02},
                                     SEED, "cpu")
    port = Discriminator(1, 8)
    port.load_state_dict(w)
    x = torch.rand(2, 64, 64, 1, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        torch.testing.assert_close(nhwc(discriminator(w, nchw(x))), port(x),
                                   rtol=1e-5, atol=1e-5)


def test_loss_terms_match_the_port():
    from ducosy_tpu_torch.config import TrainConfig
    from ducosy_tpu_torch.losses.suite import discriminator_loss, \
        generator_loss

    g = torch.Generator().manual_seed(3)
    imgs = [torch.rand(2, 32, 32, 1, generator=g) * 2 - 1 for _ in range(8)]
    logits = [torch.randn(2, 2, 2, 1, generator=g) for _ in range(2)]
    names = ("real_a", "real_b", "fake_a", "fake_b", "rec_a", "rec_b",
             "id_a", "id_b")
    port = generator_loss(**dict(zip(names, imgs)), d_a_fake_logits=logits[0],
                          d_b_fake_logits=logits[1], cfg=TrainConfig())
    ref = ref_losses.generator_terms(*(nchw(t) for t in imgs),
                                     *(nchw(t) for t in logits))
    pairs = {"gan": port.gan, "cycle": port.cycle, "identity": port.identity,
             "grad_cycle": port.grad_cycle, "grad_id": port.grad_id,
             "ssim": port.ssim, "attention": port.contrast_attention,
             "region": port.contrast_region, "edge": port.contrast_edge,
             "total": port.total}
    for name, value in pairs.items():
        torch.testing.assert_close(ref[name], value, rtol=2e-5, atol=2e-6,
                                   msg=name)
    torch.testing.assert_close(
        ref_losses.discriminator_loss(nchw(logits[0]), nchw(logits[1])),
        discriminator_loss(logits[0], logits[1]))


def test_a_served_series_matches_the_port(serving):
    config, traffic = serving
    engine = serve.make_engine(config, SEED, "cpu")
    vol = serve.make_volume(config, traffic, SEED, "cpu")
    got = {z: serve.launch(engine, config, traffic, vol, z).numpy()
           for z in traffic["sizes"][:2]}
    worst = serve.compare(got, config, traffic, SEED, "cpu")
    assert worst["mean_abs_hu"] < 1e-2 and worst["worst_slice_hu"] < 1e-1


def test_a_training_step_matches_the_port(training):
    config, traffic = training
    trainer = train.Trainer(config, traffic, SEED, "cpu")
    pool = train.make_pool(config, traffic, SEED, "cpu")
    prog = train.first_steps(trainer, pool, 2)
    ref = train.reference_steps(config, traffic, SEED, "cpu", 2)
    nums = train.train_numbers(prog, ref, config["moved_share"])
    assert nums["loss_gap"] < 1e-5 and nums["grad_gap"] < 1e-4
    assert nums["update_gap"] < 1e-2
    for (pg, pd), (rg, rd) in zip(prog["losses"], ref["losses"]):
        assert pg == pytest.approx(rg, rel=1e-5)
        assert pd == pytest.approx(rd, rel=1e-5)
