"""On the card: the serving and training paths at the published widths on
128^2 slices run the kernels the configurations name, with the path checks
of a run on, and agree with the reference within the limits. Skips
without a card; run on one with ``python -m pytest portbench/tests -m
card``."""
import pytest

from portbench.harness import serve_closed_loop as serve
from portbench.harness import train_pool as train

pytestmark = pytest.mark.card


def test_serving_path_on_the_card(card, serving, make_ctx):
    config, traffic = serving
    config.update(img_size=128, compute_dtype="bfloat16")
    config["generator"].update(base_channels=64, num_residual_blocks=9)
    traffic.update(sizes=[40, 61], chunk=32)
    ctx = make_ctx(config, traffic, seconds=1.0)
    ctx.device, ctx.check_path = card, True
    out = serve.run(ctx)
    assert out.correct, out.checks


def test_training_path_on_the_card(card, training, make_ctx):
    config, traffic = training
    config.update(img_size=128, compute_dtype="bfloat16")
    config["generator"].update(base_channels=64, num_residual_blocks=9)
    config["discriminator"]["base_channels"] = 64
    traffic.update(batch=4, batches=4)
    ctx = make_ctx(config, traffic, seconds=1.0)
    ctx.device, ctx.check_path = card, True
    out = train.run(ctx)
    assert out.attempted > 0 and out.failed == 0
    assert all(v == v for _, v, _ in out.checks)
