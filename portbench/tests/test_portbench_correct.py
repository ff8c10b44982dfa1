"""``correct`` comes out true for a sound run and false for the control and
for every fault a cell can have, each planted underneath the timed path,
at sizes a test run holds; the rest of the run (its look for a card
aside) is the run's own. The limits are the configurations' own."""
import pytest
import torch

from portbench.harness import serve_closed_loop as serve
from portbench.harness import train_pool as train


def test_a_sound_serving_run_is_correct(serving, make_ctx):
    out = serve.run(make_ctx(*serving))
    assert out.attempted > 0 and out.failed == 0
    assert out.correct, out.checks


def test_a_sound_training_run_is_correct(training, make_ctx):
    out = train.run(make_ctx(*training))
    assert out.attempted > 0 and out.failed == 0
    assert out.correct, out.checks


def _engine_class():
    from ducosy_tpu_torch.infer.engine import DualGeneratorEngine

    return DualGeneratorEngine


def test_an_answer_altered_where_produced_is_not_correct(
        serving, make_ctx, monkeypatch):
    cls = _engine_class()
    inner = cls.run_patient_async

    def altered(self, stored, *a, **k):
        out = inner(self, stored, *a, **k).clone()
        out[len(out) // 2] = 0
        return out

    monkeypatch.setattr(cls, "run_patient_async", altered)
    out = serve.run(make_ctx(*serving))
    assert not out.correct


def test_half_of_each_chunk_left_out_is_not_correct(
        serving, make_ctx, monkeypatch):
    cls = _engine_class()
    inner = cls._forward_parts

    def half(self, sl, *args):
        got = inner(self, sl[:len(sl) // 2], *args)
        return {k: torch.cat([v, v])[:len(sl)] for k, v in got.items()}

    monkeypatch.setattr(cls, "_forward_parts", half)
    out = serve.run(make_ctx(*serving))
    assert not out.correct


def test_the_serving_control_is_not_correct(serving, make_ctx,
                                            monkeypatch):
    """The program with its int8 path on (the configuration's control) at
    the published widths on 128^2 slices."""
    config, traffic = serving
    config["img_size"] = 128
    config["generator"].update(base_channels=64, num_residual_blocks=9)
    traffic.update(sizes=[5, 7], chunk=4)
    build = serve.make_engine
    monkeypatch.setattr(serve, "make_engine", lambda c, s, d, quant=None:
                        build(c, s, d, quant=config["control"]["quant"]))
    out = serve.run(make_ctx(config, traffic, seconds=0.1))
    assert not out.correct, out.checks


def test_a_state_left_unchanged_is_not_correct(training, make_ctx,
                                               monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    out = train.run(make_ctx(*training))
    assert not out.correct
    assert dict((k, v) for k, v, _ in out.checks)["update_gap"] == \
        pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_not_correct(training, make_ctx,
                                                   monkeypatch):
    inner = train.Trainer.__call__

    def half(self, batch):
        n = len(batch["a"]) // 2
        return inner(self, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(train.Trainer, "__call__", half)
    out = train.run(make_ctx(*training))
    assert not out.correct, out.checks


def test_the_training_control_is_not_correct(training, make_ctx,
                                             monkeypatch):
    """The reference with float8 convs (the configuration's control) in
    the program's place for the checked steps, at the published depth on
    64^2 slices."""
    from portbench.reference.cyclegan import fp8_conv

    config, traffic = training
    config["generator"].update(base_channels=32, num_residual_blocks=9)
    config["discriminator"]["base_channels"] = 32
    config["img_size"] = 64
    ctx = make_ctx(config, traffic, seconds=0.1)

    def control(trainer, pool, n, *a, **k):
        return train.reference_steps(config, traffic, ctx.seed, "cpu", n,
                                     conv=fp8_conv)

    monkeypatch.setattr(train, "first_steps", control)
    out = train.run(ctx)
    assert not out.correct, out.checks
