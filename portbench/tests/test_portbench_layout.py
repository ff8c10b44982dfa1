"""The reader of the training step's weight layout, ``layout_host_ms.train``
(portbench/metrics/layout_host_ms.train.py), on synthetic records: the
median step's ``step.layout`` span where the step lays out once a
generator, and nothing where it lays out inside each forward."""
import pytest

from portbench import program
from portbench.harness.common import Reading
from ducosy_tpu_torch import trace

T0 = 10 ** 12          # the host clock (ns)


def _reader(spec, monkeypatch, name, recs, counts):
    monkeypatch.setattr(program, "records", lambda: recs)
    monkeypatch.setattr(program, "counters", lambda: counts)
    return spec.reader(name)


def _laid_out_steps(n):
    """Steps that lay out once a generator: ``step.layout`` (40, 41, 42 us)
    holding two ``fused.pack_weights``, then six forwards that hold none."""
    recs = []
    for k in range(n):
        base = T0 + k * 10 ** 9
        root = len(recs)
        recs.append(trace.Record("step", base, base + 900_000, None, k + 1,
                                 1))
        end = base + 40_000 + k * 1000
        recs.append(trace.Record("step.layout", base, end, root, k + 1, 1))
        for a, b in ((base, base + 20_000), (base + 20_000, end)):
            recs.append(trace.Record("fused.pack_weights", a, b, root + 1,
                                     k + 1, 1))
        for j in range(6):
            t = end + j * 100_000
            recs.append(trace.Record("step.gen_forward", t, t + 100_000,
                                     root, k + 1, 1))
    return recs


def _forward_laid_out_steps(n):
    """Steps that lay out inside each of their six forwards, with no
    ``step.layout``."""
    recs = []
    for k in range(n):
        base = T0 + k * 10 ** 9
        root = len(recs)
        recs.append(trace.Record("step", base, base + 900_000, None, k + 1,
                                 1))
        for j in range(6):
            t = base + j * 100_000
            fwd = len(recs)
            recs.append(trace.Record("step.gen_forward", t, t + 100_000,
                                     root, k + 1, 1))
            recs.append(trace.Record("fused.pack_weights", t, t + 30_000,
                                     fwd, k + 1, 1))
    return recs


def test_layout_reads_the_step_layout_span(spec, monkeypatch):
    """The median step's ``step.layout``; the forwards keep their whole
    time, and the reader of six layouts a step reads nothing."""
    counts = {"step.calls": 3, "fused.pack_weights": 6}
    recs = _laid_out_steps(3)
    read = _reader(spec, monkeypatch, "layout_host_ms.train", recs, counts)
    assert read(Reading({}, {}, {})) == pytest.approx(0.041)
    fwd = _reader(spec, monkeypatch, "fwd_host_ms.train", recs, counts)
    assert fwd(Reading({}, {}, {})) == pytest.approx(0.6)
    pack = _reader(spec, monkeypatch, "pack_host_ms.train", recs, counts)
    assert pack(Reading({}, {}, {})) is None


@pytest.mark.parametrize("recs", [_forward_laid_out_steps(3), []],
                         ids=["layout-a-forward", "no-spans"])
def test_layout_reads_nothing_without_the_span(spec, monkeypatch, recs):
    read = _reader(spec, monkeypatch, "layout_host_ms.train", recs,
                   {"step.calls": 3, "fused.pack_weights": 18})
    assert read(Reading({}, {}, {})) is None
