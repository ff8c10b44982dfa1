"""The readers of the program's own spans and counters (portbench/program.py
and the metrics that use it): alignment of a request's records by the
benchmark span around it, device-idle time inside a phase, self time, and
nothing read where the counts disagree or the program has no spans."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import program
from portbench.harness.common import Reading
from portbench.harness.trace import Profile
from ducosy_tpu_torch import trace

SERVE = ("pad_share_pct.serve", "prep_host_ms.serve", "prep_idle_ms.serve")
TRAIN = ("fwd_host_ms.train", "pack_host_ms.train", "loss_host_ms.train",
         "bwd_host_ms.train", "opt_host_ms.train")
T0 = 10 ** 12          # the host clock (ns) is not the profile's (us)


def _event(name, start, end, device=DeviceType.CPU):
    return SimpleNamespace(name=name, device_type=device, cpu_parent=None,
                           is_user_annotation=False,
                           time_range=SimpleNamespace(start=start, end=end))


def _profile(launches, kernels):
    events = [_event("portbench.launch", s, e) for s, e in launches]
    events += [_event("kernel", s, e, DeviceType.CUDA) for s, e in kernels]
    events.append(_event("portbench.segment", 0, 2000))
    return Profile(events, 2000e-6)


def _patient(recs, request, start_us, phases):
    """A root ``engine.patient`` opened at T0 + start_us and its phases,
    (name, from, to) in us after the root's start."""
    base = T0 + int(start_us * 1e3)
    root = len(recs)
    end = max(t for _, _, t in phases) + 5
    recs.append(trace.Record("engine.patient", base, base + end * 1000,
                             None, request, 1))
    for name, a, b in phases:
        recs.append(trace.Record(name, base + a * 1000, base + b * 1000,
                                 root, request, 1))
    return recs


@pytest.fixture
def served():
    """Two patients in launches at 100-600 and 700-1200 us of the profile;
    their roots open 2 us after each launch, on the host clock 10 ms
    apart; kernels at 300-600 and 850-1200."""
    recs = _patient([], 1, 0, [("engine.pad", 10, 150),
                               ("engine.upload", 150, 250),
                               ("engine.chunk", 250, 490)])
    _patient(recs, 2, 10_000, [("engine.pad", 10, 100),
                               ("engine.upload", 100, 200),
                               ("engine.chunk", 200, 490)])
    prof = _profile([(98, 600), (698, 1200)], [(300, 600), (850, 1200)])
    return prof, recs


def _reader(spec, monkeypatch, name, recs, counts=None):
    monkeypatch.setattr(program, "records", lambda: recs)
    monkeypatch.setattr(program, "counters", lambda: counts or {})
    return spec.reader(name)


def test_alignment_maps_each_request_by_its_enclosing_span(served):
    prof, recs = served
    pairs = program.pairs(prof, recs, "launch", "engine.patient")
    assert [(s, r.request) for s, _, r, _ in pairs] == [(98, 1), (698, 2)]
    # each root mapped onto its span's start (98, 698 us) ends at +495 us,
    # 7 us before its span
    assert program.end_gaps_ms(prof, recs, "launch", "engine.patient") == \
        pytest.approx([0.007, 0.007])


def test_idle_inside_the_preparation(served, spec, monkeypatch):
    """Patient 1: pad 108-248 idle, upload 248-348 idle till 300 (140 + 52
    us); patient 2: pad 708-798, upload 798-898 idle till 850 (90 + 52)."""
    prof, recs = served
    read = _reader(spec, monkeypatch, "prep_idle_ms.serve", recs)
    assert read(Reading({}, {}, {}, prof)) == pytest.approx(
        (192 + 142) / 2 / 1e3)
    host = _reader(spec, monkeypatch, "prep_host_ms.serve", recs)
    assert host(Reading({}, {}, {}, prof)) == pytest.approx(
        (240 + 190) / 2 / 1e3)


@pytest.mark.parametrize("launches", [[(98, 600)],
                                      [(98, 600), (698, 1200), (1300, 1400)],
                                      []])
def test_count_mismatch_reads_nothing(served, spec, monkeypatch, launches):
    _, recs = served
    prof = _profile(launches, [(300, 600)])
    assert program.pairs(prof, recs, "launch", "engine.patient") is None
    read = _reader(spec, monkeypatch, "prep_idle_ms.serve", recs)
    assert read(Reading({}, {}, {}, prof)) is None


def _steps(n):
    recs = []
    for k in range(n):
        base = T0 + k * 10 ** 9
        root = len(recs)
        recs.append(trace.Record("step", base, base + 900_000, None, k + 1,
                                 1))
        t = base
        for _ in range(6):
            fwd = len(recs)
            recs.append(trace.Record("step.gen_forward", t, t + 100_000,
                                     root, k + 1, 1))
            recs.append(trace.Record("fused.pack_weights", t,
                                     t + 30_000 + k * 1000, fwd, k + 1, 1))
            t += 100_000
        for name, ns in (("step.gen_loss", 50_000), ("step.gen_backward",
                                                     80_000),
                         ("step.disc", 20_000), ("step.disc", 20_000),
                         ("step.optimizer", 60_000 + k)):
            recs.append(trace.Record(name, t, t + ns, root, k + 1, 1))
            t += ns
    return recs


def test_step_phases_read_their_self_times(spec, monkeypatch):
    """Three steps: the forwards' self time less the layouts, the layouts
    (30, 31, 32 us each), the loss, backward and optimizer, medians."""
    recs = _steps(3)
    counts = {"step.calls": 3, "fused.pack_weights": 18}
    want = {"fwd_host_ms.train": 6 * (100 - 31) / 1e3,
            "pack_host_ms.train": 6 * 31 / 1e3,
            "loss_host_ms.train": 0.05, "bwd_host_ms.train": 0.08,
            "opt_host_ms.train": 0.060001}
    for name, value in want.items():
        read = _reader(spec, monkeypatch, name, recs, counts)
        assert read(Reading({}, {}, {})) == pytest.approx(value)


@pytest.mark.parametrize("counts", [{"step.calls": 3,
                                     "fused.pack_weights": 36},
                                    {"step.calls": 3}, {}])
def test_pack_reads_nothing_unless_six_layouts_a_step(spec, monkeypatch,
                                                      counts):
    read = _reader(spec, monkeypatch, "pack_host_ms.train", _steps(3),
                   counts)
    assert read(Reading({}, {}, {})) is None


def test_pad_share_from_the_engine_counters(spec, monkeypatch):
    read = _reader(spec, monkeypatch, "pad_share_pct.serve", [],
                   {"engine.slices": 2656, "engine.padded_slices": 96})
    assert read(Reading({}, {}, {})) == pytest.approx(100 * 96 / 2752)


def test_a_program_without_spans_reads_nothing(spec, monkeypatch, served):
    """An older checkout (no ``ducosy_tpu_torch.trace``): every new reader
    returns None and raises nothing."""
    prof, _ = served
    monkeypatch.setattr(program, "program_trace", lambda: None)
    for name in SERVE + TRAIN:
        assert spec.reader(name)(Reading({}, {}, {}, prof)) is None


@pytest.mark.parametrize("cell", ["serving", "training"])
def test_traced_cpu_run_reads_every_new_metric(request, spec, make_ctx,
                                               cell):
    """Each cell's run at CPU size with ``trace``: each new metric of the cell
    reads a number (but the layouts': the CPU's step runs the module
    forward, which lays out nothing), and each benchmark span holds one
    request."""
    from portbench.harness import serve_closed_loop, train_pool

    config, traffic = request.getfixturevalue(cell)
    kind = serve_closed_loop if cell == "serving" else train_pool
    trace.reset()
    out = kind.run(make_ctx(config, traffic, seconds=0.2, trace=True))
    names = SERVE if cell == "serving" else TRAIN
    for name in names:
        value = spec.reader(name)(out.reading)
        if name == "pack_host_ms.train":
            assert value is None
            continue
        assert isinstance(value, float) and value >= 0, name
    outer, root, n = ("launch", "engine.patient",
                      traffic["profile_patients"]) if cell == "serving" \
        else ("step_call", "step", traffic["profile_steps"])
    gaps = program.end_gaps_ms(out.reading.profile, trace.records(), outer,
                               root)
    assert gaps is not None and len(gaps) == n
    trace.reset()
