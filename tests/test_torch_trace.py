"""The port's spans and counters (ducosy_tpu_torch/trace.py) on the CPU: off
without a profiler, where only the counters count; under
``torch.profiler.profile`` the engine's and the step's phases as nested
records with their request, on the profiler's timeline too; the prefetch
thread's own chain; the training CLI's ``--profile_dir`` trace. Sizes are
small: 32^2 slices, base 8, 2 residual blocks, fp32."""
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ducosy_tpu_torch import trace
from ducosy_tpu_torch.cli import train as tcli
from ducosy_tpu_torch.config import SOFT_TISSUE, ModelConfig, \
    TrainConfig, replace
from ducosy_tpu_torch.infer.engine import DualGeneratorEngine
from ducosy_tpu_torch.models.convert import init_generator_state_dict
from ducosy_tpu_torch.train.state import create_state
from ducosy_tpu_torch.train.step import make_train_step

sys.path.insert(0, os.path.dirname(__file__))
from synth import chest_hu, write_dataset  # noqa: E402

SIZE, Z, CHUNK = 32, 5, 4
CFG = replace(TrainConfig(), img_size=SIZE, batch_size=2,
              compute_dtype="float32")
MODEL = ModelConfig(num_residual_blocks=2, base_channels=8,
                    disc_base_channels=8)
# the packed step's phases; the module forward's lack the layout
STEP_PHASES = ["step.layout"] + ["step.gen_forward"] * 6 + [
    "step.gen_loss", "step.gen_backward", "step.disc", "step.disc",
    "step.optimizer"]


@pytest.fixture(autouse=True)
def fresh():
    """No record or count from another test; one intra-op thread for these
    runs of many small CPU ops, which the suite's files running side by side
    on oversubscribed cores slow many times over on a full thread team."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.reset()
    yield
    trace.reset()
    torch.set_num_threads(threads)


def _engine(st_channels=1):
    sd = lambda seed, ch: init_generator_state_dict(seed, ch, base=8,
                                                    blocks=2)
    return DualGeneratorEngine(sd(1, st_channels), sd(2, 1), img_size=SIZE,
                               compute_dtype=torch.float32, device="cpu")


def _volume():
    hu = np.stack([chest_hu(SIZE, SIZE, z=i) for i in range(Z)])
    return (hu + 1024).astype(np.int16)          # slope 1, intercept -1024


def _patient(engine=None):
    return (engine or _engine()).run_patient(_volume(), 1.0, -1024.0,
                                             chunk=CHUNK)


def _step():
    state = create_state(CFG, SOFT_TISSUE, MODEL, device="cpu")
    g = torch.Generator().manual_seed(0)
    img = lambda c: torch.rand(2, SIZE, SIZE, c, generator=g) * 2 - 1
    batch = {"a": img(1), "b": img(1), "masks": (img(2) > 0).float()}
    step = make_train_step(CFG, remat=False, gen_forward="packed")
    step(state, batch)
    assert step.gen_forward == "packed"


RUN = {"patient": _patient, "step": _step}
COUNTS = {"patient": {"engine.slices": Z, "engine.padded_slices": 3,
                      "engine.chunks": 2,
                      "engine.h2d_bytes": (Z + 3) * SIZE * SIZE * 2},
          "step": {"step.calls": 1, "fused.pack_weights": 2}}


@pytest.mark.parametrize("kind", ["patient", "step"])
def test_off_keeps_no_record_and_counts(kind):
    """Without a profiler no span keeps a record; the counters count."""
    RUN[kind]()
    assert trace.records() == []
    got = trace.counters()
    assert {k: got.get(k) for k in COUNTS[kind]} == COUNTS[kind]
    if kind == "patient":       # the postprocess's filter matrices
        assert got["filters.h2d_bytes"] > 0


def _children(recs, parent):
    return [r.name for r in recs if r.parent == parent]


def _check_nesting(recs):
    """Every child lies within its parent, in its thread, with its
    request; no record's children take more than it does."""
    own = trace.self_ns(recs)
    for i, r in enumerate(recs):
        assert r.end_ns is not None and own[i] >= 0
        if r.parent is not None:
            up = recs[r.parent]
            assert up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns
            assert (r.thread, r.request) == (up.thread, up.request)


@pytest.mark.parametrize("kind", ["patient", "step"])
def test_profiled_spans_nest_with_their_request(kind):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        RUN[kind]()
    recs = trace.records()
    _check_nesting(recs)
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert len(roots) == 1
    root = recs[roots[0]]
    if kind == "patient":
        assert (root.name, root.request) == ("engine.patient", 1)
        assert _children(recs, roots[0]) == [
            "engine.pad", "engine.upload", "engine.chunk", "engine.chunk",
            "engine.postprocess"]
    else:
        assert (root.name, root.request) == (
            "step", trace.counters()["step.calls"])
        assert _children(recs, roots[0]) == STEP_PHASES
        forwards = [i for i, r in enumerate(recs)
                    if r.name == "step.gen_forward"]
        assert [_children(recs, i) for i in forwards] == [[]] * 6
        layout = [i for i, r in enumerate(recs) if r.name == "step.layout"]
        assert [_children(recs, i) for i in layout] == \
            [["fused.pack_weights"] * 2]
    names = {e.name for e in prof.events()}
    assert {r.name for r in recs} <= names


def test_prefetch_thread_keeps_its_own_chain():
    """``engine.host_masks`` under the patient when the engine computes the
    masks itself; a root of its own, in the pool's thread, when
    ``prefetch_masks`` computes them."""
    engine = _engine(st_channels=1 + len(SOFT_TISSUE.mask_types))
    vol = _volume()
    with profile(activities=[ProfilerActivity.CPU]):
        engine.run_patient(vol, 1.0, -1024.0, chunk=CHUNK)
        fut = engine.prefetch_masks(vol, 1.0, -1024.0)
        engine.run_patient(vol, 1.0, -1024.0, chunk=CHUNK, masks=fut)
    recs = trace.records()
    _check_nesting(recs)
    masks = [r for r in recs if r.name == "engine.host_masks"]
    assert len(masks) == 2
    inline, pooled = masks
    assert recs[inline.parent].name == "engine.masks"
    assert inline.request == 1 and inline.thread == threading.get_ident()
    assert pooled.parent is None and pooled.request is None
    assert pooled.thread != threading.get_ident()
    second = [r for r in recs if r.request == 2]
    assert [r.name for r in second if r.parent is not None][:3] == [
        "engine.pad", "engine.masks", "engine.upload"]
    assert trace.counters()["engine.h2d_bytes"] == 2 * (
        (Z + 3) * SIZE * SIZE * 2
        + (Z + 3) * SIZE * SIZE * len(SOFT_TISSUE.mask_types))


def test_records_are_bounded(monkeypatch):
    """Past MAX_RECORDS a span still runs and reaches the profiler, and
    keeps no record."""
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with trace.span("outer", i), trace.span("inner"):
                pass
    recs = trace.records()
    assert [(r.name, r.request) for r in recs] == [
        ("outer", 0), ("inner", 0), ("outer", 1)]
    assert sum(e.name == "inner" for e in prof.events()) == 5


def test_self_ns_subtracts_children():
    rec = lambda name, s, e, parent: trace.Record(name, s, e, parent, 0, 0)
    recs = [rec("a", 0, 100, None), rec("b", 10, 40, 0),
            rec("c", 50, 90, 0), rec("d", 60, 70, 2), rec("e", 95, None, 0)]
    assert trace.self_ns(recs) == [30, 30, 30, 10, 0]


def test_train_cli_profile_trace_holds_the_step_spans(tmp_path):
    """The ``--profile_dir`` window (steps 5 to 8 of the first epoch, cut
    here at its end) writes the step's and the loop's spans into
    trace.json."""
    write_dataset(str(tmp_path / "data"), n_patients=4, n_slices=5,
                  size=SIZE)
    args = {"--data_root": str(tmp_path / "data"),
            "--dataset_names": "SynthSet",
            "--training_dir": str(tmp_path / "td"), "--img_size": str(SIZE),
            "--batch_size": "2", "--num_residual_blocks": "2",
            "--base_channels": "8", "--disc_base_channels": "8",
            "--compute_dtype": "float32", "--device": "cpu",
            "--epochs": "1", "--max_steps_per_epoch": "6",
            "--num_workers": "1", "--val_split": "0.25",
            "--profile_dir": str(tmp_path / "prof")}
    tcli.main([a for kv in args.items() for a in kv])
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # the CPU's loop runs the module forward, which lays out nothing
    assert {"step", "loop.load", "loop.upload", *STEP_PHASES[1:]} <= names
