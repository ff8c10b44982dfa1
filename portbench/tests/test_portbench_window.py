"""The training window enqueues steps back to back: one synchronize before
the first step and one after the last, and between steps no synchronize,
no upload and no read of a device value."""
import pytest

from portbench.harness import train_pool


class Untouched:
    """A step's output that fails any read of its value."""

    def _read(self, *a, **k):
        raise AssertionError("a device value was read inside the window")

    __float__ = __bool__ = __int__ = item = tolist = cpu = numpy = _read


def test_window_holds_no_sync_or_read_between_steps(monkeypatch):
    log = []
    monkeypatch.setattr(train_pool, "sync", lambda dev: log.append("sync"))
    pool = [f"batch{i}" for i in range(4)]

    def step(batch):
        log.append(batch)
        return {"loss_G": Untouched(), "loss_D": Untouched()}

    outs, seconds = train_pool.run_window(step, pool, 2, 0.05, "cuda")
    n = len(outs)
    assert n >= 2 and seconds >= 0.05
    assert log[0] == "sync" and log[-1] == "sync"
    assert log[1:-1] == [pool[(2 + i) % 4] for i in range(n)]
    with pytest.raises(AssertionError):
        float(outs[0]["loss_G"])


def test_window_feeds_the_resident_pool(monkeypatch, training):
    """Every batch the window hands the step is a tensor of the pool itself
    (no copy, no upload between steps)."""
    import torch

    config, traffic = training
    pool = train_pool.make_pool(config, traffic, 5, "cpu")
    seen = []
    monkeypatch.setattr(train_pool, "sync", lambda dev: None)
    train_pool.run_window(lambda b: seen.append(b) or {}, pool, 0, 0.02,
                          "cpu")
    ids = {id(t) for b in pool for t in b.values()}
    assert seen and all(id(t) in ids for b in seen for t in b.values())
    assert all(isinstance(t, torch.Tensor) for b in seen for t in b.values())
