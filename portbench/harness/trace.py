"""The profiled segment of a ``--trace 1`` run, read from
``torch.profiler``'s events in memory (no trace file is written).

A segment starts and ends at a synchronize; its length is the host clock's
from start to end. Device time is the union of the intervals of every
device event (kernels, copies, sets): kernels started early by
programmatic dependent launch overlap, so their summed durations can exceed
the span. Idle gaps are the holes in that union within the segment, each
named by the benchmark's own span (``record_function``) that the host was
in at the gap's middle, and by the program's outermost operation there.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

SEGMENT = "portbench.segment"


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Profile:
    """What a segment's events say: ``ops`` (name, start_us, end_us) of the
    device, ``spans`` the host's named ranges, ``busy_s``, ``window_s``."""

    def __init__(self, events, window_s: float):
        from torch.autograd import DeviceType

        self.window_s = window_s
        self.ops, self.spans, self.cpu = [], [], []
        seg = None
        for e in events:
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                # a host span also shows on the device timeline, as a user
                # annotation over the work it launched: not device work
                if not (e.name.startswith("portbench.")
                        or getattr(e, "is_user_annotation", False)):
                    self.ops.append((e.name, tr.start, tr.end))
            elif e.name == SEGMENT:
                seg = (tr.start, tr.end)
            elif e.name.startswith("portbench."):
                self.spans.append((e.name[len("portbench."):], tr.start,
                                   tr.end))
            elif e.name.startswith("aten::") and not (
                    e.cpu_parent and e.cpu_parent.name.startswith("aten::")):
                self.cpu.append((e.name, tr.start, tr.end))
        self.segment = seg or (min((s for _, s, _ in self.ops), default=0),
                               max((t for _, _, t in self.ops), default=0))
        self.busy = _union([(s, e) for _, s, e in self.ops])
        self.busy_s = sum(e - s for s, e in self.busy) / 1e6

    def device_time_s(self, match) -> float:
        """Union of the device time of ops whose name passes ``match``."""
        return sum(e - s for s, e in _union(
            [(s, e) for n, s, e in self.ops if match(n)])) / 1e6

    def count(self, match) -> int:
        return sum(1 for n, _, _ in self.ops if match(n))

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return sorted(([k[:160], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def _host_at(self, t) -> str:
        span = [n for n, s, e in self.spans if s <= t <= e]
        op = [n for n, s, e in self.cpu if s <= t <= e]
        name = span[-1] if span else "between spans"
        return f"{name}/{op[0]}" if op else name

    def idle_gaps(self, n: int = 10) -> list:
        """The longest holes in the device's busy time within the segment,
        named by what the host was doing at their middle."""
        lo, hi = self.segment
        edges = [lo] + [t for iv in self.busy for t in iv] + [hi]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at((a + b) / 2), (b - a) / 1e6]
                for a, b in gaps[:n]]


@contextmanager
def span(name: str, enabled: bool):
    """A named host range in the profile (a no-op outside a segment)."""
    if not enabled:
        yield
        return
    import torch

    with torch.profiler.record_function("portbench." + name):
        yield


class Segment:
    """``with Segment(device) as seg: ...`` profiles the block between two
    synchronizes; ``seg.profile`` is its ``Profile`` afterwards (on the
    CPU, where the tests run it, a profile without device events)."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from portbench.harness.common import sync

        sync(self.device)
        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._rf = torch.profiler.record_function(SEGMENT)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from portbench.harness.common import sync

        sync(self.device)
        window_s = time.perf_counter() - self._t0
        self._rf.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.profile = Profile(self._prof.events(), window_s)
        return False
