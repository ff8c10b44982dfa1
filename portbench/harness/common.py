"""What every driver hands back, and small helpers they share."""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def log(msg: str) -> None:
    import sys

    print(msg, file=sys.stderr, flush=True)


class Parts:
    """Seconds of the set-up's named parts, each from the end of the last."""

    def __init__(self, t0: float):
        self.t0 = self.last = t0
        self.parts = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = now - self.last
        self.last = now

    def line(self) -> str:
        return "setup by part: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in self.parts.items())


@dataclass
class Reading:
    """What the per-layer readers read: the cell's files, the measured
    window, the profiled segment (None without ``--trace 1``) and the
    driver's own counts and clocks."""
    config: dict
    traffic: dict
    window: dict
    profile: object = None
    extra: dict = field(default_factory=dict)


@dataclass
class Outcome:
    """A run as the driver saw it. ``checks``: (name, value, limit), each
    passing where value <= limit."""
    end_to_end: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    reading: Reading
    checks: list

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v <= lim for _, v, lim in
                                        self.checks)


@dataclass
class Ctx:
    """A run's settings. ``device`` is the card, or the CPU in the tests;
    ``check_path`` holds the run to the path the configuration names
    (off only where the CPU tests drive the plain versions)."""
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    t0: float
    device: object = "cuda"
    check_path: bool = True
