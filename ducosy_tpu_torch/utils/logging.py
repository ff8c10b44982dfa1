"""Structured training observability.

The reference's only telemetry is tqdm postfix text (trainer.py:527-531) and
stdout prints. Here every step/epoch metric also lands in a JSONL file next
to the run (machine-readable for dashboards and the bench harness), plus an
in-terminal progress line. No external experiment tracker needed.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, *, print_every: int = 10):
        self.path = path
        self.print_every = print_every
        self._file = open(path, "a") if path else None
        self._last_print = 0.0

    def log(self, record: Dict[str, Any], *, force_print: bool = False):
        record = dict(record, ts=time.time())
        if self._file is not None:
            self._file.write(json.dumps(record, default=float) + "\n")
            self._file.flush()
        now = time.time()
        if force_print or now - self._last_print > 1.0:
            parts = [f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in record.items() if k != "ts"]
            print("  " + " ".join(parts), file=sys.stderr)
            self._last_print = now

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


class StepTimer:
    """Rolling step-rate tracker (steps/s and slices/s)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.start = None

    def tick(self) -> None:
        self.count += 1
        if self.count == self.warmup:
            self.start = time.perf_counter()

    def rate(self) -> float:
        if self.start is None or self.count <= self.warmup:
            return 0.0
        return (self.count - self.warmup) / (time.perf_counter() - self.start)
