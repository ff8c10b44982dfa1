"""Named spans and integer counters at the program's layer boundaries.

``span(name, request=None)`` marks a phase of a patient or a step. It is
on only while a torch profiler records (the training CLI's
``--profile_dir`` window, or any ``torch.profiler.profile`` a caller
opens): it then enters ``torch.profiler.record_function(name)``, so the
phase shows on the profiler's own timeline beside the kernels it launched,
and keeps a ``Record`` in a bounded list in memory. Otherwise it returns
one shared no-op context. A record's parent is the span open around it in
the same thread (``prefetch_masks`` runs in a thread pool, so each thread
keeps its own chain); its request is the one it was given, else its
parent's: the patient or step it belongs to.

``count(name, n)`` adds to an integer counter, always on; the program
counts at patient, chunk or step level, never per kernel (the kernels
count their own launches, ``ops/kernels``).

Nothing here writes a file: the profiler's own export writes the trace.
"""
from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass

import torch
from torch.autograd import profiler as _profiler

MAX_RECORDS = 1 << 16     # spans past this still reach the profiler


@dataclass(slots=True)
class Record:
    """One span: host clock (``perf_counter_ns``) at its start and end
    (None while open), the index of its parent record (None at a root),
    its request and the thread that opened it."""
    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    request: object
    thread: int


_records: list[Record] = []
_counters: dict[str, int] = {}
_lock = threading.Lock()
_open = threading.local()   # .stack: (index, record) of this thread's spans
_OFF = nullcontext()


class _Span:
    __slots__ = ("name", "request", "_fn", "_rec")

    def __init__(self, name: str, request):
        self.name, self.request = name, request

    def __enter__(self):
        # the record encloses the profiler's range: a caller's range around
        # the call opens just before this record and closes just after it
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent, up = stack[-1] if stack else (None, None)
        request = self.request
        if request is None and up is not None:
            request = up.request
        rec = self._rec = Record(self.name, time.perf_counter_ns(), None,
                                 parent, request, threading.get_ident())
        with _lock:
            index = len(_records) if len(_records) < MAX_RECORDS else None
            if index is not None:
                _records.append(rec)
        stack.append((index, rec))
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        return self

    def __exit__(self, *exc):
        self._fn.__exit__(*exc)
        _open.stack.pop()
        self._rec.end_ns = time.perf_counter_ns()
        return False


def span(name: str, request=None):
    """A context manager around one phase; see the module's docstring. The
    test is the profiler's process-wide flag, set by any profiler started
    from Python, so a span in a thread the profiler does not follow (a pool
    started before it) keeps its record too."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, request)


def count(name: str, n: int = 1) -> int:
    """Add ``n`` to the counter ``name``; returns its new total."""
    with _lock:
        total = _counters[name] = _counters.get(name, 0) + n
    return total


def records() -> list[Record]:
    """The records kept since the last ``reset``, in the order opened."""
    with _lock:
        return list(_records)


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Forget every record and counter; call it with no span open."""
    with _lock:
        _records.clear()
        _counters.clear()


def self_ns(recs: list[Record]) -> list[int]:
    """Each record of ``recs`` (the list ``records()`` returned) less its
    children's durations, in order; an open record reads 0."""
    dur = [0 if r.end_ns is None else r.end_ns - r.start_ns for r in recs]
    out = list(dur)
    for r, d in zip(recs, dur):
        if r.parent is not None and r.parent < len(out):
            out[r.parent] -= d
    return out
