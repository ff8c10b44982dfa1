"""The program's own spans and counters (``ducosy_tpu_torch/trace.py``),
read for the per-layer metrics of a ``--trace 1`` run.

The program keeps a record of a span only while a profiler records, so the
records of a run are those of its traced segment. Each request (a patient,
a step) is one root record (``engine.patient``, ``step``) with its phases
below it. The records' clock is the host's ``perf_counter``; the segment's
``Profile`` is on the profiler's clock. Each benchmark span around a call
into the program (``launch``, ``step_call``) encloses exactly one root
record, which opens microseconds after it, so the difference of their
starts maps that request's records onto the profile. Where the counts
disagree nothing is mapped.

Each function returns None where there is nothing to read: a program
without ``trace.py`` (an older checkout), no records, or counts that
disagree. Nothing here raises on such a run.
"""
from __future__ import annotations

import statistics


def program_trace():
    """The program's ``trace`` module, or None where it has none."""
    try:
        from ducosy_tpu_torch import trace
    except ImportError:
        return None
    return trace


def records():
    trace = program_trace()
    return None if trace is None else trace.records()


def counters() -> dict | None:
    trace = program_trace()
    return None if trace is None else trace.counters()


def requests(recs: list, root: str) -> dict:
    """{request: [indices of its records]} for the closed root records
    named ``root`` (in the order opened) and the closed records below
    them."""
    out = {r.request: [i] for i, r in enumerate(recs)
           if r.name == root and r.parent is None and r.end_ns is not None}
    for i, r in enumerate(recs):
        if r.parent is not None and r.request in out and r.end_ns is not None:
            out[r.request].append(i)
    return out


def phase_medians(recs: list, root: str, names, *, own: bool = False):
    """The median over requests of the ms their records named in ``names``
    take (their self time with ``own``), or None without requests."""
    if not recs:
        return None
    times = program_trace().self_ns(recs) if own else [
        0 if r.end_ns is None else r.end_ns - r.start_ns for r in recs]
    per = [sum(times[i] for i in idx if recs[i].name in names)
           for idx in requests(recs, root).values()]
    return statistics.median(per) / 1e6 if per else None


def pairs(profile, recs: list, outer: str, root: str):
    """The benchmark's ``outer`` spans (name, start, end; us) and the closed
    ``root`` records, each in order, paired as
    [(span start, span end, record, offset)], where offset (us) maps the
    record's request onto the profile: profile us = ns / 1e3 + offset.
    None where the counts disagree or there are none."""
    if profile is None or not recs:
        return None
    spans = sorted((s, e) for n, s, e in profile.spans if n == outer)
    roots = sorted((r for r in recs if r.name == root and r.parent is None
                    and r.end_ns is not None), key=lambda r: r.start_ns)
    if not spans or len(spans) != len(roots):
        return None
    return [(s, e, r, s - r.start_ns / 1e3) for (s, e), r in zip(spans,
                                                                  roots)]


def idle_us(profile, start: float, end: float) -> float:
    """Microseconds of [start, end] (profile clock) in which no device
    operation ran."""
    busy = 0.0
    for s, e in profile.busy:
        if e <= start:
            continue
        if s >= end:
            break
        busy += min(e, end) - max(s, start)
    return max(end - start, 0.0) - busy


def phase_idle_medians(profile, recs: list, outer: str, root: str, names):
    """The median over requests of the device-idle ms inside their records
    named in ``names``, once aligned; None where alignment fails."""
    paired = pairs(profile, recs, outer, root)
    if paired is None:
        return None
    offset = {r.request: off for _, _, r, off in paired}
    per = [sum(idle_us(profile, recs[i].start_ns / 1e3 + offset[req],
                       recs[i].end_ns / 1e3 + offset[req])
               for i in idx if recs[i].name in names)
           for req, idx in requests(recs, root).items()]
    return statistics.median(per) / 1e3


def end_gaps_ms(profile, recs: list, outer: str, root: str):
    """For each request, in order: the benchmark span's end less the root
    record's mapped end, in ms (how closely the clocks agree)."""
    paired = pairs(profile, recs, outer, root)
    if paired is None:
        return None
    return [(e - (r.end_ns / 1e3 + off)) / 1e3 for _, e, r, off in paired]
