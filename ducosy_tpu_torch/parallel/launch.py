"""One process per mesh row: spawn the ranks, run a function in each,
return their results or raise the first failure.

    spawn(fn, args, devices)   # [fn(devices[0], *args), ...] in rank order

A rank's entry is a device, or its row of a (data, sp) mesh (a tuple of
devices, passed to ``fn`` as it is): a (2, 2) run is 2 ranks of 2 bands.

Each rank is a fresh interpreter (the ``spawn`` start method) that joins a
process group at ``tcp://localhost:<free port>`` with a finite timeout, so
a collective that one rank never reaches raises in the others instead of
waiting for ever. The backend follows the devices (NCCL for CUDA, gloo for
the CPU) unless the caller names one: two ranks on one card need gloo,
which NCCL refuses. ``fn`` must be importable by its module path, and
whatever it returns is pickled back to the parent. The ranks build no
kernel: a caller on a card builds the libraries first (``_build``) so N
ranks do not run N nvccs.

The parent joins with a deadline. The first rank that raises ends the run:
the other ranks are stopped (they may be waiting in a collective for it)
and its exception is raised in the parent, its traceback as the cause.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, Sequence

import torch

from ducosy_tpu_torch.parallel.mesh import PG_TIMEOUT, default_backend

POLL_S = 0.5
STOP_GRACE_S = 10.0
EXIT_REPORT_S = 2.0   # a report may still be in the pipe at exit


class RankFailed(RuntimeError):
    """A rank died without reporting, or the run outlived its deadline."""


class RemoteTraceback(Exception):
    """The traceback of a rank's exception, as text."""

    def __str__(self):
        return self.args[0]


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(index: int, world: int, port: int, backend: str,
               device: torch.device, timeout: datetime.timedelta,
               fn: Callable, args: tuple, kwargs: dict, results) -> None:
    import torch.distributed as dist

    first = device[0] if isinstance(device, tuple) else device
    try:
        if first.type == "cuda":
            torch.cuda.set_device(first)
        else:   # CPU ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=index, timeout=timeout)
        report = (index, True, fn(device, *args, **kwargs), None)
    except BaseException as e:  # reported to the parent, which raises it
        report = (index, False, e, traceback.format_exc())
    # reported before the group is torn down: after a failure the teardown
    # may wait for ranks that the parent is about to stop
    try:
        payload = pickle.dumps(report)
    except Exception:   # a result or an exception that does not pickle
        payload = pickle.dumps((index, False, RuntimeError(repr(report[2])),
                                report[3] or traceback.format_exc()))
    results.put(payload)
    if report[1] and dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn: Callable, args: tuple, devices: Sequence[torch.device], *,
          kwargs: dict | None = None, backend: str | None = None,
          timeout: float | None = None,
          pg_timeout: datetime.timedelta = PG_TIMEOUT) -> list[Any]:
    """Run ``fn(devices[i], *args, **kwargs)`` as rank i of
    ``len(devices)`` and return the results in rank order; an entry may be
    a row of devices (a tuple). ``timeout`` (seconds, None: no limit)
    bounds the whole run; ``pg_timeout`` each collective."""
    devices = [tuple(torch.device(x) for x in d)
               if isinstance(d, (list, tuple)) else torch.device(d)
               for d in devices]
    first = devices[0][0] if isinstance(devices[0], tuple) else devices[0]
    backend = backend or default_backend(first)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port, world = free_port(), len(devices)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         name=f"rank{i}",
                         args=(i, world, port, backend, dev, pg_timeout, fn,
                               args, kwargs or {}, results))
             for i, dev in enumerate(devices)]
    deadline = None if timeout is None else time.monotonic() + timeout
    out: dict[int, Any] = {}
    gone: dict[int, float] = {}   # rank -> when its exit was first seen
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                payload = results.get(timeout=POLL_S)
            except queue.Empty:
                now = time.monotonic()
                for i, p in enumerate(procs):
                    if i not in out and p.exitcode is not None:
                        gone.setdefault(i, now)
                        if now - gone[i] > EXIT_REPORT_S:
                            raise RankFailed(f"{p.name} exited with code "
                                             f"{p.exitcode} without a report")
                if deadline is not None and time.monotonic() > deadline:
                    missing = sorted(set(range(world)) - set(out))
                    raise RankFailed(f"ranks {missing} did not finish within "
                                     f"{timeout} s")
                continue
            index, ok, value, tb = pickle.loads(payload)
            if not ok:
                raise value from RemoteTraceback(f"rank {index}:\n{tb}")
            out[index] = value
    except BaseException:
        _stop(procs, 0.0)   # the others may wait in a collective for ever
        raise
    finally:
        results.close()
    _stop(procs, STOP_GRACE_S)
    return [out[i] for i in range(world)]


def _stop(procs, grace: float) -> None:
    """Join the ranks within ``grace`` seconds, then kill what is left."""
    end = time.monotonic() + grace
    for p in procs:
        if p.pid is not None:
            p.join(max(0.0, end - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(STOP_GRACE_S)
