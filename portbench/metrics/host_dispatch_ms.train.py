"""Milliseconds the host takes to enqueue one training step: the
benchmark's host clock around a step call made on an idle card (after a
synchronize), the median of the probe steps after the warm-up. Where it
nears the step's device time, the host paces the step again."""


def read(reading):
    return 1e3 * reading.extra["host_dispatch_s"]
