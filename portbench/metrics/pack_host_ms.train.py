"""Host milliseconds a step spends laying out the generators' weights for
the packed forward, once a forward: the median over the traced segment's
steps of the program's ``fused.pack_weights`` spans. It reads nothing
unless the program's counters show six layouts a step (the packed forward
without remat) over the whole run."""
from portbench.program import counters, phase_medians, records

PER_STEP = 6


def read(reading):
    c = counters()
    steps = c and c.get("step.calls")
    if not steps or c.get("fused.pack_weights") != PER_STEP * steps:
        return None
    return phase_medians(records(), "step", ("fused.pack_weights",))
