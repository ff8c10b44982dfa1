"""Host milliseconds a step spends laying out its generators' weights for
the packed forward, once a generator: the median over the traced
segment's steps of the program's ``step.layout`` span. It reads nothing
where the program has no such span (a step that lays out once a forward,
or the module forward)."""
from portbench.program import phase_medians, records


def read(reading):
    recs = records()
    if not recs or not any(r.name == "step.layout" for r in recs):
        return None
    return phase_medians(recs, "step", ("step.layout",))
