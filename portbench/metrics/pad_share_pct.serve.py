"""Share of the slices the engine forwarded that were chunk padding (the
last slice repeated up to a whole chunk), from the program's counters
``engine.padded_slices`` and ``engine.slices`` over every patient of the
run: warm-up, window and traced segment. Over whole cycles of the traffic's
sizes it is fixed by them (thin 96 of 2752, thick 128 of 704)."""
from portbench.program import counters


def read(reading):
    c = counters()
    if not c or not c.get("engine.slices"):
        return None
    pad = c.get("engine.padded_slices", 0)
    return 100.0 * pad / (c["engine.slices"] + pad)
