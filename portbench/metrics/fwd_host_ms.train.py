"""Host milliseconds a step spends enqueuing its six generator forwards
outside the weights' layout: the median over the traced segment's steps of
the self time of the program's ``step.gen_forward`` spans (their time less
``fused.pack_weights`` inside them)."""
from portbench.program import phase_medians, records


def read(reading):
    return phase_medians(records(), "step", ("step.gen_forward",), own=True)
