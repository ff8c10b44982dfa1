"""Host milliseconds a step spends enqueuing the generators' backward: the
median over the traced segment's steps of the program's
``step.gen_backward`` span (``autograd.grad`` of the generator loss)."""
from portbench.program import phase_medians, records


def read(reading):
    return phase_medians(records(), "step", ("step.gen_backward",))
