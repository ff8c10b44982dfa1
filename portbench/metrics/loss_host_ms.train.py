"""Host milliseconds a step spends enqueuing the generators' loss: the
median over the traced segment's steps of the program's ``step.gen_loss``
span (the discriminators' logits on the fakes and the nine-term suite)."""
from portbench.program import phase_medians, records


def read(reading):
    return phase_medians(records(), "step", ("step.gen_loss",))
