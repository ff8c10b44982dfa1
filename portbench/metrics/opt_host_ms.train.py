"""Host milliseconds a step spends enqueuing its optimizers: the median
over the traced segment's steps of the program's ``step.optimizer`` span
(the gradients' assignment and the three Adam steps)."""
from portbench.program import phase_medians, records


def read(reading):
    return phase_medians(records(), "step", ("step.optimizer",))
