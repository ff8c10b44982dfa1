"""Host milliseconds a patient spends before its first chunk: the median
over the traced segment's patients of the program's spans ``engine.pad``
(``np.concatenate`` up to a whole chunk), ``engine.masks`` (mask-
conditioned engines) and ``engine.upload`` (the volume to the card)."""
from portbench.program import phase_medians, records

PREP = ("engine.pad", "engine.masks", "engine.upload")


def read(reading):
    return phase_medians(records(), "engine.patient", PREP)
