"""Device-idle milliseconds inside a patient's preparation: the median over
the traced segment's patients of the time within ``engine.pad``,
``engine.masks`` and ``engine.upload`` in which no device operation ran,
the program's records mapped onto the profile by the benchmark's
``launch`` span around each patient."""
from portbench.program import phase_idle_medians, records

PREP = ("engine.pad", "engine.masks", "engine.upload")


def read(reading):
    return phase_idle_medians(reading.profile, records(), "launch",
                              "engine.patient", PREP)
