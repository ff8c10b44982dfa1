"""Share of the traced segment (whole patients in the CLI's order, between
two synchronizes, by the host clock) in which no operation ran on the
device."""


def read(reading):
    prof = reading.profile
    if prof is None or prof.busy_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
