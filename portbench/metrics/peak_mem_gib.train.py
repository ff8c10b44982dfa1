"""Peak device memory allocated during the window's steps
(``max_memory_allocated`` after ``reset_peak_memory_stats``), GiB."""


def read(reading):
    peak = reading.extra["window_peak_bytes"]
    return peak / 2 ** 30 if peak else None
