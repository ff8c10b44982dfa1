"""K5's (``block_tail_bwd``, the CBAM block tail's backward) share of its
roofline in the traced segment: its launches' least time, bound by bytes
(h and g read, dh and the padded dx written, bf16), over the device time of
its kernel. On the route the H100 takes at the training shape (resident:
one cooperative launch a call) the kernel is found by the name below, one
event a launch; another route, or a count that disagrees, reads nothing."""
from portbench.roofline import k5_bound_s

K5_KERNEL = "block_tail_bwd_resident"


def read(reading):
    prof, extra = reading.profile, reading.extra
    if prof is None or not extra["k5_calls"]:
        return None
    match = lambda n: K5_KERNEL in n
    if prof.count(match) != extra["k5_calls"]:
        return None
    device_s = prof.device_time_s(match)
    return 100.0 * extra["k5_calls"] * k5_bound_s(*extra["k5_shape"]) \
        / device_s
