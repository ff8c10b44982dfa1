"""The residual trunk's (K1 ``residual_chain``, packed chain3: three calls
of three blocks a generator) share of its roofline in the traced segment:
the least time of its launched calls (the 18 3x3 convs of a generator at the
launched chunk shapes, against the carry and weights moved once) over the
device time of the trunk's kernels. The kernels are found by name; on the
route the H100 takes at these shapes (resident: one cooperative launch for
each conv) they are the two below. Another route reads nothing."""
from portbench.roofline import trunk_call_bound_s

TRUNK_KERNELS = ("conv3x3_in_resident", "conv_tail_resident")
BLOCKS_A_CALL = 3


def read(reading):
    prof, extra = reading.profile, reading.extra
    if prof is None or not extra["trunk_calls"]:
        return None
    device_s = prof.device_time_s(lambda n: any(k in n for k in
                                                TRUNK_KERNELS))
    if device_s <= 0:
        return None
    gen, size = reading.config["generator"], reading.config["img_size"]
    bound = extra["trunk_calls"] * trunk_call_bound_s(
        extra["chunk"], size // 4, 4 * gen["base_channels"], BLOCKS_A_CALL)
    return 100.0 * bound / device_s
