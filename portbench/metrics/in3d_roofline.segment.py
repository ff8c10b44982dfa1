"""K2's 3-D route's (``instance_norm3d``: ``in_stats`` then
``in_apply3d``, every norm of the network) share of its roofline in the
traced segment: the least time of its launches, bound by bytes (each
norm's input read once and output written once, bf16, at the launched
batch shapes), over the device time of its two kernels. The kernels are
found by name, one ``in_apply3d`` event a launch (a batch of patches is one
group of K2's plan); where the count disagrees, or the segment ran another
K2 route, it reads nothing."""
from portbench.roofline import PEAK_BYTES


def read(reading):
    prof, extra = reading.profile, reading.extra
    if prof is None or not extra.get("in3d_launches"):
        return None
    if prof.count(lambda n: "in_apply3d" in n) != extra["in3d_launches"] \
            or prof.count(lambda n: "in_apply" in n
                          and "in_apply3d" not in n):
        return None
    device_s = prof.device_time_s(lambda n: "in_apply3d" in n
                                  or "in_stats" in n)
    if device_s <= 0:
        return None
    return 100.0 * extra["in3d_bound_bytes"] / PEAK_BYTES / device_s
