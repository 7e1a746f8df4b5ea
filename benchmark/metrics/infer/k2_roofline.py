"""K2's share of its roofline: the least time of the profiled stretch's
K2 calls (`bounds.k2_bound_s`, from the reference's tables) over their
device time, in %."""
from benchmark.readings import kernel_s, share
from benchmark.system import K2_KERNELS


def read(rec):
    if rec.get("loop") != "stream":
        return None
    return share(rec.get("k2_bound_s", 0.0), kernel_s(rec, K2_KERNELS))
