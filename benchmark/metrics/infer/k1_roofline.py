"""K1's share of its roofline: the least time of the profiled stretch's
K1 calls (`bounds.k1_bound_s`, the pairs greedy NMS needs on the
reference's candidates) over their device time, in %."""
from benchmark.readings import kernel_s, share
from benchmark.system import K1_KERNELS


def read(rec):
    if rec.get("loop") != "stream":
        return None
    return share(rec.get("k1_bound_s", 0.0), kernel_s(rec, K1_KERNELS))
