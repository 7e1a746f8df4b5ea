"""Kernel K2 (`ops/pallas_gather.py`), device ms a scene in the
profiled stretch."""
from benchmark.readings import kernel_s
from benchmark.system import K2_KERNELS


def read(rec):
    s = kernel_s(rec, K2_KERNELS)
    if rec.get("loop") != "stream" or s <= 0:
        return None
    return 1e3 * s / rec["trace"]["units"]
