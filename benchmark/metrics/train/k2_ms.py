"""Kernel K2 (`ops/pallas_gather.py`), device ms a step in the
profiled stretch (forward and input gradients)."""
from benchmark.readings import kernel_s
from benchmark.system import K2_KERNELS


def read(rec):
    s = kernel_s(rec, K2_KERNELS)
    if rec.get("loop") != "train" or s <= 0:
        return None
    return 1e3 * s / rec["trace"]["units"]
