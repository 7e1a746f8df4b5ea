"""The sparse middle (`models/middle.py`, `ops/sparse_conv.py`, K2),
device ms a scene (CUDA events at its forward hooks, median)."""
from benchmark.readings import stage_ms


def read(rec):
    return stage_ms(rec, "stream", "backbone")
