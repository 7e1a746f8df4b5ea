"""The sparse convs' input gradients (`sparse.dx` spans: K2 over the
flipped or inverse tables), device ms a step of the kernels launched
inside them (`spans.py`, stretch b)."""
from benchmark.spans import reading


def read(rec):
    return reading(rec, "train", "sparse.dx", "busy_ms")
