"""The sparse convs' weight and bias gradients (`sparse.dw` spans: the
stacked gather and its matmul), device ms a step of the kernels launched
inside them (`spans.py`, stretch b)."""
from benchmark.spans import reading


def read(rec):
    return reading(rec, "train", "sparse.dw", "busy_ms")
