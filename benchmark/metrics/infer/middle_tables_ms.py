"""The sparse middle's table builds (`middle.tables` spans: sites,
neighbour and strided tables, the dense scatter), device ms a scene of
the kernels and copies launched inside them (`spans.py`, stretch b)."""
from benchmark.spans import reading


def read(rec):
    return reading(rec, "stream", "middle.tables", "busy_ms")
