"""The sparse middle's idle ms a scene: its device ms by its span's CUDA
events (`spans.py`, stretch a) less the device time of the kernels and
copies launched inside it (stretch b), the time the device waited for
the host there."""
from benchmark.spans import reading


def read(rec):
    return reading(rec, "stream", "middle", "idle_ms")
