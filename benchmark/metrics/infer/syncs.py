"""CUDA calls that waited for the device, a scene, inside the program's
spans (`forward`, `decode`; `spans.py`, stretch b)."""
from benchmark.spans import reading


def read(rec):
    return reading(rec, "stream", None, "syncs")
