"""Kernel, copy and memset launches a step inside the program's spans
(`train_step`; `spans.py`, stretch b)."""
from benchmark.spans import reading


def read(rec):
    return reading(rec, "train", None, "launches")
