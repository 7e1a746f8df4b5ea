"""The RPN neck (`models/backbone2d.py`), device ms a scene (CUDA
events at its forward hooks, median)."""
from benchmark.readings import stage_ms


def read(rec):
    return stage_ms(rec, "stream", "neck")
