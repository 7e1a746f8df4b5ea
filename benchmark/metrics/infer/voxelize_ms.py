"""Voxelize (`ops/voxelize.py`): the detector's entry to the sparse
middle's, device ms a scene (CUDA events, median)."""
from benchmark.readings import stage_ms


def read(rec):
    return stage_ms(rec, "stream", "voxelize")
