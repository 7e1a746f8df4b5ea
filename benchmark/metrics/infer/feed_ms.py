"""Host-to-card copy of the points and card-to-host copy of the
Detections, device ms a scene (CUDA events, median)."""
from benchmark.readings import stage_ms


def read(rec):
    return stage_ms(rec, "stream", "feed")
