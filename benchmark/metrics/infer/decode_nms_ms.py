"""`decode_and_nms` (`eval/decode.py`, `ops/nms.py`, K1), device ms a
scene (CUDA events around the call, median)."""
from benchmark.readings import stage_ms


def read(rec):
    return stage_ms(rec, "stream", "decode_nms")
