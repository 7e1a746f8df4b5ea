"""The decode and NMS's idle ms a scene (the `decode` span), built as
`infer.middle_idle_ms` is."""
from benchmark.spans import reading


def read(rec):
    return reading(rec, "stream", "decode", "idle_ms")
