"""The head's idle ms a scene (the `head` span), built as
`infer.middle_idle_ms` is."""
from benchmark.spans import reading


def read(rec):
    return reading(rec, "stream", "head", "idle_ms")
