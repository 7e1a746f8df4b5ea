"""The backward's idle ms a step (the `train.backward` span: autograd
from the loss to every `.grad`), built as `infer.middle_idle_ms` is."""
from benchmark.spans import reading


def read(rec):
    return reading(rec, "train", "train.backward", "idle_ms")
