"""Step start to the head's post-hook, targets included: device ms a
step (CUDA events, median)."""
from benchmark.readings import stage_ms


def read(rec):
    return stage_ms(rec, "train", "forward")
