"""The head's post-hook to the losses on the host: loss, backward,
clip and AdamW, device ms a step (CUDA events, median)."""
from benchmark.readings import stage_ms


def read(rec):
    return stage_ms(rec, "train", "backward_update")
