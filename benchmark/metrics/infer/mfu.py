"""The whole scene's share of the card's fp32-accurate matmul peak: the
reference's FLOP count of the window's scenes over the window's
seconds and the peak, in % (the untraced window)."""
from benchmark.readings import mfu


def read(rec):
    return mfu(rec, "stream")
