"""The share of a unit's wall time in the untraced window in which no
operation ran on the device, from the profiled stretch's device busy
seconds a unit, in %."""
from benchmark.readings import idle


def read(rec):
    return idle(rec, "train")
