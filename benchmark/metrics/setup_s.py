"""Start of the process to the first timed scene or step: import,
kernel build or load, weights, the pool, warm-up (host clock), less the
seconds the reference spent in it (its modules, the calibration)."""


def read(rec):
    return rec["setup_s"]
