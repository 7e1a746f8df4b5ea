"""The window's seconds over the scenes it completed, in ms (host clock):
the online stack's latency with one sweep in flight."""


def read(rec):
    if rec.get("loop") != "stream":
        return None
    return 1e3 * rec["window_s"] / rec["units"]
