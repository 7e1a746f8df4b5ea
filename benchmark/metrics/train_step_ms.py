"""The window's seconds over the steps it completed, in ms (host clock):
batch from the host, `train_step`, losses back to the host."""


def read(rec):
    if rec.get("loop") != "train":
        return None
    return 1e3 * rec["window_s"] / rec["units"]
