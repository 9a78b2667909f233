"""``kernel_ms_per_step.train``: the device's busy time (the union of its
operations' intervals) over the traced window, per training step."""

from benchmark.common.readers import of_kind, traced


def read(rec):
    tr = traced(rec)
    if tr is None or not of_kind(rec, "train"):
        return None
    return 1e3 * tr["busy_s"] / rec["units"]
