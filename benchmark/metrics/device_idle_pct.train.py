"""``device_idle_pct.train``: the share of the traced training window in
which no operation ran on the device."""

from benchmark.common.readers import idle_pct, of_kind


def read(rec):
    return idle_pct(rec) if of_kind(rec, "train") else None
