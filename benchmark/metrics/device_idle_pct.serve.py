"""``device_idle_pct.serve``: the share of the traced serving window in
which no operation ran on the device."""

from benchmark.common.readers import idle_pct, of_kind


def read(rec):
    return idle_pct(rec) if of_kind(rec, "serve") else None
