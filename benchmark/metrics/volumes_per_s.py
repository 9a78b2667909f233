"""``volumes_per_s``: scans completed over the time from the window's
start to the return of the last request begun before its end."""

from benchmark.common.readers import of_kind


def read(rec):
    if not of_kind(rec, "serve") or rec.get("trace"):
        return None
    return rec["units"] / rec["window_s"]
