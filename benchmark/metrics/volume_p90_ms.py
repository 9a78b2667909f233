"""``volume_p90_ms``: the 90th percentile of the latency of every request
of the window (``statistics.quantiles``, inclusive), in ms."""

import statistics

from benchmark.common.readers import of_kind


def read(rec):
    lat = rec.get("latencies_s") if of_kind(rec, "serve") else None
    if not lat:
        return None
    if len(lat) == 1:
        return 1e3 * lat[0]
    return 1e3 * statistics.quantiles(lat, n=100, method="inclusive")[89]
