"""``prep_ms.serve``: per request, the time from ``detect``'s start to the
start of the reconstruction: normalisation, the per-slice zoom, the brain
mask, the prior's quantile, the upload and the erosion."""

import statistics

from benchmark.common.readers import of_kind, spans


def read(rec):
    if not of_kind(rec, "serve"):
        return None
    requests = spans(rec, "detect")
    recon = spans(rec, "_reconstruct_volume")
    if not requests or len(recon) != len(requests):
        return None
    return statistics.fmean((r["start_ns"] - q["start_ns"]) / 1e6
                            for q, r in zip(requests, recon))
