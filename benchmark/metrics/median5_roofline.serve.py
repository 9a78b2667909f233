"""``median5_roofline.serve``: the least time of one call of the 5^3
median kernel (``csrc/median5.cu``, ``median5_kernel``), its input read
and its output written once at the card's HBM bandwidth, over the
kernel's mean profiled time a call.  The kernel computes no products, so
bytes bound it."""

import math

from benchmark.common.readers import kernel_seconds, of_kind, spans


def read(rec):
    if not of_kind(rec, "serve") or not rec.get("peaks"):
        return None
    kern = kernel_seconds(rec, "median5_kernel")
    calls = spans(rec, "median")
    if kern is None or not calls or kern["count"] != len(calls):
        return None
    bound_s = sum(2 * 4 * math.prod(c["shape"]) for c in calls) \
        / rec["peaks"][1]
    return 100.0 * bound_s / kern["seconds"]
