"""``mfu_pct.serve``: the reference's FLOPs of one scan's reconstruction
(a forward, or every restoration step) times the traced requests, over the
traced window, as a share of the card's dense bf16 peak."""

from benchmark.common.readers import mfu_pct, of_kind


def read(rec):
    return mfu_pct(rec) if of_kind(rec, "serve") else None
