"""``mfu_pct.train``: the reference's FLOPs of one step at the cell's batch
(``common/flops.py``) times the traced steps, over the traced window, as a
share of the card's dense bf16 peak."""

from benchmark.common.readers import mfu_pct, of_kind


def read(rec):
    return mfu_pct(rec) if of_kind(rec, "train") else None
