"""``train_slices_per_s``: every slice trained in the window over the
window's time, which ends with a ``torch.cuda.synchronize()``."""

from benchmark.common.readers import of_kind


def read(rec):
    if not of_kind(rec, "train") or rec.get("trace"):
        return None
    return rec["units"] * rec["slices_per_unit"] / rec["window_s"]
