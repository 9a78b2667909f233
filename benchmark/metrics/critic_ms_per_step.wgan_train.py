"""``critic_ms_per_step.wgan_train``: per WGAN step, the device time of the
operations launched inside the port's critic substeps (``train.substep``
spans with ``group`` ``disc``; ``common/launches.py``).  None on a port
without those spans."""

from benchmark.common.launches import launched_ms_per_unit, program_spans


def read(rec):
    if rec.get("mix") != "wgan_train":
        return None
    return launched_ms_per_unit(
        rec, program_spans(rec, "train.substep", group="disc"))
