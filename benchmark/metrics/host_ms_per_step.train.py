"""``host_ms_per_step.train``: the host's time to enqueue one training
step, the mean of the ``train_step`` spans (no synchronisation inside)."""

from benchmark.common.readers import mean_span_ms, of_kind


def read(rec):
    return mean_span_ms(rec, "train_step") if of_kind(rec, "train") else None
