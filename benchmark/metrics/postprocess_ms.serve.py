"""``postprocess_ms.serve``: per request, ``eval/evaluate.py::_postprocess``
(residual, eroded mask, prior, the 5^3 median), synchronised at both
ends."""

from benchmark.common.readers import mean_span_ms, of_kind


def read(rec):
    return mean_span_ms(rec, "_postprocess") if of_kind(rec, "serve") else None
