"""``components_ms.serve``: per request,
``ops/postprocess.py::filter_small_components``, synchronised at both
ends."""

from benchmark.common.readers import mean_span_ms, of_kind


def read(rec):
    return (mean_span_ms(rec, "filter_small_components")
            if of_kind(rec, "serve") else None)
