"""``reconstruct_ms.serve``: per request, the reconstruction
(``eval/evaluate.py::_reconstruct_volume``; for ``VAE_You`` its
restoration), synchronised at both ends."""

from benchmark.common.readers import mean_span_ms, of_kind


def read(rec):
    return (mean_span_ms(rec, "_reconstruct_volume")
            if of_kind(rec, "serve") else None)
