"""Misc helpers.

Copy of the part of `unsupervised_anomaly_detection_brain_mri_tpu/utils/
misc.py` that the port uses (``json_sanitize``).
"""

from __future__ import annotations

import math


def json_sanitize(obj):
    """Replace non-finite floats with None, recursively.

    ``json.dumps`` emits bare ``NaN``/``Infinity`` — invalid RFC-8259 JSON
    that strict consumers (jq, JS) reject; ``None`` carries the same
    "missing/bad" signal.  Used by every JSON artifact writer (evalPC.json,
    infer reports, metrics JSONL).
    """
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_sanitize(v) for v in obj]
    return obj
