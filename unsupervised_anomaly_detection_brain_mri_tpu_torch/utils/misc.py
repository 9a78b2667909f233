"""Misc helpers.

Copy of the part of `unsupervised_anomaly_detection_brain_mri_tpu/utils/
misc.py` that holds no JAX: ``timestamp``, ``normalize``,
``apply_colormap`` (matplotlib imported when it is called) and
``json_sanitize``.
"""

from __future__ import annotations

import datetime
import math

import numpy as np


def timestamp() -> str:
    """(`utils/utils.py` timestamp)."""
    return datetime.datetime.now().strftime("%Y%m%d-%H%M%S")


def normalize(x: np.ndarray) -> np.ndarray:
    """Min-max normalise to [0, 1] (`utils/utils.py:74-75`)."""
    x = np.asarray(x, np.float32)
    lo, hi = x.min(), x.max()
    if hi > lo:
        return (x - lo) / (hi - lo)
    return np.zeros_like(x)


def apply_colormap(img: np.ndarray, cmap=None) -> np.ndarray:
    """Apply a matplotlib colormap to a [0,1] image -> uint8 RGB."""
    if cmap is None:
        import matplotlib.pyplot as plt

        cmap = plt.cm.jet
    rgba = cmap(normalize(np.squeeze(img)))
    return (rgba[..., :3] * 255).astype(np.uint8)


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
