"""Misc helpers.

Copy of the part of `unsupervised_anomaly_detection_brain_mri_tpu/utils/
misc.py` that holds no JAX: ``timestamp``, ``normalize``,
``apply_colormap`` (matplotlib imported when it is called) and
``json_sanitize``; and ``device_peaks``, the JAX table with the H100's
rows added.
"""

from __future__ import annotations

import datetime
import math

import numpy as np


def device_peaks(dev_kind: str) -> tuple:
    """(peak_dense_flops_per_sec, peak_hbm_bytes_per_sec) for a device
    name: a TPU ``device_kind`` or ``torch.cuda.get_device_name`` -- the
    single source for the MFU rows of ``bench_torch.py`` and the ceilings
    of ``tools/*_roofline_torch.py``.  The TPU rows are the JAX package's.
    An H100 SXM (``NVIDIA H100 80GB HBM3``) gets NVIDIA's data-sheet bf16
    dense rate and HBM3 bandwidth at its 700 W limit; an H100 PCIe gets
    its own data-sheet row (bf16 dense 756 TFLOP/s, HBM2e 2.0 TB/s), never
    the SXM one.  Other kinds (other H100 forms, CPU runs) get placeholder
    ceilings so output keeps its shape without implying a real
    utilisation number."""
    kind = dev_kind.lower()
    if "h100" in kind:
        if "pcie" in kind:
            return 756e12, 2.0e12
        if "hbm3" in kind or "sxm" in kind:
            return 989e12, 3.35e12
        return 1e12, 100e9
    if "v5" in kind or "lite" in kind:
        return 197e12, 819e9  # v5e bf16 dense / HBM
    if "v4" in kind:
        return 275e12, 1228e9
    return 1e12, 100e9


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
