"""Volume/slice preprocessing (host-side numpy).

Parity targets:
  * percentile-clamped normalization (`utils/NII.py:53-75`): clamp to
    [lower, upper] percentiles then max-scale to [0,1] ('scaling') or
    standardize ('standardization'); per-volume, upper percentile 99.8
    (`dataloaders/BRAINWEB.py:292-295`).
  * slice resize via cv2 (train path, `dataloaders/BRAINWEB.py:141-142`) —
    bilinear for images, nearest for segmentations.
  * center crop / zero-pad helpers (`utils/image_utils.py:4-16`,
    `dataloaders/BRAINWEB.py:144-154`).

Copy of `unsupervised_anomaly_detection_brain_mri_tpu/data/preprocess.py`
for the port: only the import paths differ.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

try:  # cv2 is available in the image; fall back to scipy.ndimage otherwise
    import cv2  # type: ignore

    _HAVE_CV2 = True
except Exception:  # pragma: no cover
    _HAVE_CV2 = False
    from scipy import ndimage as _ndi  # type: ignore


def normalize_volume(
    vol: np.ndarray,
    method: str = "scaling",
    lower_percentile: Optional[float] = None,
    upper_percentile: Optional[float] = 99.8,
) -> np.ndarray:
    """Percentile clamp + scaling/standardization (`utils/NII.py:53-75`)."""
    v = np.nan_to_num(vol.astype(np.float32))
    if lower_percentile is not None:
        lo = np.percentile(v, lower_percentile)
        v = np.clip(v, lo, None)
    if upper_percentile is not None:
        hi = np.percentile(v, upper_percentile)
        v = np.clip(v, None, hi)
    if method == "scaling":
        m = v.max()
        if m > 0:
            v = v / m
    elif method == "standardization":
        v = (v - v.mean()) / max(v.std(), 1e-8)
    else:
        raise ValueError(f"unknown normalization {method!r}")
    return v


def resize_slice(img: np.ndarray, shape: Tuple[int, int],
                 nearest: bool = False) -> np.ndarray:
    """2-D resize; bilinear (images) or nearest (segmentations), parity with
    the cv2 train-path resize (`dataloaders/BRAINWEB.py:141-142`).

    Uses the native C++ kernels (cv2-identical sampling, `data/native.py`)
    when the toolchain is available, then cv2, then scipy."""
    if img.shape == tuple(shape):
        return img
    try:
        from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import native

        if native.available():
            if nearest:
                return native.resize_nearest(img, shape[0], shape[1])
            return native.resize_bilinear(img, shape[0], shape[1])
    except Exception:
        pass
    if _HAVE_CV2:
        interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
        # cv2 takes (width, height)
        return cv2.resize(img.astype(np.float32), (shape[1], shape[0]),
                          interpolation=interp)
    zoom = (shape[0] / img.shape[0], shape[1] / img.shape[1])
    return _ndi.zoom(img.astype(np.float32), zoom,
                     order=0 if nearest else 1)


def crop_center(img: np.ndarray, cropx: int, cropy: int) -> np.ndarray:
    """Center crop (`utils/image_utils.py:9-16`)."""
    y, x = img.shape[:2]
    sx = max(x // 2 - cropx // 2, 0)
    sy = max(y // 2 - cropy // 2, 0)
    return img[sy: sy + cropy, sx: sx + cropx]


def crop(img: np.ndarray, y: int, x: int, h: int, w: int) -> np.ndarray:
    """Offset crop (`utils/image_utils.py:4-6`)."""
    return img[y: y + h, x: x + w]


def pad_to_center(img: np.ndarray, target: Tuple[int, int]) -> np.ndarray:
    """Zero-pad a smaller slice into the center of the target shape
    (`dataloaders/BRAINWEB.py:147-154`)."""
    out = np.zeros(target, img.dtype)
    h, w = img.shape[:2]
    oy = (target[0] - h) // 2
    ox = (target[1] - w) // 2
    out[oy: oy + h, ox: ox + w] = img
    return out
