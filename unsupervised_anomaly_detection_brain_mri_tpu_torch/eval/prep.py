"""Serving's prep on the device: the raw scan is uploaded once, then
normalised, zoomed slice by slice, masked, and its prior's quantile taken
there.  The results equal the host path of ``eval/inference.py::detect``
(``data/preprocess.py::normalize_volume``, ``eval/evaluate.py::
_zoom_volume``, ``np.quantile``):

  * quantiles: one ``torch.sort`` of the volume gives every order
    statistic.  The indices and the weight are computed on the host with
    numpy's own arithmetic for its 'linear' method, and the interpolation
    runs on the device one float32 operation at a time, as numpy's
    ``_lerp`` does: bit-equal to ``np.percentile`` and ``np.quantile``;
  * normalisation (``scaling``): clip at the upper percentile and divide
    by the clipped maximum, elementwise in float32, bit-equal;
  * zoom: scipy's spline zoom of a slice is linear and separable, so it is
    ``A_h @ slice @ A_w.T`` with operators built from scipy's own 1-D
    ``ndi.zoom`` of the identity's rows, in float64 as scipy accumulates,
    rounded to float32 at the end: equal to the host up to that rounding;
  * mask: ``x > 0.05``, or a given brain mask zoomed with its ``nearest``
    operators and ``> 0.5``.

Other normalisations stay on the host.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from scipy import ndimage as ndi

from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import trace

PRIOR_QUANTILE = 0.9
MASK_LEVEL = 0.05


@functools.lru_cache(maxsize=None)
def zoom_operator(n_in: int, n_out: int, mode: str = "constant"
                  ) -> np.ndarray:
    """(n_out, n_in) float64: column i is scipy's ``ndi.zoom`` (spline
    order 3, ``mode``) of the i-th unit vector to ``n_out`` samples.  The
    array is shared by every caller and read-only."""
    op = np.stack([ndi.zoom(row, n_out / n_in, mode=mode)
                   for row in np.eye(n_in)], axis=1)
    if op.shape != (n_out, n_in):
        raise ValueError(f"zoom of {n_in} to {n_out} gave {op.shape[0]}")
    op.flags.writeable = False
    return op


@functools.lru_cache(maxsize=None)
def _operator_on(n_in: int, n_out: int, mode: str,
                 device: torch.device) -> torch.Tensor:
    trace.count("host_syncs")  # a pageable host-to-device copy
    return torch.tensor(zoom_operator(n_in, n_out, mode), device=device)


def zoom_volume_device(vol: torch.Tensor, target: Tuple[int, int],
                       mode: str = "constant") -> torch.Tensor:
    """``_zoom_volume`` of a float32 (H, W, S) tensor on its device:
    (S, target_h, target_w) float32.  Images use ``mode`` 'constant',
    brain masks 'nearest'."""
    with trace.span("serve.zoom"):
        H, W, _ = vol.shape
        slices = vol.permute(2, 0, 1)
        if (H, W) == tuple(target):
            return slices.contiguous()
        a_h = _operator_on(H, target[0], mode, vol.device)
        a_w = _operator_on(W, target[1], mode, vol.device)
        return (a_h @ slices.double() @ a_w.T).float()


def _order_pair(sorted_flat: torch.Tensor, q: float
                ) -> Tuple[torch.Tensor, float]:
    """numpy's 'linear' quantile at the fraction ``q`` of a float32 array
    whose ascending sort is ``sorted_flat``: its two order statistics as a
    (2,) tensor, and the weight, with numpy's index arithmetic in float32."""
    n = int(sorted_flat.numel())
    virtual = (n - 1) * np.asanyarray(q, dtype=np.float32)
    if virtual >= n - 1:
        lo = hi = n - 1
        g = 0.0
    else:
        lo = int(np.floor(virtual))
        hi = lo + 1
        g = float(virtual - np.floor(virtual))
    return torch.stack((sorted_flat[lo], sorted_flat[hi])), g


def _lerp(pair: torch.Tensor, g: float) -> torch.Tensor:
    """numpy's ``_lerp`` of the pair's two values at the weight ``g``, one
    float32 operation at a time."""
    a, b = pair[0], pair[1]
    diff = b - a
    if g >= 0.5:
        return b - diff * float(np.float32(1) - np.float32(g))
    return a + diff * g


def percentile_device(sorted_flat: torch.Tensor, q: float) -> torch.Tensor:
    """``np.quantile(v, q)`` of a float32 array v whose ascending sort is
    ``sorted_flat``, as a 0-d tensor on its device, bit-equal.  For
    ``np.percentile(v, p)`` pass ``np.true_divide(p, np.float32(100))``,
    the fraction numpy computes."""
    return _lerp(*_order_pair(sorted_flat, q))


def normalize_device(v: torch.Tensor, upper_percentile: Optional[float]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``normalize_volume`` (``scaling``, no lower percentile) of a float32
    tensor already through ``nan_to_num``, on its device, bit-equal; and
    the prior's quantile of the result as a 0-d tensor.  One sort gives
    the order statistics of both: clipping and dividing are monotone, so
    the k-th smallest of the result is the k-th smallest of v, scaled."""
    ordered = torch.sort(v.reshape(-1)).values
    clip = None
    if upper_percentile is not None:
        clip = percentile_device(
            ordered, np.true_divide(upper_percentile, np.float32(100)))
    top = ordered[-1] if clip is None else torch.minimum(ordered[-1], clip)

    def scale(t: torch.Tensor) -> torch.Tensor:
        if clip is not None:
            t = torch.minimum(t, clip)
        return torch.where(top > 0, t / top, t)

    pair, g = _order_pair(ordered, PRIOR_QUANTILE)
    return scale(v), _lerp(scale(pair), g)


def prepare_device(volume: np.ndarray, target: Tuple[int, int],
                   upper_percentile: Optional[float], device: torch.device,
                   brainmask: Optional[np.ndarray] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """The prep of ``detect`` for the ``scaling`` normalisation, on
    ``device``: (x and the brain mask, both (S, target_h, target_w)
    float32 on the device, and the prior's quantile of the normalised
    volume).  volume: (H, W, S) raw intensities."""
    trace.count("serve.prep_device")
    with trace.span("serve.upload"):
        raw = torch.from_numpy(np.ascontiguousarray(
            volume, dtype=np.float32)).to(device)
        trace.count("host_syncs")
    with trace.span("serve.normalize"):
        vol, prior = normalize_device(torch.nan_to_num(raw),
                                      upper_percentile)
    x = zoom_volume_device(vol, target)
    with trace.span("serve.mask"):
        if brainmask is not None:
            m = torch.from_numpy(np.ascontiguousarray(
                brainmask, dtype=np.float32)).to(device)
            trace.count("host_syncs")
            skm = (zoom_volume_device(m, target, "nearest") > 0.5).float()
        else:
            skm = (x > MASK_LEVEL).float()
        prior_q = prior.item()
        trace.count("host_syncs")
    return x, skm, prior_q
