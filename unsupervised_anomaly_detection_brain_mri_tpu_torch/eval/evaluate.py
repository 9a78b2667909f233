"""Volume reconstruction and residual post-processing: the serving subset of
`unsupervised_anomaly_detection_brain_mri_tpu/eval/evaluate.py`.

The residual pipeline keeps the JAX package's order: positive residual ->
multiply by the eroded brainmask -> hyperintensity prior -> 5^3 median.  The
median goes through ``ops.median.median_filter_3d_auto``, so a volume on the
card runs the CUDA kernel.

``evaluate()`` with its metric sweep and threshold transfer, and MC-dropout
reconstruction (``numMonteCarloSamples > 1``), are not ported yet.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from scipy import ndimage as ndi

from unsupervised_anomaly_detection_brain_mri_tpu.config import Options
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import write_nifti
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
    postprocess as P,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops.median import (
    median_filter_3d_auto,
)


def _zoom_volume(vol: np.ndarray, target: Tuple[int, int],
                 seg: bool = False) -> np.ndarray:
    """Per-slice scipy zoom.  vol: (H, W, S) -> (S, target_h, target_w);
    images use the default spline order, segmentations boundary 'nearest'
    (binarised downstream)."""
    H, W, S = vol.shape
    if (H, W) == tuple(target):
        return np.transpose(vol, (2, 0, 1)).astype(np.float32)
    zoom = (target[0] / H, target[1] / W)
    out = np.zeros((S, target[0], target[1]), np.float32)
    for s in range(S):
        if seg:
            out[s] = ndi.zoom(vol[:, :, s], zoom, mode="nearest")
        else:
            out[s] = ndi.zoom(vol[:, :, s], zoom)
    return out


def _reconstruct_volume(trainer, x: torch.Tensor, options: Options
                        ) -> Dict[str, Any]:
    """Reconstruct all slices of one volume as one batch.

    x: (S, H, W, 1) tensor on the trainer's device; the reconstruction stays
    on that device."""
    if int(options.numMonteCarloSamples or 0) > 1:
        raise NotImplementedError(
            "MC-dropout reconstruction (numMonteCarloSamples > 1) is not yet "
            "ported, see ROADMAP.md")
    return {"reconstruction": trainer.reconstruct_device(x)["reconstruction"]}


def _eroded_mask(skullmap: torch.Tensor, options: Options) -> torch.Tensor:
    """Brainmask after ``erosionIterations`` cross erosions (or as given
    when ``erodeBrainmask`` is off), as bool."""
    if options.erodeBrainmask:
        return P.binary_erosion_2d(skullmap, int(options.erosionIterations))
    return skullmap.to(torch.bool)


def _erode_and_postprocess(x: torch.Tensor, rec: torch.Tensor,
                           skm: torch.Tensor, prior_q: float,
                           options: Options) -> torch.Tensor:
    """Residual -> eroded-brainmask multiply -> prior -> median, on the
    tensors' device.  x, rec, skm: (S, H, W)."""
    eroded = _eroded_mask(skm, options)
    diff = P.positive_residual(x, rec, bool(options.keepOnlyPositiveResiduals))
    diff = diff * eroded.to(diff.dtype)
    if options.applyHyperIntensityPrior:
        diff = P.hyperintensity_prior_mask(diff, x, prior_q)
    if options.medianFiltering:
        diff = median_filter_3d_auto(diff.contiguous(), 5)
    return diff


def export_residual_volume(path: str, diff_sub: np.ndarray,
                           geometry: Dict[str, Any],
                           threshold: Optional[float] = None) -> np.ndarray:
    """Write a model-resolution residual stack (S, h, w) back into its
    source scan's geometry: de-zoom to the native slice resolution, place
    it at ``geometry['slice_range']`` along the iteration axis of a zeroed
    full-extent volume, and write it with the source pixdim/affine.  With
    ``threshold``, the binary twin ``<stem>.binary.nii.gz`` (thresholded at
    native resolution) is written too.  Returns the native float volume."""
    shape = tuple(geometry["shape"])
    axis = int(geometry["axis_index"])
    s0, _ = geometry["slice_range"]
    dims = list(shape)
    dims.append(dims.pop(axis))
    eval_shape = tuple(dims)
    h, w = eval_shape[:2]
    S, th, tw = diff_sub.shape
    if (th, tw) != (h, w):
        diff_sub = ndi.zoom(diff_sub, (1.0, h / th, w / tw))
        if diff_sub.shape != (S, h, w):
            raise ValueError(f"de-zoomed residual has shape {diff_sub.shape}, "
                             f"expected {(S, h, w)}")
    full = np.zeros(eval_shape, np.float32)
    full[:, :, s0:s0 + S] = np.transpose(diff_sub, (1, 2, 0))
    native = np.moveaxis(full, 2, axis)
    pixdim = tuple(geometry.get("pixdim", (1.0, 1.0, 1.0)))
    write_nifti(path, native, pixdim=pixdim, affine=geometry.get("affine"))
    if threshold is not None:
        base = path[:-7] if path.endswith(".nii.gz") else os.path.splitext(
            path)[0]
        write_nifti(base + ".binary.nii.gz",
                    (native > threshold).astype(np.float32),
                    pixdim=pixdim, affine=geometry.get("affine"))
    return native
