"""Post-processing on tensors: erosion, residuals, connected components.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/ops/
postprocess.py`.  The semantics are the JAX package's, the formulation is
the GPU's:

  * connected components keep the label "1 + flat index of the
    component's minimal voxel" (26-connectivity); labelling works on the
    last three axes, so a (n, S, H, W) stack labels n volumes at once with
    per-volume flat indices and no label crossing from one volume to the
    next (the JAX package's ``vmap``).  The path is chosen by the tensor's
    device: a CUDA tensor goes through the hand-written union-find chain
    of ``ops/ccl.py`` (``csrc/ccl3d.cu``), which always reaches the fixpoint
    and never syncs, or raises; a CPU tensor through the plain version,
    iterative min-label propagation with the JAX package's
    ``max_iters``/``sweeps_per_check`` cap;
  * component sizes and distinct-label counts come from ``torch.bincount``
    plus a gather.  The TPU used sort-scans because random gathers
    serialise there; on a GPU the histogram is the natural form.

The 5^3 median lives in ``ops/median.py``.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import ccl
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import trace

_INF = 2 ** 30


def binary_erosion_2d(mask: torch.Tensor, iterations: int = 12
                      ) -> torch.Tensor:
    """scipy ``binary_erosion(structure=cross, iterations=n)`` with
    border_value=0, per slice.  mask: (..., H, W) bool/float -> bool."""
    m = mask.to(torch.bool)
    for _ in range(iterations):
        p = torch.nn.functional.pad(m, (1, 1, 1, 1))
        m = (p[..., 1:-1, 1:-1] & p[..., :-2, 1:-1] & p[..., 2:, 1:-1]
             & p[..., 1:-1, :-2] & p[..., 1:-1, 2:])
    return m


def apply_brainmask(x: torch.Tensor, brainmask: torch.Tensor,
                    erode: bool = True, iterations: int = 12) -> torch.Tensor:
    """Residual masking by the (optionally eroded) brainmask.
    x, brainmask: (..., H, W)."""
    m = brainmask.to(torch.bool)
    if erode:
        m = binary_erosion_2d(m, iterations)
    return x * m.to(x.dtype)


def positive_residual(x: torch.Tensor, x_rec: torch.Tensor,
                      keep_only_positive: bool = True) -> torch.Tensor:
    """max(x - x_rec, 0) or |x - x_rec|."""
    if keep_only_positive:
        return torch.clamp_min(x - x_rec, 0.0)
    return torch.abs(x - x_rec)


def hyperintensity_prior_mask(diff: torch.Tensor, x: torch.Tensor,
                              quantile_value: float) -> torch.Tensor:
    """Zero residuals where the input is below the hyperintensity prior
    quantile (compared in float32, like the JAX package)."""
    q = torch.tensor(quantile_value, dtype=torch.float32, device=x.device)
    trace.count("host_syncs")  # a pageable host-to-device copy
    return torch.where(x < q, torch.zeros_like(diff), diff)


def _min_pool_3x3x3(labels: torch.Tensor) -> torch.Tensor:
    """Separable 3^3 min-pool of the last three axes with edge
    replication: three 3-tap passes."""
    out = labels
    for axis in (-3, -2, -1):
        n = out.shape[axis]
        lo = torch.cat([out.narrow(axis, 0, 1), out.narrow(axis, 0, n - 1)],
                       dim=axis)
        hi = torch.cat([out.narrow(axis, 1, n - 1),
                        out.narrow(axis, n - 1, 1)], dim=axis)
        out = torch.minimum(out, torch.minimum(lo, hi))
    return out


def _seed(shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """1 + flat index within one volume (the last three axes)."""
    vol = tuple(shape[-3:])
    return torch.arange(1, math.prod(vol) + 1, dtype=torch.int32,
                        device=device).reshape(vol)


def _converged(mask: torch.Tensor):
    """The kernel chain's convergence flag, read with no sync: True for one
    volume, a True bool tensor of the leading shape for a stack."""
    if mask.ndim == 3:
        return True
    return torch.ones(mask.shape[:-3], dtype=torch.bool, device=mask.device)


def connected_components_3d(mask: torch.Tensor, max_iters: int = 1024,
                            sweeps_per_check: int = 4,
                            return_converged: bool = False):
    """26-connected labeling; the path is chosen by the mask's device.

    mask: (S, H, W), or (..., S, H, W) to label each volume on its own.
    A CUDA mask is labelled by the union-find kernel chain
    (``ops/ccl.py``), which always reaches the fixpoint, reads nothing back
    to the host and ignores ``max_iters`` and ``sweeps_per_check``; its
    convergence flag is True.  A CPU mask takes
    ``connected_components_3d_plain`` (min-label propagation under the
    ``max_iters`` cap).  ``return_converged=True`` also returns whether the
    fixpoint was reached: a bool for one volume, a bool tensor of the
    leading shape for a stack.

    Returns int32 labels: 0 = background, else 1 + flat index (within its
    volume) of the component's minimal voxel.
    """
    if mask.is_cuda:
        out = ccl.connected_components_3d_cuda(
            mask.to(torch.bool).contiguous())
        return (out, _converged(mask)) if return_converged else out
    return connected_components_3d_plain(mask, max_iters, sweeps_per_check,
                                         return_converged)


def connected_components_3d_plain(mask: torch.Tensor, max_iters: int = 1024,
                                  sweeps_per_check: int = 4,
                                  return_converged: bool = False):
    """26-connected labeling by iterative min-label propagation, on any
    device (the CPU path, and the kernel chain's yardstick on the card).

    Each round runs ``sweeps_per_check`` 3^3 min-pool sweeps before the
    convergence test (one host sync per round, counted in ``cc_rounds``).
    A component whose minimal voxel is more than
    ``max_iters * sweeps_per_check`` steps from its farthest voxel is
    returned partially merged.  Labels and ``return_converged`` as in
    ``connected_components_3d``.
    """
    mask = mask.to(torch.bool)
    seed = _seed(mask.shape, mask.device)
    inf = torch.full(mask.shape, _INF, dtype=torch.int32, device=mask.device)
    labels = torch.where(mask, seed, inf)
    changed = torch.ones(mask.shape[:-3], dtype=torch.bool,
                         device=mask.device)
    it = 0
    while it < max_iters:
        new = labels
        for _ in range(sweeps_per_check):
            new = torch.where(mask, torch.minimum(new, _min_pool_3x3x3(new)),
                              inf)
        changed = (new != labels).flatten(-3).any(-1)
        labels = new
        it += 1
        trace.count("cc_rounds")
        trace.count("host_syncs")
        if not bool(changed.any()):
            break
    out = torch.where(mask, labels, torch.zeros_like(labels))
    if return_converged:
        converged = ~changed
        if converged.ndim == 0:
            trace.count("host_syncs")
            return out, bool(converged)
        return out, converged
    return out


def _flat_with_offsets(labels: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """int64 labels shifted so each volume of a stack owns the bins
    [v * per, (v + 1) * per), flattened; plus the volume count and per."""
    n_vol = math.prod(labels.shape[:-3])
    per = math.prod(labels.shape[-3:]) + 1
    off = (torch.arange(n_vol, device=labels.device, dtype=torch.int64)
           * per).reshape(labels.shape[:-3] + (1, 1, 1))
    return (labels.to(torch.int64) + off).reshape(-1), n_vol, per


def component_sizes(labels: torch.Tensor) -> torch.Tensor:
    """sizes[l] = voxel count of label l (index 0, background, is 0), shape
    (n_voxels + 1,) for one (S, H, W) volume."""
    flat = labels.reshape(-1).to(torch.int64)
    sizes = torch.bincount(flat, minlength=labels.numel() + 1)
    sizes[0] = 0
    return sizes.to(torch.int32)


def per_voxel_component_size(labels: torch.Tensor) -> torch.Tensor:
    """Size of each voxel's component (0 for background voxels), int32;
    per volume for a stack."""
    flat, _, _ = _flat_with_offsets(labels)
    counts = torch.bincount(flat)
    # a CUDA bincount reads its input's min and max back
    trace.count("host_syncs", 2)
    sizes = counts[flat].reshape(labels.shape)
    return torch.where(labels > 0, sizes, 0).to(torch.int32)


def num_components(labels: torch.Tensor) -> torch.Tensor:
    """Number of components: voxels whose label is their own seed (per
    volume for a stack), int64."""
    seed = _seed(labels.shape, labels.device)
    return ((labels == seed) & (labels > 0)).flatten(-3).sum(-1)


def _labels_hit(labels: torch.Tensor, hit_mask: torch.Tensor
                ) -> torch.Tensor:
    """Number of distinct non-zero labels present under ``hit_mask`` (per
    volume for a stack), int64."""
    flat, n_vol, per = _flat_with_offsets(
        torch.where(hit_mask, labels, torch.zeros_like(labels)))
    present = torch.bincount(flat, minlength=n_vol * per).reshape(
        n_vol, per) > 0
    present[:, 0] = False
    return present.sum(-1).reshape(labels.shape[:-3])


def filter_small_components(mask: torch.Tensor, min_size: int = 7,
                            max_iters: int = 1024,
                            return_converged: bool = False
                            ) -> Union[torch.Tensor, Tuple[torch.Tensor, bool]]:
    """Remove 26-connected components with <= ``min_size`` voxels.
    mask: (S, H, W) -> float32 0/1 (plus the convergence bool of
    ``connected_components_3d`` with ``return_converged``).  A CUDA mask
    goes through the kernel chain (``ops/ccl.py``: labels, atomic counts
    and the filter with no host sync; ``max_iters`` does not apply and the
    flag is True), a CPU mask through ``filter_small_components_plain``."""
    with trace.span("serve.components"):
        if mask.is_cuda:
            out = ccl.filter_small_components_cuda(
                mask.to(torch.bool).contiguous(), min_size)
            return (out, _converged(mask)) if return_converged else out
        return filter_small_components_plain(mask, min_size, max_iters,
                                             return_converged)


def filter_small_components_plain(mask: torch.Tensor, min_size: int = 7,
                                  max_iters: int = 1024,
                                  return_converged: bool = False):
    """``filter_small_components`` by the plain propagation
    (``connected_components_3d_plain``) and bincount sizes, on any
    device."""
    m = mask.to(torch.bool)
    labels, converged = connected_components_3d_plain(
        m, max_iters, return_converged=True)
    keep = per_voxel_component_size(labels) > min_size
    out = (m & keep).to(torch.float32)
    if return_converged:
        return out, converged
    return out


def detection_counts_chunk(pred: torch.Tensor, gt: torch.Tensor,
                           max_iters: int = 512):
    """(TPs, FPs, FNs, converged) of a slice chunk, or of each chunk of a
    (n, chunk, H, W) stack:

      * TP = number of components of pred AND gt;
      * pred components with < 8 voxels are dropped before FP counting;
      * FP = pred components not touched by any intersection component;
      * FN = gt components not touched by any intersection component.
    """
    pred = pred.to(torch.bool)
    gt = gt.to(torch.bool)
    inter = pred & gt
    cc_inter, conv_i = connected_components_3d(
        inter, max_iters, return_converged=True)
    tps = num_components(cc_inter)

    cc_pred, conv_p = connected_components_3d(
        pred, max_iters, return_converged=True)
    cc_pred = torch.where(per_voxel_component_size(cc_pred) >= 8, cc_pred,
                          torch.zeros_like(cc_pred))
    fps = _labels_hit(cc_pred, cc_pred > 0) - _labels_hit(cc_pred, inter)

    cc_gt, conv_g = connected_components_3d(
        gt, max_iters, return_converged=True)
    fns = num_components(cc_gt) - _labels_hit(cc_gt, inter)
    return tps, fps, fns, conv_i & conv_p & conv_g


def volume_to_chunks(volume: torch.Tensor, chunk: int = 20) -> torch.Tensor:
    """Split a (S, H, W) volume into zero-padded (n, chunk, H, W) float32
    chunks.  Zero padding adds no components."""
    S, H, W = volume.shape
    n = -(-S // chunk)
    padded = torch.zeros((n * chunk, H, W), dtype=torch.float32,
                         device=volume.device)
    padded[:S] = volume
    return padded.reshape(n, chunk, H, W)


def detection_counts_batch(pred_chunks: torch.Tensor,
                           gt_chunks: torch.Tensor, max_iters: int = 512):
    """Per-chunk (TPs, FPs, FNs, converged) of a (n, chunk, H, W) stack,
    each chunk labelled on its own."""
    return detection_counts_chunk(pred_chunks, gt_chunks, max_iters)


def compute_detection_rate(pred_volume: torch.Tensor,
                           gt_volume: torch.Tensor, chunk: int = 20
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Lesion-detection TP/FP/FN summed over 20-slice chunks."""
    t, f, n, _ = detection_counts_batch(volume_to_chunks(pred_volume, chunk),
                                        volume_to_chunks(gt_volume, chunk))
    return t.sum(), f.sum(), n.sum()
