"""Post-processing on tensors: erosion, residuals, connected components.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/ops/
postprocess.py` (the serving subset).  The semantics are the JAX package's,
the formulation is the GPU's:

  * connected components keep the label "1 + flat index of the
    component's minimal voxel" (26-connectivity, iterative min-label
    propagation with the same ``max_iters``/``sweeps_per_check`` cap);
  * component sizes come from ``torch.bincount`` plus a gather.  The TPU
    used a sort-scan because random gathers serialise there; on a GPU the
    histogram is the natural form.

The 5^3 median lives in ``ops/median.py``.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

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
    return torch.where(x < q, torch.zeros_like(diff), diff)


def _min_pool_3x3x3(labels: torch.Tensor) -> torch.Tensor:
    """Separable 3^3 min-pool with edge replication: three 3-tap passes."""
    out = labels
    for axis in range(3):
        n = out.shape[axis]
        lo = torch.cat([out.narrow(axis, 0, 1), out.narrow(axis, 0, n - 1)],
                       dim=axis)
        hi = torch.cat([out.narrow(axis, 1, n - 1),
                        out.narrow(axis, n - 1, 1)], dim=axis)
        out = torch.minimum(out, torch.minimum(lo, hi))
    return out


def connected_components_3d(mask: torch.Tensor, max_iters: int = 1024,
                            sweeps_per_check: int = 4,
                            return_converged: bool = False
                            ) -> Union[torch.Tensor, Tuple[torch.Tensor, bool]]:
    """26-connected labeling by iterative min-label propagation.

    Each round runs ``sweeps_per_check`` 3^3 min-pool sweeps before the
    convergence test.  A component whose minimal voxel is more than
    ``max_iters * sweeps_per_check`` steps from its farthest voxel is
    returned partially merged; ``return_converged=True`` also returns a
    bool that is False exactly when the cap was hit before the fixpoint.

    Returns int32 labels: 0 = background, else 1 + flat index of the
    component's minimal voxel.
    """
    mask = mask.to(torch.bool)
    seed = torch.arange(1, mask.numel() + 1, dtype=torch.int32,
                        device=mask.device).reshape(mask.shape)
    inf = torch.full_like(seed, _INF)
    labels = torch.where(mask, seed, inf)
    changed = True
    it = 0
    while changed and it < max_iters:
        new = labels
        for _ in range(sweeps_per_check):
            new = torch.where(mask, torch.minimum(new, _min_pool_3x3x3(new)),
                              inf)
        changed = bool((new != labels).any())
        labels = new
        it += 1
    out = torch.where(mask, labels, torch.zeros_like(labels))
    if return_converged:
        return out, not changed
    return out


def per_voxel_component_size(labels: torch.Tensor) -> torch.Tensor:
    """Size of each voxel's component (0 for background voxels), int32."""
    flat = labels.reshape(-1).to(torch.int64)
    counts = torch.bincount(flat, minlength=labels.numel() + 1)
    counts[0] = 0
    return counts[flat].to(torch.int32).reshape(labels.shape)


def filter_small_components(mask: torch.Tensor, min_size: int = 7,
                            max_iters: int = 1024,
                            return_converged: bool = False
                            ) -> Union[torch.Tensor, Tuple[torch.Tensor, bool]]:
    """Remove 26-connected components with <= ``min_size`` voxels.
    mask: (S, H, W) -> float32 0/1 (plus the convergence bool of
    ``connected_components_3d`` with ``return_converged``)."""
    m = mask.to(torch.bool)
    labels, converged = connected_components_3d(
        m, max_iters, return_converged=True)
    keep = per_voxel_component_size(labels) > min_size
    out = (m & keep).to(torch.float32)
    if return_converged:
        return out, converged
    return out
