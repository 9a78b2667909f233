"""Sharded volume post-processing: the halo-exchange 5^3 median.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/parallel/
distributed_eval.py`.  The slice axis of a volume is split over the data
group, each rank holding S/n contiguous slices by its data index (the
ranks of one model group hold the same shard).  The 5^3 median needs two
slices beyond each end of a shard: each rank receives them from its
neighbours (``shift_right``/``shift_left``), and the ranks at the volume's
ends take the reversed edge slices instead, numpy 'symmetric' as the
whole-volume median pads.  The (S/n + 4, H, W) slab goes through
``median_filter_3d_auto`` (the CUDA kernel ``csrc/median5.cu`` on the card,
the plain version on the CPU) and slices ``[2:-2]`` are kept.

The crop makes the result exact: the kernel mirrors the slab at its own
ends along S, but the mirrored slices reach only the slab's first and last
two output slices, which are dropped; H and W mirror as on one device.  So
the shards are bit-equal to the whole volume's median, for 4 extra slices
of work per rank.
"""

from __future__ import annotations

import torch

from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops.median import (
    median_filter_3d_auto,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.collectives import (
    shift_left,
    shift_right,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.mesh import (
    MeshContext,
)


def sharded_median_filter_3d(ctx: MeshContext, local: torch.Tensor,
                             kernel: int = 5) -> torch.Tensor:
    """The k^3 median of this rank's (S/n, H, W) shard of a volume whose
    slice axis is split over the data group in data-index order
    (``ctx.shard_batch`` of the volume, which raises unless n divides S).
    Each shard must hold at least ``kernel // 2`` slices."""
    r = kernel // 2
    if local.ndim != 3:
        raise ValueError(f"expected an (S/n, H, W) shard, got "
                         f"{tuple(local.shape)}")
    if local.shape[0] < r:
        raise ValueError(f"shard of {local.shape[0]} slices < halo {r}")
    # the left neighbour's last r slices, the right neighbour's first r
    from_left = shift_right(ctx, local[-r:])
    from_right = shift_left(ctx, local[:r])
    left = local[:r].flip(0) if ctx.data_index == 0 else from_left
    right = (local[-r:].flip(0) if ctx.data_index == ctx.n_data - 1
             else from_right)
    slab = torch.cat([left, local, right]).contiguous()
    return median_filter_3d_auto(slab, kernel)[r:slab.shape[0] - r]
