"""26-connected components on the card: the hand-written CUDA chain.

``csrc/ccl3d.cu`` labels a contiguous bool/uint8 mask of shape
(..., S, H, W), each volume of the leading axes on its own, by lock-free
union-find in a fixed chain of launches (init, merge, compress, and the
size filter after a zeroing of the counts) that never reads anything back
to the host; see the note at the top of the source.  The
labels are those of ``ops/postprocess.py``'s propagation at its fixpoint:
0 for background, else 1 + the flat index (within its volume) of the
component's minimal voxel.  The plain version, and the dispatch by the
tensor's device, live in ``ops/postprocess.py``.

Each call of the chain (never a plain-version call) adds one to the trace
counter ``cc_kernel`` (``utils/trace.py``), so a recorded run can show that
its components went through the kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import trace

_MAX_VOLUMES = 65535  # CUDA grid y limit: one grid row a volume
_MAX_VOXELS = 2 ** 31 - 1  # a volume's flat indices and labels are int32


def _run(mask: torch.Tensor, min_size: Optional[int]):
    """(labels int32, the float32 0/1 mask of the components of more than
    ``min_size`` voxels or None) by the kernel chain."""
    if not mask.is_cuda:
        raise ValueError("the CUDA components need a CUDA tensor; "
                         "ops/postprocess.py dispatches by device")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"expected a bool or uint8 mask, got {mask.dtype}")
    if mask.ndim < 3:
        raise ValueError(f"expected (..., S, H, W), got {mask.ndim}-D")
    if not mask.is_contiguous():
        raise ValueError("expected a contiguous mask")
    S, H, W = mask.shape[-3:]
    n_vol = math.prod(mask.shape[:-3])
    if S * H * W >= _MAX_VOXELS or n_vol > _MAX_VOLUMES:
        raise ValueError(f"unsupported mask shape {tuple(mask.shape)}: a "
                         f"volume's voxels must fit in int32 and the "
                         f"volumes number at most {_MAX_VOLUMES}")
    labels = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    out = None
    if min_size is not None:
        out = torch.empty(mask.shape, dtype=torch.float32,
                          device=mask.device)
    if mask.numel() == 0:
        return labels, out
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops._build import (
        load_library,
    )

    lib = load_library()
    sizes = None
    if min_size is not None:
        sizes = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        rc = lib.uad_ccl3d(mask.data_ptr(), labels.data_ptr(),
                           None if sizes is None else sizes.data_ptr(),
                           None if out is None else out.data_ptr(),
                           n_vol, S, H, W,
                           0 if min_size is None else min_size, stream)
    if rc != 0:
        raise RuntimeError(f"ccl3d kernel launch failed: CUDA error {rc}")
    trace.count("cc_kernel")
    return labels, out


def connected_components_3d_cuda(mask: torch.Tensor) -> torch.Tensor:
    """int32 labels of a contiguous bool/uint8 (..., S, H, W) CUDA mask.
    Raises on any other input and on a failed build or launch."""
    return _run(mask, None)[0]


def filter_small_components_cuda(mask: torch.Tensor, min_size: int
                                 ) -> torch.Tensor:
    """float32 0/1 mask of the components of a contiguous bool/uint8
    (..., S, H, W) CUDA mask with more than ``min_size`` voxels.  Raises on
    any other input and on a failed build or launch."""
    return _run(mask, int(min_size))[1]
