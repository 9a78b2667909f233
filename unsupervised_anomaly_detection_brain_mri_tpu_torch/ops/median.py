"""3-D median filter (5^3): the hand-written CUDA kernel and its plain twin.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/ops/
pallas_median.py`.  Three entry points:

  * ``median_filter_3d_cuda`` launches ``csrc/median5.cu`` on a CUDA tensor
    (exact selection by bisection over order-preserving uint32 keys; see
    the note at the top of the source);
  * ``median_filter_3d`` is the plain PyTorch version (the counterpart of
    the JAX package's XLA path, `ops/postprocess.py::median_filter_3d`): 125
    stacked views per chunk of slices and ``torch.median``;
  * ``median_filter_3d_auto`` chooses by the tensor's device: a CUDA tensor
    reaches the kernel or raises, a CPU tensor takes the plain version.

Borders are scipy's 'reflect' (numpy 'symmetric', the edge voxel repeated).
``torch.nn.functional.pad(mode="reflect")`` is numpy 'reflect' (edge not
repeated), so the plain version mirrors indices instead.

``LAUNCHES`` counts kernel launches (never plain-version calls), so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import torch

LAUNCHES = 0

_MAX_SLICES = 65535 * 4  # CUDA grid z limit times slices per block


def _mirror(i: int, n: int) -> int:
    """numpy 'symmetric' index: ... 1 0 | 0 1 ... n-1 | n-1 n-2 ..."""
    while i < 0 or i >= n:
        i = -i - 1 if i < 0 else 2 * n - 1 - i
    return i


def _symmetric_pad(vol: torch.Tensor, r: int) -> torch.Tensor:
    """Pad every axis by ``r`` with numpy 'symmetric' borders, by index
    gathers (works for any axis length >= 1)."""
    out = vol
    for axis, n in enumerate(vol.shape):
        idx = torch.tensor([_mirror(i, n) for i in range(-r, n + r)],
                           device=vol.device)
        out = out.index_select(axis, idx)
    return out


def median_filter_3d(vol: torch.Tensor, kernel: int = 5,
                     chunk: int = 16) -> torch.Tensor:
    """Exact k^3 median with 'reflect' borders, chunked over the leading
    axis to bound memory (k^3 stacked views per chunk).

    vol: (S, H, W) float32 -> (S, H, W) float32.
    """
    if kernel % 2 != 1:
        raise ValueError(f"kernel must be odd, got {kernel}")
    r = kernel // 2
    S, H, W = vol.shape
    padded = _symmetric_pad(vol.to(torch.float32), r)
    out = torch.empty((S, H, W), dtype=torch.float32, device=vol.device)
    for s0 in range(0, S, chunk):
        cs = min(chunk, S - s0)
        slab = padded[s0: s0 + cs + 2 * r]
        views = [slab[a: a + cs, b: b + H, c: c + W]
                 for a in range(kernel)
                 for b in range(kernel)
                 for c in range(kernel)]
        # k^3 is odd, so torch.median's lower median is the exact median
        out[s0: s0 + cs] = torch.stack(views, dim=-1).median(dim=-1).values
    return out


def median_filter_3d_cuda(vol: torch.Tensor) -> torch.Tensor:
    """5^3 median of a contiguous float32 (S, H, W) CUDA tensor by the
    hand-written kernel ``csrc/median5.cu``.  Raises on any other input and
    on a failed build or launch."""
    global LAUNCHES
    if not vol.is_cuda:
        raise ValueError("median_filter_3d_cuda needs a CUDA tensor; use "
                         "median_filter_3d_auto to dispatch by device")
    if vol.dtype != torch.float32 or vol.ndim != 3:
        raise ValueError(f"expected a 3-D float32 volume, got "
                         f"{vol.ndim}-D {vol.dtype}")
    if not vol.is_contiguous():
        raise ValueError("expected a contiguous volume")
    S, H, W = vol.shape
    if vol.numel() == 0 or S > _MAX_SLICES:
        raise ValueError(f"unsupported volume shape {tuple(vol.shape)}")
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops._build import (
        load_library,
    )

    lib = load_library()
    out = torch.empty_like(vol)
    with torch.cuda.device(vol.device):
        stream = torch.cuda.current_stream(vol.device).cuda_stream
        rc = lib.uad_median5_f32(vol.data_ptr(), out.data_ptr(), S, H, W,
                                 stream)
    if rc != 0:
        raise RuntimeError(f"median5 kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def median_filter_3d_auto(vol: torch.Tensor, kernel: int = 5) -> torch.Tensor:
    """The CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    if vol.is_cuda:
        if kernel != 5:
            raise ValueError(f"the CUDA median kernel is 5^3, got {kernel}")
        return median_filter_3d_cuda(vol)
    return median_filter_3d(vol, kernel)
