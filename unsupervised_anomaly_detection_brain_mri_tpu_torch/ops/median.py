"""3-D median filter (5^3): the hand-written CUDA kernel and its plain twin.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/ops/
pallas_median.py`.  Three entry points:

  * ``median_filter_3d_cuda`` launches ``csrc/median5.cu`` on a CUDA tensor
    (exact selection by element-snapping bisection over order-preserving
    uint32 keys; see the note at the top of the source);
  * ``median_filter_3d`` is the plain PyTorch version (the counterpart of
    the JAX package's XLA path, `ops/postprocess.py::median_filter_3d`): 125
    stacked views per chunk of slices and ``torch.median``;
  * ``median_filter_3d_auto`` chooses by the tensor's device: a CUDA tensor
    reaches the kernel or raises, a CPU tensor takes the plain version.

Borders are scipy's 'reflect' (numpy 'symmetric', the edge voxel repeated).
``torch.nn.functional.pad(mode="reflect")`` is numpy 'reflect' (edge not
repeated), so the plain version mirrors indices instead.

``median_select_reference`` runs the kernel's selection rule, vectorised,
on rows of 125 window values, and returns the rounds it took: the tests and
``chip_smoke.py`` hold the rule against a sort with it.  The main path
never calls it.

Each kernel launch (never a plain-version call) adds one to the trace
counter ``median_kernel`` (``utils/trace.py``), so a recorded run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import torch

from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import trace

_MAX_SLICES = 65535 * 8  # CUDA grid z limit times slices per block
_WINDOW = 125
_NEED = _WINDOW // 2 + 1  # the median is the 63rd smallest of 125


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


def _to_key(values: torch.Tensor) -> torch.Tensor:
    """float32 -> its order-preserving uint32 key, held in int64 (torch has
    no full uint32 arithmetic): negative floats flip every bit, the others
    only the sign bit, as ``to_key`` in ``csrc/median5.cu``."""
    bits = values.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    negative = bits >= 0x80000000
    return torch.where(negative, bits ^ 0xFFFFFFFF, bits ^ 0x80000000)


def _from_key(keys: torch.Tensor) -> torch.Tensor:
    bits = torch.where(keys >= 0x80000000, keys ^ 0x80000000,
                       keys ^ 0xFFFFFFFF)
    # the low 32 bits as a signed int32, then reinterpreted as float32
    signed = bits - ((bits >> 31) << 32)
    return signed.to(torch.int32).view(torch.float32)


def median_select_reference(windows: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's selection rule on an (N, 125) float32 tensor of window
    values, vectorised over N: (median (N,) float32, rounds (N,) int64).

    Keys start bracketed by the window's [min, max]; each round takes
    ``mid = lo + (hi - lo) // 2`` and, in one pass, ``c = #(key <= mid)``,
    ``below = max{key <= mid}`` and ``above = min{key > mid}``.  With
    ``c >= 63`` the median is at most ``below`` (``hi = below``; exactly
    ``below`` when ``c == 63``), else at least ``above`` (``lo = above``;
    exactly ``above`` when ``c == 62``).  Both ends snap to keys of the
    window, so each round at least halves the distinct keys left in range
    as well as the key range: at most 32 rounds, 0 for a constant window.
    """
    if windows.ndim != 2 or windows.shape[1] != _WINDOW:
        raise ValueError(f"expected (N, {_WINDOW}) windows, got "
                         f"{tuple(windows.shape)}")
    keys = _to_key(windows.to(torch.float32))
    lo = keys.min(dim=1).values
    hi = keys.max(dim=1).values
    rounds = torch.zeros_like(lo)
    beyond = torch.tensor(1 << 32, dtype=torch.int64, device=keys.device)
    while True:
        active = lo < hi
        if not bool(active.any()):
            break
        mid = lo + (hi - lo) // 2
        le = keys <= mid[:, None]
        c = le.sum(dim=1)
        below = torch.where(le, keys, -1).max(dim=1).values
        above = torch.where(le, beyond, keys).min(dim=1).values
        new_hi = torch.where(c >= _NEED, below, hi)
        new_lo = torch.where(c >= _NEED, lo, above)
        new_lo = torch.where(c == _NEED, below, new_lo)
        new_hi = torch.where(c == _NEED - 1, above, new_hi)
        lo = torch.where(active, new_lo, lo)
        hi = torch.where(active, new_hi, hi)
        rounds += active.to(torch.int64)
    return _from_key(hi), rounds


def median_filter_3d_cuda(vol: torch.Tensor) -> torch.Tensor:
    """5^3 median of a contiguous float32 (S, H, W) CUDA tensor by the
    hand-written kernel ``csrc/median5.cu``.  Raises on any other input and
    on a failed build or launch."""
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
    trace.count("median_kernel")
    return out


def median_filter_3d_auto(vol: torch.Tensor, kernel: int = 5) -> torch.Tensor:
    """The CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    if vol.is_cuda:
        if kernel != 5:
            raise ValueError(f"the CUDA median kernel is 5^3, got {kernel}")
        return median_filter_3d_cuda(vol)
    return median_filter_3d(vol, kernel)
