"""Volume wrappers: the reference NII/MINC/NRRD API over native readers.

Parity: `utils/NII.py` (view mapping, normalize, apply_skullmap, denoise,
slice get/set, subvolume export), `utils/MINC.py` (MINC delegate),
`dataloaders/NRRD.py` (min-shift-then-scale normalisation variant).

Data is float64 in (X, Y, Z) order with the default view mapping
``saggital=0, coronal=1, axial=2`` (`utils/NII.py:9`), overridable per
dataset like the reference's ``set_view_mapping``.

Copy of `unsupervised_anomaly_detection_brain_mri_tpu/data/volume.py`
for the port: only the import paths differ.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import formats

DEFAULT_VIEW_MAPPING: Dict[str, int] = {
    "saggital": 0, "coronal": 1, "axial": 2}


class NII:
    """NIfTI volume (`utils/NII.py`)."""

    def __init__(self, filename: Optional[str] = None,
                 data: Optional[np.ndarray] = None):
        if filename is not None:
            self.data, self.meta = formats.read_volume(filename)
        else:
            self.data, self.meta = np.asarray(data, np.float64), {}
        self.data = np.nan_to_num(self.data)
        self.view_mapping = dict(DEFAULT_VIEW_MAPPING)

    # -- view mapping ---------------------------------------------------

    def set_view_mapping(self, mapping: Dict[str, int]) -> None:
        self.view_mapping = dict(mapping)

    def shape(self) -> Tuple[int, ...]:
        return self.data.shape

    def num_slices_along_axis(self, axis: str) -> int:
        return self.data.shape[self.view_mapping[axis]]

    def get_slice(self, idx: int, axis: str = "axial") -> np.ndarray:
        return np.take(self.data, idx, axis=self.view_mapping[axis])

    def set_slice(self, idx: int, axis: str, values: np.ndarray) -> None:
        sl: list = [slice(None)] * self.data.ndim
        sl[self.view_mapping[axis]] = idx
        self.data[tuple(sl)] = values

    def set_subvolume(self, start: int, end: int, values: np.ndarray,
                      axis: str = "axial") -> None:
        """(`utils/NII.py:107-109`); values has slices on its FIRST axis."""
        ax = self.view_mapping[axis]
        end = min(end, self.data.shape[ax])
        moved = np.moveaxis(self.data, ax, 0)
        moved[start:end] = values[: end - start]

    # -- processing -----------------------------------------------------

    def normalize(self, method: str = "scaling",
                  lowerpercentile: Optional[float] = None,
                  upperpercentile: Optional[float] = None) -> None:
        """Percentile clamp then scale/standardize (`utils/NII.py:53-75`).
        Uses the native C++ kernel (`data/native.py`) when available."""
        if method not in ("scaling", "standardization"):
            raise ValueError(f"unknown normalization {method!r}")
        try:
            from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import (
                native,
            )

            if native.available():
                self.data = native.percentile_normalize(
                    self.data.astype(np.float32), lowerpercentile,
                    upperpercentile, method)
                return
        except Exception:
            pass
        self.data = self.data.astype(np.float32)
        if lowerpercentile is not None:
            qlow = np.percentile(self.data, lowerpercentile)
            self.data[self.data < qlow] = qlow
        if upperpercentile is not None:
            qup = np.percentile(self.data, upperpercentile)
            self.data[self.data > qup] = qup
        if method == "scaling":
            m = float(self.data.max())
            if m > 0:
                self.data = self.data / m
        else:
            self.data = (self.data - self.data.mean()) / max(
                float(self.data.std()), 1e-8)

    def apply_skullmap(self, skullmap: "NII") -> None:
        """Binarize the mask at 0.1 and multiply (`utils/NII.py:77-83`)."""
        mask = np.array(skullmap.data)
        mask[mask < 0.1] = 0
        mask[mask >= 0.1] = 1
        self.data = self.data * mask

    def denoise(self, timestep: float = 0.125, iterations: int = 3) -> None:
        """Curvature-flow-style smoothing (`utils/NII.py:85-87` used
        ``sitk.CurvatureFlow(timeStep=0.125, iters=3)``).

        Implemented as an explicit mean-curvature diffusion step; edge
        structure is preserved like the SimpleITK filter (not bit-exact to
        ITK's scheme — documented deviation, same role in the pipeline).
        """
        u = self.data.astype(np.float64)
        for _ in range(iterations):
            grads = np.gradient(u)
            mag = np.sqrt(sum(g ** 2 for g in grads)) + 1e-8
            div = sum(
                np.gradient(g / mag, axis=i) for i, g in enumerate(grads))
            u = u + timestep * mag * div
        self.data = u

    # -- export ---------------------------------------------------------

    def cast_to_float(self) -> None:
        self.data = self.data.astype(np.float32)

    def set_to_zero(self) -> None:
        self.data = self.data * 0

    def save(self, filename: str) -> None:
        """Write as NIfTI, preserving the source geometry (pixdim/affine)
        when the volume was loaded from disk (`utils/NII.py:28`)."""
        formats.write_nifti(
            filename, self.data.astype(np.float32),
            pixdim=tuple(self.meta.get("pixdim", (1.0, 1.0, 1.0))),
            affine=self.meta.get("affine"))

    def geometry(self) -> Dict:
        """Source geometry for residual re-export (`Evaluation.py:323-334`):
        original array shape, the index of each named axis, and the
        voxel->world metadata available from the header."""
        return {
            "shape": tuple(self.data.shape),
            "view_mapping": dict(self.view_mapping),
            "pixdim": tuple(self.meta.get("pixdim", (1.0, 1.0, 1.0))),
            "affine": self.meta.get("affine"),
        }


class MINC(NII):
    """MINC volume (`utils/MINC.py`): same API, native MINC read (no
    NIfTI side-car conversion needed)."""


class NRRD(NII):
    """NRRD volume (`dataloaders/NRRD.py`): normalization min-shifts before
    max-scaling (`dataloaders/NRRD.py:53-56`)."""

    def normalize(self, method: str = "scaling",
                  lowerpercentile: Optional[float] = None,
                  upperpercentile: Optional[float] = None) -> None:
        self.data = self.data.astype(np.float32)
        if lowerpercentile is not None:
            qlow = np.percentile(self.data, lowerpercentile)
            self.data[self.data < qlow] = qlow
        if upperpercentile is not None:
            qup = np.percentile(self.data, upperpercentile)
            self.data[self.data > qup] = qup
        if method == "scaling":
            self.data = self.data - self.data.min()
            m = float(self.data.max())
            if m > 0:
                self.data = self.data / m
        else:
            super().normalize(method, lowerpercentile, upperpercentile)


def open_volume(path: str) -> NII:
    p = str(path)
    if p.endswith((".mnc", ".mnc.gz")):
        return MINC(p)
    if p.endswith((".nrrd", ".nhdr")):
        return NRRD(p)
    return NII(p)
