"""Procedural brain-phantom dataset (fixtures, benchmarks, smoke tests).

No reference equivalent — the reference assumed downloaded BrainWeb/MS data.
This module generates deterministic 3-D head phantoms with tissue-like
intensity structure, optional bright MS-like lesions with ground-truth
masks, and exposes the SAME dataset API as the real loaders
(`slices`/`brainmasks`/`patients`/`load_volume_and_groundtruth`/
`num_batches`), so the full train->eval pipeline runs hermetically.

Volumes are (H, W, D) with axial slices indexed by the last axis, matching
the NII axial view convention (`utils/NII.py:9`).

Copy of `unsupervised_anomaly_detection_brain_mri_tpu/data/synthetic.py`
for the port: only the import paths differ.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.preprocess import (
    normalize_volume,
    resize_slice,
)


@dataclasses.dataclass
class SyntheticOptions:
    numPatients: int = 10
    withLesions: bool = False
    imageSize: int = 64  # H = W of generated axial slices
    numSlices: int = 16  # D
    targetSize: int = 64  # output slice resolution (resized like the loaders)
    seed: int = 1234
    partition: Optional[Dict[str, float]] = None  # fractions per split
    sliceStart: int = 0
    sliceEnd: int = 10_000

    def __post_init__(self) -> None:
        # clamp the whole-volume sentinel so the eval pipeline's
        # shape-sanity skip (`utils/Evaluation.py:207-209`) sees a real
        # slice range
        self.sliceEnd = min(self.sliceEnd, self.numSlices)


def _ellipsoid_mask(shape: Tuple[int, int, int], center, radii) -> np.ndarray:
    H, W, D = shape
    zz, yy, xx = np.meshgrid(
        np.arange(H), np.arange(W), np.arange(D), indexing="ij")
    return (
        ((zz - center[0]) / radii[0]) ** 2
        + ((yy - center[1]) / radii[1]) ** 2
        + ((xx - center[2]) / radii[2]) ** 2
    ) <= 1.0


def make_phantom(rng: np.random.Generator, size: int, n_slices: int,
                 with_lesions: bool) -> Dict[str, np.ndarray]:
    """One head phantom: volume in [0,1], brainmask, lesion groundtruth."""
    H = W = size
    D = n_slices
    shape = (H, W, D)
    cz, cy = H / 2 + rng.normal(0, 1.5), W / 2 + rng.normal(0, 1.5)
    cx = D / 2
    radii = (H * 0.38 + rng.normal(0, 1.0),
             W * 0.32 + rng.normal(0, 1.0),
             D * 0.45)
    brain = _ellipsoid_mask(shape, (cz, cy, cx), radii)

    # tissue base: white matter plateau + darker ventricles + cortical rim
    vol = np.zeros(shape, np.float32)
    vol[brain] = 0.55
    vent = _ellipsoid_mask(
        shape, (cz, cy, cx), (radii[0] * 0.25, radii[1] * 0.3, radii[2] * 0.5))
    vol[vent & brain] = 0.25
    rim = brain & ~_ellipsoid_mask(
        shape, (cz, cy, cx), (radii[0] * 0.9, radii[1] * 0.9, radii[2] * 0.95))
    vol[rim] = 0.7

    # smooth intensity non-uniformity + speckle noise
    low = rng.normal(0, 1, (5, 5, 3)).astype(np.float32)
    reps = (int(np.ceil(H / 5)), int(np.ceil(W / 5)), int(np.ceil(D / 3)))
    field = np.kron(low, np.ones(reps, np.float32))[:H, :W, :D]
    vol *= (1.0 + 0.08 * field)
    vol += rng.normal(0, 0.02, shape).astype(np.float32)
    vol = np.clip(vol, 0, None) * brain

    gt = np.zeros(shape, np.float32)
    if with_lesions:
        n_lesions = int(rng.integers(1, 5))
        for _ in range(n_lesions):
            while True:
                c = (rng.uniform(0.3, 0.7) * H, rng.uniform(0.3, 0.7) * W,
                     rng.uniform(0.25, 0.75) * D)
                r = (rng.uniform(2.0, max(3.0, H * 0.06)),
                     rng.uniform(2.0, max(3.0, W * 0.06)),
                     rng.uniform(1.5, max(2.0, D * 0.12)))
                lesion = _ellipsoid_mask(shape, c, r) & brain & ~vent
                if lesion.sum() > 8:
                    break
            vol[lesion] = np.maximum(vol[lesion], 0.95 + rng.normal(0, 0.01))
            gt[lesion] = 1.0

    return {
        "volume": vol.astype(np.float32),
        "groundtruth": gt,
        "brainmask": brain.astype(np.float32),
        "skullmap": brain.astype(np.float32),
    }


class SYNTH:
    """Synthetic dataset with the standard loader API."""

    Options = SyntheticOptions

    def __init__(self, options: SyntheticOptions):
        self.options = options
        part = options.partition or {"TRAIN": 0.6, "VAL": 0.2, "TEST": 0.2}
        rng = np.random.default_rng(options.seed)
        self.patients: List[Dict] = []
        for i in range(options.numPatients):
            self.patients.append({
                "name": f"synth{i:03d}",
                "seed": options.seed + 1000 + i,
                "withLesions": options.withLesions,
            })
        # patient-level split
        n = len(self.patients)
        n_train = int(round(part.get("TRAIN", 0) * n)) if part.get(
            "TRAIN", 0) <= 1 else int(part["TRAIN"])
        n_val = int(round(part.get("VAL", 0) * n)) if part.get(
            "VAL", 0) <= 1 else int(part["VAL"])
        order = rng.permutation(n)
        self.split = {
            "TRAIN": [self.patients[i] for i in order[:n_train]],
            "VAL": [self.patients[i] for i in order[n_train:n_train + n_val]],
            "TEST": [self.patients[i] for i in order[n_train + n_val:]],
        }
        self._cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    # -- volume API (evaluation path) ----------------------------------

    def patients_of(self, split: str) -> List[Dict]:
        return self.split[split]

    def load_volume_and_groundtruth(self, patient: Dict):
        ph = make_phantom(
            np.random.default_rng(patient["seed"]), self.options.imageSize,
            self.options.numSlices, patient["withLesions"])
        vol = normalize_volume(ph["volume"], method="scaling",
                               upper_percentile=99.8)
        return vol, ph["groundtruth"], ph["brainmask"], ph["skullmap"]

    # -- slice API (training path) -------------------------------------

    def _build_split(self, split: str) -> Tuple[np.ndarray, np.ndarray]:
        if split in self._cache:
            return self._cache[split]
        images, masks = [], []
        o = self.options
        s0, s1 = o.sliceStart, min(o.sliceEnd, o.numSlices)
        for patient in self.split[split]:
            vol, _, brainmask, _ = self.load_volume_and_groundtruth(patient)
            for s in range(s0, s1):
                sl = vol[:, :, s]
                if sl.max() <= 0:
                    continue  # skip all-black (`dataloaders/BRAINWEB.py:131`)
                m = brainmask[:, :, s]
                if o.targetSize != o.imageSize:
                    sl = resize_slice(sl, (o.targetSize, o.targetSize))
                    m = resize_slice(m, (o.targetSize, o.targetSize),
                                     nearest=True)
                images.append(sl.astype(np.float32))
                masks.append(m.astype(np.float32))
        if images:
            arr = np.stack(images)[..., None]
            msk = np.stack(masks)
        else:
            t = o.targetSize
            arr = np.zeros((0, t, t, 1), np.float32)
            msk = np.zeros((0, t, t), np.float32)
        self._cache[split] = (arr, msk)
        return arr, msk

    def slices(self, split: str) -> np.ndarray:
        return self._build_split(split)[0]

    def brainmasks(self, split: str) -> np.ndarray:
        return self._build_split(split)[1]

    def num_batches(self, batchsize: int, split: str = "TRAIN") -> int:
        return len(self.slices(split)) // batchsize
