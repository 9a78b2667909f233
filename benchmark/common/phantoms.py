"""The traffic's data, made from the seed: healthy slices for training and
raw scans for serving.

Copies of the port's procedural generators, so that the benchmark's
inputs do not move when the program changes:

  * ``make_phantom`` is ``data/synthetic.py::make_phantom`` of the port
    (and of the JAX package), with its ellipsoids computed by broadcasting
    instead of a full ``meshgrid``: the same values, several times faster;
  * ``normalize_volume`` is ``data/preprocess.py::normalize_volume``'s
    scaling path (99.8th-percentile clamp, divided by the maximum), which
    the synthetic loader applies to each volume;
  * ``head_labels`` and ``intensity`` are ``tests/_torch_realdata.py``'s
    BrainWeb-geometry head (181 x 217 x 181 at 1 mm: WM core, GM shell,
    CSF film, skull, skin, up to three lesion blobs of label 10) and its
    intensity model with the FLAIR table.

Each volume draws from its own child of ``SeedSequence(seed)``, so the
volumes can be made by a few threads and still come out the same.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np

THREADS = 4

# ---------------------------------------------------------------------------
# training slices: the synthetic phantom


def _ellipsoid_mask(shape: Tuple[int, int, int], center, radii) -> np.ndarray:
    H, W, D = shape
    zz = np.arange(H).reshape(H, 1, 1)
    yy = np.arange(W).reshape(1, W, 1)
    xx = np.arange(D).reshape(1, 1, D)
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

    vol = np.zeros(shape, np.float32)
    vol[brain] = 0.55
    vent = _ellipsoid_mask(
        shape, (cz, cy, cx), (radii[0] * 0.25, radii[1] * 0.3, radii[2] * 0.5))
    vol[vent & brain] = 0.25
    rim = brain & ~_ellipsoid_mask(
        shape, (cz, cy, cx), (radii[0] * 0.9, radii[1] * 0.9, radii[2] * 0.95))
    vol[rim] = 0.7

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


def normalize_volume(vol: np.ndarray, upper_percentile: float = 99.8
                     ) -> np.ndarray:
    """Percentile clamp, then division by the maximum (the loaders'
    ``scaling``)."""
    v = np.nan_to_num(vol.astype(np.float32))
    v = np.clip(v, None, np.percentile(v, upper_percentile))
    m = v.max()
    return v / m if m > 0 else v


def _children(seed: int, n: int) -> List[np.random.Generator]:
    return [np.random.default_rng(s)
            for s in np.random.SeedSequence(seed).spawn(n)]


def training_pool(seed: int, volumes: int, size: int, slices: int
                  ) -> np.ndarray:
    """``volumes`` healthy phantoms of ``size`` x ``size`` x ``slices``,
    each normalised: every axial slice, as (volumes * slices, size, size,
    1) float32, volume by volume."""
    def one(rng):
        ph = make_phantom(rng, size, slices, False)
        return np.transpose(normalize_volume(ph["volume"]), (2, 0, 1))

    with ThreadPoolExecutor(THREADS) as pool:
        vols = list(pool.map(one, _children(seed, volumes)))
    return np.concatenate(vols)[..., None].astype(np.float32)


# ---------------------------------------------------------------------------
# served scans: BrainWeb's geometry

BACKGROUND, CSF, GM, WM, FAT, MUSCLE, SKIN, SKULL = 0, 1, 2, 3, 4, 5, 6, 7
LESION = 10
_CENTRES = ((-0.2, 0.1, 0.05), (0.15, -0.15, -0.1), (0.05, 0.2, 0.15))
FLAIR = {BACKGROUND: 0, CSF: 200, GM: 900, WM: 700, SKIN: 500, SKULL: 100,
         LESION: 1600}
BRAIN = (CSF, GM, WM, LESION)


def _coords(shape):
    """Per-axis coordinates in units of the half-extent, broadcastable."""
    return [((np.arange(n, dtype=np.float32) - (n - 1) / 2.0)
             / (n / 2.0)).reshape([-1 if a == i else 1 for a in range(3)])
            for i, n in enumerate(shape)]


def head_labels(shape, lesions=0, jitter=None):
    """Crisp tissue labels (x, y, z) with ``lesions`` blobs of label 10
    inside the WM; ``jitter`` (a numpy Generator) moves the blobs."""
    u, v, w = _coords(shape)
    r = np.sqrt(u * u + v * v + w * w)
    lab = np.full(shape, BACKGROUND, np.int16)
    for radius, tissue in ((0.875, SKIN), (0.8, SKULL), (0.725, CSF),
                           (0.675, GM), (0.5, WM)):
        lab[r < radius] = tissue
    for c in _CENTRES[:lesions]:
        if jitter is not None:
            c = np.asarray(c) + jitter.uniform(-0.05, 0.05, 3)
        d = np.sqrt((u - c[0]) ** 2 + (v - c[1]) ** 2 + (w - c[2]) ** 2)
        lab[(d < 0.125) & (lab == WM)] = LESION
    return lab


def intensity(labels, table, rng, noise_pct=0.0, inu_pct=0.0):
    """Tissue intensities with a multiplicative texture, Gaussian noise of
    ``noise_pct`` % of the brightest tissue and a linear intensity
    non-uniformity of ``inu_pct`` % along the second axis."""
    vol = np.zeros(labels.shape, np.float32)
    for lbl, val in table.items():
        vol[labels == lbl] = val
    vol *= rng.uniform(0.93, 1.07, labels.shape).astype(np.float32)
    if noise_pct:
        vol += rng.normal(0.0, noise_pct / 100.0 * max(table.values()),
                          labels.shape).astype(np.float32)
    if inu_pct:
        vol *= 1.0 + inu_pct / 100.0 * _coords(labels.shape)[1] / 2.0
    return np.clip(vol, 0.0, None)


def served_scans(seed: int, shape: Sequence[int], lesions: Sequence[int],
                 noise_pct: Sequence[float], inu_pct: Sequence[float]
                 ) -> Tuple[List[np.ndarray], float, List[int]]:
    """The raw scans of a serving mix: one per entry of ``lesions`` (its
    blob count), in an order drawn from the seed, each with a noise and an
    INU level drawn from the given settings.  Returns the scans, (H, W, S)
    float32, the lesion share (lesion voxels over brain voxels, over all
    scans) and each scan's brain voxels."""
    *children, order_rng = _children(seed, len(lesions) + 1)
    order = [int(lesions[i]) for i in order_rng.permutation(len(lesions))]

    def one(args):
        n, child = args
        lab = head_labels(tuple(shape), n, jitter=child)
        vol = intensity(lab, FLAIR, child,
                        noise_pct=float(child.choice(noise_pct)),
                        inu_pct=float(child.choice(inu_pct)))
        return vol, int((lab == LESION).sum()), int(np.isin(lab, BRAIN).sum())

    with ThreadPoolExecutor(THREADS) as pool:
        made = list(pool.map(one, zip(order, children)))
    share = sum(m[1] for m in made) / max(1, sum(m[2] for m in made))
    return [m[0] for m in made], share, [m[2] for m in made]
