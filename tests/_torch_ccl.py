"""Test data and an independent oracle for the port's connected components
(imports no JAX, so the card's tests can use it)."""

import numpy as np
from scipy import ndimage as ndi


def min_index_labels(mask):
    """SciPy's 26-connected ``ndimage.label`` of each volume of a
    (..., S, H, W) bool mask, renamed to the port's definition: 0 for
    background, else 1 + the flat index (within its volume) of the
    component's minimal voxel."""
    mask = np.asarray(mask, bool)
    vols = mask.reshape((-1,) + mask.shape[-3:])
    out = np.zeros(vols.shape, np.int32)
    for v, m in enumerate(vols):
        lab, n = ndi.label(m, structure=np.ones((3, 3, 3), bool))
        if n == 0:
            continue
        flat = np.arange(m.size).reshape(m.shape)
        first = np.asarray(ndi.minimum(flat, lab, np.arange(1, n + 1)),
                           np.int64)
        out[v] = np.where(lab > 0, 1 + first[lab - 1], 0)
    return out.reshape(mask.shape)


def lesion_blobs(shape, seed, level=2.2):
    """Smooth blobs of a few to a few thousand voxels, a residual map's
    lesions above a threshold: a Gaussian-smoothed normal field, scaled to
    unit spread, above ``level``."""
    field = ndi.gaussian_filter(
        np.random.default_rng(seed).standard_normal(shape), 2.0)
    return field / field.std() > level
