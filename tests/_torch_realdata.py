"""Real-format cohorts for the port's real-data tests and ``chip_smoke.py``:
a fake BrainWeb server and MSLUB, MSISBI2015 and MSSEG2008 trees.

Imports neither JAX nor either package's volume readers: the MINC1 files
are written through scipy's NetCDF writer in the layout BrainWeb ships
(int16 in ``valid_range`` with per-slice ``image-min``/``image-max``
renormalisation for the simulated intensities, raw int16 labels for the
crisp groundtruths; zyx on disk), so a reader's fault cannot cancel a
writer's.  The MS trees are NIfTI (NRRD for MSSEG2008) through the writer
that is passed in, in each loader's naming, axial axis first.

``FakeBrainWeb`` is an opener for ``data/download.py``: it answers each
form POST with the volume its ``do_download_alias`` names, made from the
alias (phantom, noise level ``pnN``, intensity non-uniformity ``rfN``) on
one anatomy per geometry, so a download yields a BrainWeb tree whose
severe-lesion phantoms carry label 10 in their groundtruth.
"""

import gzip
import io
import os
import urllib.parse
import zlib

import numpy as np

# BrainWeb's tissue labels (`data/brainweb.py::LABELS`)
BACKGROUND, CSF, GM, WM, FAT, MUSCLE, SKIN, SKULL = 0, 1, 2, 3, 4, 5, 6, 7
LESION = 10
BRAINWEB_SHAPE = (181, 217, 181)  # x, y, z of the 1 mm phantoms

# lesion blobs per phantom: centres and radius in units of the half-extent
_BLOBS = {"msles1": 1, "msles2": 2, "msles3": 3}
_CENTRES = ((-0.2, 0.1, 0.05), (0.15, -0.15, -0.1), (0.05, 0.2, 0.15))
_T2 = {BACKGROUND: 30, CSF: 3300, GM: 1000, WM: 700, SKIN: 600, SKULL: 100,
       LESION: 2600}
_FLAIR = {BACKGROUND: 0, CSF: 200, GM: 900, WM: 700, SKIN: 500, SKULL: 100,
          LESION: 1600}


def _coords(shape):
    """Per-axis coordinates in units of the half-extent, broadcastable."""
    return [((np.arange(n, dtype=np.float32) - (n - 1) / 2.0)
             / (n / 2.0)).reshape([-1 if a == i else 1 for a in range(3)])
            for i, n in enumerate(shape)]


def head_labels(shape, lesions=0, jitter=None):
    """Crisp tissue labels (x, y, z): a brain ellipsoid (WM core, GM shell,
    CSF film) inside a skull and skin, background outside, and ``lesions``
    spherical blobs of label 10 inside the WM.  ``jitter`` (a numpy
    Generator) moves the blobs for another patient."""
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


def minc1_bytes(data_xyz, renormalize):
    """An uncompressed MINC1 (NetCDF) file of an (x, y, z) volume, stored
    zyx.  ``renormalize``: int16 in ``valid_range`` [0, 4095] with
    per-slice ``image-min``/``image-max`` (the simulated intensities);
    otherwise raw int16 (crisp labels)."""
    from scipy.io import netcdf_file

    zyx = np.transpose(np.asarray(data_xyz, np.float64), (2, 1, 0))
    z, y, x = zyx.shape
    buf = io.BytesIO()
    nc = netcdf_file(buf, "w")
    nc.createDimension("zspace", z)
    nc.createDimension("yspace", y)
    nc.createDimension("xspace", x)
    var = nc.createVariable("image", np.int16, ("zspace", "yspace", "xspace"))
    if renormalize:
        vmax = 4095.0
        imin = zyx.reshape(z, -1).min(axis=1)
        imax = zyx.reshape(z, -1).max(axis=1)
        span = np.where(imax > imin, imax - imin, 1.0)
        var[:] = np.round((zyx - imin[:, None, None]) / span[:, None, None]
                          * vmax).astype(np.int16)
        var._attributes["valid_range"] = np.array([0.0, vmax])
        vmin_var = nc.createVariable("image-min", np.float64, ("zspace",))
        vmin_var[:] = imin
        vmax_var = nc.createVariable("image-max", np.float64, ("zspace",))
        vmax_var[:] = imax
    else:
        var[:] = zyx.astype(np.int16)
    nc.flush()
    out = buf.getvalue()
    nc.close()
    return out


class FakeBrainWeb:
    """An opener for ``download_brainweb_dataset``: records each request
    (``requests``: (url, method, body)) and answers with the MINC1 volume
    its alias names, at ``shape`` (x, y, z).  Simulated volumes come back
    gzipped, as the server sends them with ``zip_value=gnuzip`` (level 1:
    gzip's default 9 takes seconds a volume at 181x217x181; readers take
    any level); groundtruths come back raw, so the downloader's own gzip
    is exercised too."""

    def __init__(self, shape=BRAINWEB_SHAPE):
        self.shape = tuple(shape)
        self.requests = []
        self._labels = {}

    def labels(self, phantom):
        if phantom not in self._labels:
            self._labels[phantom] = head_labels(
                self.shape, _BLOBS.get(phantom, 0))
        return self._labels[phantom]

    def payload(self, alias):
        if alias.startswith("phantom_1.0mm_"):
            phantom = alias[len("phantom_1.0mm_"):-len("_crisp")]
            return minc1_bytes(self.labels(phantom), renormalize=False)
        _, _, phantom, _, noise, inu = alias.split("_")
        rng = np.random.default_rng(zlib.crc32(alias.encode()))
        vol = intensity(self.labels(phantom), _T2, rng,
                        noise_pct=float(noise[2:]), inu_pct=float(inu[2:]))
        return gzip.compress(minc1_bytes(vol, renormalize=True), 1)

    def __call__(self, req):
        self.requests.append((req.full_url, req.get_method(), req.data))
        alias = urllib.parse.parse_qs(req.data.decode())[
            "do_download_alias"][0]
        return io.BytesIO(self.payload(alias))


def _ms_patient(shape_xyz, seed, table):
    """(volume, lesion mask, brainmask) of one MS patient, axial axis
    first: (z, y, x)."""
    rng = np.random.default_rng(seed)
    lab = head_labels(shape_xyz, 3, jitter=rng)
    vol = intensity(lab, table, rng, noise_pct=2.0)
    brain = np.isin(lab, (CSF, GM, WM, LESION))
    return [np.transpose(a.astype(np.float32), (2, 1, 0))
            for a in (vol, lab == LESION, brain)]


def _write_nifti_gz(write_nifti, path, data):
    """``write_nifti`` to ``path`` without its ``.gz``, then gzipped at
    level 1, as ``FakeBrainWeb`` gzips."""
    raw = path[:-len(".gz")]
    write_nifti(raw, data)
    with open(raw, "rb") as f:
        blob = gzip.compress(f.read(), 1)
    with open(path, "wb") as f:
        f.write(blob)
    os.remove(raw)


def mslub_tree(root, write_nifti, n, shape=BRAINWEB_SHAPE, seed=0):
    """MSLUB's layout: ``data/<name>/<name>_FLAIR.nii.gz`` with
    ``_consensus_gt`` and ``_brainmask``, for ``n`` patients."""
    for i in range(n):
        name = f"patient{i + 1:02d}"
        d = os.path.join(root, "data", name)
        os.makedirs(d, exist_ok=True)
        vol, gt, brain = _ms_patient(shape, seed + i, _FLAIR)
        for suffix, a in (("FLAIR", vol), ("consensus_gt", gt),
                          ("brainmask", brain)):
            _write_nifti_gz(write_nifti,
                            os.path.join(d, f"{name}_{suffix}.nii.gz"), a)


def msisbi2015_tree(root, write_nifti, n, shape=BRAINWEB_SHAPE, seed=100,
                    protocols=("flair",)):
    """MSISBI2015's raw layout: ``trainingNN/preprocessed/
    trainingNN_TT_<proto>_pp.nii`` with ``masks/trainingNN_TT_mask1.nii``
    and ``preprocessed/trainingNN_TT_skullmap.nii.gz``, ``n`` patients
    (time points) spread over the five training folders."""
    for i in range(n):
        folder = f"training{i % 5 + 1:02d}"
        name = f"{folder}_{i // 5 + 1:02d}"
        pre = os.path.join(root, folder, "preprocessed")
        masks = os.path.join(root, folder, "masks")
        os.makedirs(pre, exist_ok=True)
        os.makedirs(masks, exist_ok=True)
        vol, gt, brain = _ms_patient(shape, seed + i, _FLAIR)
        for k, proto in enumerate(protocols):
            write_nifti(os.path.join(pre, f"{name}_{proto}_pp.nii"),
                        vol * (1.0 + 0.1 * k))
        write_nifti(os.path.join(masks, f"{name}_mask1.nii"), gt)
        _write_nifti_gz(write_nifti,
                        os.path.join(pre, f"{name}_skullmap.nii.gz"), brain)


def msseg2008_tree(root, write_nrrd, n, shape=(40, 40, 40), seed=200):
    """MSSEG2008's raw layout: ``train_part1/<name>/<name>_FLAIR.nhdr``
    with ``_lesion`` and ``_skullmap``, ``n`` patients."""
    for i in range(n):
        name = f"UNC_train_Case{i + 1:02d}"
        d = os.path.join(root, "train_part1", name)
        os.makedirs(d, exist_ok=True)
        vol, gt, brain = _ms_patient(shape, seed + i, _FLAIR)
        for suffix, a in (("FLAIR", vol), ("lesion", gt),
                          ("skullmap", brain)):
            write_nrrd(os.path.join(d, f"{name}_{suffix}.nhdr"), a)
