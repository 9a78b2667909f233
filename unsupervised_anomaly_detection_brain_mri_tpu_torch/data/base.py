"""Dataset base: patient discovery, split persistence, slice cache, batching.

Re-designs the per-dataset copy-pasted machinery of the reference
`dataloaders/{BRAINWEB,MSLUB,MSISBI2015,MSSEG2008}.py` into one base class
with per-dataset hooks.  Parity points:

  * patient-level split, persisted by NAME so reruns keep the same split
    (`dataloaders/BRAINWEB.py:86-108,480-493`); persisted as JSON (the
    reference's "OS-agnostic" pickle format, made human-readable).
  * options-derived cache key (`BRAINWEB.py:358-388`); cache payload is a
    compressed .npz of (images, labels, sets) — the TFRecord/pickle pair of
    the reference collapsed into one artifact.
  * slice gathering: slice range, emptiness filter, resize-or-pad,
    rotations, random/center/lesion crops (`BRAINWEB.py:125-194`,
    `MSISBI2015.py:140-226`).
  * `next_batch(batchsize, shuffle, set, return_brainmask)` /
    `num_batches` reference API (`BRAINWEB.py:406-478`) plus the pool API
    (`slices`/`labels`/`brainmasks`) consumed by the jitted epoch engine.

Copy of `unsupervised_anomaly_detection_brain_mri_tpu/data/base.py`
for the port: only the import paths differ.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage as ndi
from scipy.ndimage import rotate

from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.preprocess import (
    crop,
    crop_center,
    pad_to_center,
    resize_slice,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.volume import NII

SET_TYPES = ("TRAIN", "VAL", "TEST")


@dataclasses.dataclass
class BaseOptions:
    dir: str = "."
    numSamples: int = -1
    partition: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"TRAIN": 0.7, "VAL": 0.2, "TEST": 0.1})
    useCrops: bool = False
    cropType: str = "random"  # random | center | lesions
    numRandomCropsPerSlice: int = 5
    onlyPatchesWithLesions: bool = False
    rotations: Sequence[int] = (0,)
    cropWidth: int = 128
    cropHeight: int = 128
    cache: bool = True
    cacheDir: Optional[str] = None
    sliceResolution: Optional[Tuple[int, int]] = None
    addInstanceNoise: bool = False
    filterProtocol: Optional[Sequence[str]] = None
    filterType: Optional[Sequence[str]] = None
    axis: str = "axial"
    debug: bool = False
    normalizationMethod: str = "scaling"
    skullRemoval: bool = True
    backgroundRemoval: bool = False
    skullStripping: bool = True
    sliceStart: int = 20
    sliceEnd: int = 130
    format: str = "raw"
    seed: int = 42
    # Path to a reference-written TFRecord slice cache to import instead of
    # re-preprocessing (`utils/tfrecord_utils.py` format).  None = auto-
    # discover a unique `<NAME>*.tfrecord` in the dataset/cache dir.
    importTFRecord: Optional[str] = None


class BaseDataset:
    """Shared dataset machinery; subclasses implement discovery + volume
    loading."""

    name = "base"
    options_cls = BaseOptions

    def __init__(self, options: BaseOptions):
        self.options = options
        self.patients: List[Dict[str, Any]] = self._get_patients()
        if not self.patients:
            raise FileNotFoundError(
                f"{self.name}: no patients found under {options.dir}")
        self.patients_split = self._load_or_create_split()
        self._load_or_build_slices()
        self._epochs_completed = {s: 0 for s in SET_TYPES}
        self._index_in_epoch = {s: 0 for s in SET_TYPES}
        self._rng = np.random.default_rng(options.seed)

    # ------------------------------------------------------------------
    # hooks

    def _get_patients(self) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def load_volumes(self, patient: Dict[str, Any],
                     filename: Optional[str] = None
                     ) -> Tuple[NII, NII, NII]:
        """(volume, groundtruth, skullmap) as NII objects, normalized.

        ``filename`` selects one of the patient's ``filtered_files`` (the
        slice-pool gather iterates ALL of them, `MSISBI2015.py:127-132`);
        None means the patient's first/only volume."""
        raise NotImplementedError

    def keep_slice(self, slice_data: np.ndarray) -> bool:
        """Slice emptiness filter; BRAINWEB skips all-black slices
        (`BRAINWEB.py:131`), MS sets use a percentile rule."""
        return np.unique(slice_data).size > 1

    def resize_mode(self) -> str:
        """'downsample_or_pad' (BRAINWEB) or 'pad_then_zoom' (MS sets)."""
        return "downsample_or_pad"

    def brainmask_from(self, images: np.ndarray, labels: np.ndarray
                       ) -> np.ndarray:
        """Per-slice brainmask for context-encoder training; MS loaders use
        ``images > 0.05`` (`MSLUB.py:476-479`)."""
        return (images[..., 0] > 0.05).astype(np.float32)

    # ------------------------------------------------------------------
    # split persistence

    def split_path(self) -> str:
        """Split file keyed by the PATIENT SET identity (names), so the same
        cohort always reuses its split (reference behaviour,
        `BRAINWEB.py:74-76`) while different filterType/protocol cohorts get
        their own."""
        root = self.options.cacheDir or self.options.dir
        ident = hashlib.sha1("|".join(
            sorted(p["name"] for p in self.patients)).encode()
        ).hexdigest()[:10]
        return os.path.join(root, f"{self.name}_split_{ident}.json")

    def _load_or_create_split(self) -> Dict[str, List[str]]:
        path = self.split_path()
        if os.path.isfile(path):
            with open(path) as f:
                return json.load(f)
        imported = self._try_import_reference_split()
        if imported is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                json.dump(imported, f, indent=2)
            return imported
        rng = np.random.default_rng(self.options.seed)
        names = [p["name"] for p in self.patients]
        order = rng.permutation(len(names))
        split: Dict[str, List[str]] = {}
        taken = 0
        for s in SET_TYPES:
            frac = self.options.partition.get(s, 0)
            n = int(round(frac * len(names))) if frac <= 1.0 else int(frac)
            split[s] = [names[i] for i in order[taken: taken + n]]
            taken += n
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(split, f, indent=2)
        return split

    def _try_import_reference_split(self) -> Optional[Dict[str, List[str]]]:
        """Import the reference's persisted patient split so a migrating
        user keeps their exact TRAIN/VAL/TEST assignment.  The reference
        pickles ``{"TRAIN": [patient names], ...}`` as
        ``split-{TRAIN}-{VAL}[-{TEST}].pckl`` in the dataset dir
        (`BRAINWEB.py:383-385,480-493`; MS loaders use the 2-part name).
        Only that names-dict format is accepted: unpickling is done with a
        no-globals Unpickler (the format needs none), so the legacy
        index-array pickles — and anything malicious — fail closed."""
        import io
        import logging
        import pickle

        o = self.options

        def variants(v) -> List[str]:
            out = {str(v), str(float(v))}
            if float(v).is_integer():
                out.add(str(int(v)))
            return sorted(out)

        part = o.partition
        names: List[str] = []
        for t in variants(part.get("TRAIN", 0)):
            for va in variants(part.get("VAL", 0)):
                names.append(f"split-{t}-{va}.pckl")
                for te in variants(part.get("TEST", 0)):
                    names.append(f"split-{t}-{va}-{te}.pckl")
        found = [os.path.join(root, n)
                 for root in dict.fromkeys([o.dir, o.cacheDir or o.dir])
                 for n in names
                 if os.path.isfile(os.path.join(root, n))]
        if not found:
            return None

        class _NamesOnlyUnpickler(pickle.Unpickler):
            def find_class(self, module, name):  # pragma: no cover
                raise pickle.UnpicklingError(
                    f"reference split pickle needs {module}.{name}; only "
                    "the plain names-dict format is importable")

        log = logging.getLogger(__name__)
        try:
            with open(found[0], "rb") as f:
                blob = _NamesOnlyUnpickler(io.BytesIO(f.read())).load()
        except Exception as e:
            log.warning("%s: cannot import reference split %s (%s)",
                        self.name, found[0], e)
            return None
        known = {p["name"] for p in self.patients}
        split = {s: [str(n) for n in blob.get(s, [])] for s in SET_TYPES}
        matched = [n for ns in split.values() for n in ns if n in known]
        if not matched:
            log.warning(
                "%s: reference split %s names no discovered patient; "
                "ignoring it", self.name, found[0])
            return None
        log.info("%s: imported reference patient split %s (%d/%d names "
                 "match discovered patients)", self.name, found[0],
                 len(matched), sum(len(v) for v in split.values()))
        named = {n for ns in split.values() for n in ns}
        orphans = sorted(known - named)
        if orphans:
            # the split defines membership (reference semantics), so
            # unnamed patients land in NO set — say so loudly instead of
            # silently excluding data the user just added
            log.warning(
                "%s: %d discovered patient(s) not named by the imported "
                "split will be in no TRAIN/VAL/TEST set: %s%s — delete "
                "the split pickle (or the persisted JSON manifest) to "
                "re-split over all patients", self.name, len(orphans),
                ", ".join(orphans[:5]),
                ", ..." if len(orphans) > 5 else "")
        return split

    def get_patient_idx(self, split: str = "TRAIN") -> List[int]:
        return [i for i, p in enumerate(self.patients)
                if p["name"] in self.patients_split[split]]

    def patients_of(self, split: str) -> List[Dict[str, Any]]:
        return [self.patients[i] for i in self.get_patient_idx(split)]

    def get_patient_split(self) -> Dict[str, List[str]]:
        return self.patients_split

    # ------------------------------------------------------------------
    # cache

    def cache_key(self) -> str:
        o = self.options
        raw = json.dumps({
            "name": self.name, "partition": o.partition,
            "useCrops": o.useCrops, "cropType": o.cropType,
            "cropSize": [o.cropHeight, o.cropWidth],
            "cropsPerSlice": o.numRandomCropsPerSlice,
            "lesionPatches": o.onlyPatchesWithLesions,
            "cropSeed": o.seed,
            "res": o.sliceResolution, "skull": o.skullRemoval,
            "strip": o.skullStripping, "bg": o.backgroundRemoval,
            "norm": o.normalizationMethod, "axis": o.axis,
            "slices": [o.sliceStart, o.sliceEnd],
            "rot": list(o.rotations), "proto": list(o.filterProtocol or []),
            "type": list(o.filterType or []), "fmt": o.format,
            "n": o.numSamples,
            # the cached pool bakes per-slice TRAIN/VAL/TEST assignments,
            # so the patient split is part of the cache identity: deleting
            # the split manifest to re-split must NOT keep serving the old
            # assignment from cache (train/test leakage)
            "split": getattr(self, "patients_split", None),
        }, sort_keys=True)
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    def cache_path(self) -> str:
        root = self.options.cacheDir or self.options.dir
        return os.path.join(root, f"{self.name}_{self.cache_key()}.npz")

    # ------------------------------------------------------------------
    # slice gathering

    def _resize(self, slice_data: np.ndarray, slice_seg: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        res = self.options.sliceResolution
        if res is None:
            return slice_data, slice_seg
        if self.resize_mode() == "downsample_or_pad":
            # BRAINWEB: cv2 resize if too big, else centered zero-pad
            # (`BRAINWEB.py:139-154`)
            if (slice_data.shape[0] > res[0]
                    or slice_data.shape[1] > res[1]):
                slice_data = resize_slice(slice_data, res)
                slice_seg = resize_slice(slice_seg, res, nearest=True)
            else:
                slice_data = pad_to_center(slice_data, res)
                slice_seg = pad_to_center(slice_seg, res)
        else:
            # MS sets: zero-pad up, then scipy zoom, then re-binarize seg
            # (`MSISBI2015.py:159-177`)
            h, w = slice_data.shape
            if h < res[0] or w < res[1]:
                by = max((res[0] - h) // 2, 0)
                ay = max(res[0] - h - by, 0)
                bx = max((res[1] - w) // 2, 0)
                ax = max(res[1] - w - bx, 0)
                slice_data = np.pad(slice_data, ((by, ay), (bx, ax)))
                slice_seg = np.pad(slice_seg, ((by, ay), (bx, ax)))
            zf = float(res[0]) / float(slice_data.shape[0])
            if zf != 1.0:
                slice_data = ndi.zoom(slice_data, zf)
                slice_seg = ndi.zoom(slice_seg, zf, mode="nearest")
            slice_seg = np.where(slice_seg < 0.9, 0.0, 1.0)
        return slice_data.astype(np.float32), slice_seg.astype(np.float32)

    def _gather_patient(self, patient: Dict[str, Any]
                        ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Slice pool from EVERY protocol volume of the patient
        (`MSISBI2015.py:127-132` iterates all filtered_files; the eval
        path's volume reload uses only the first, matching the
        reference's `len(diffs)==0` guard at `Evaluation.py:202-204`)."""
        files = patient.get("filtered_files") or [None]
        if isinstance(files, str):
            # reference-shaped patient dicts carry a bare path string
            # (`BRAINWEB.py:240`); iterating it would gather the volume
            # once PER CHARACTER of the filename
            files = [files]
        images, labels = [], []
        for filename in files:
            imgs, labs = self._gather_volume(patient, filename)
            images.extend(imgs)
            labels.extend(labs)
        return images, labels

    def _gather_volume(self, patient: Dict[str, Any],
                       filename: Optional[str]
                       ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        o = self.options
        vol, seg, _ = self.load_volumes(patient, filename=filename)
        images, labels = [], []
        s_end = min(o.sliceEnd, vol.num_slices_along_axis(o.axis))
        for s in range(o.sliceStart, s_end):
            slice_data = np.asarray(vol.get_slice(s, o.axis), np.float32)
            slice_seg = np.asarray(seg.get_slice(s, o.axis), np.float32)
            if not self.keep_slice(slice_data):
                continue
            slice_data, slice_seg = self._resize(slice_data, slice_seg)

            for angle in o.rotations:
                if angle:
                    sd = rotate(slice_data, angle, reshape=False)
                    sg = rotate(slice_seg, angle, reshape=False,
                                mode="nearest")
                else:
                    sd, sg = slice_data, slice_seg
                if o.useCrops:
                    images_l, labels_l = self._crops(sd, sg)
                    images.extend(images_l)
                    labels.extend(labels_l)
                else:
                    images.append(sd)
                    labels.append(sg)
        return images, labels

    def _crops(self, sd: np.ndarray, sg: np.ndarray):
        o = self.options
        images, labels = [], []
        if o.cropType == "random":
            rx = self._crop_rng.integers(
                0, max(sd.shape[1] - o.cropWidth, 1),
                size=o.numRandomCropsPerSlice)
            ry = self._crop_rng.integers(
                0, max(sd.shape[0] - o.cropHeight, 1),
                size=o.numRandomCropsPerSlice)
            for r in range(o.numRandomCropsPerSlice):
                images.append(crop(sd, ry[r], rx[r], o.cropHeight,
                                   o.cropWidth))
                # deliberate fix of `BRAINWEB.py:172`: the reference
                # appended the IMAGE crop as the label
                labels.append(crop(sg, ry[r], rx[r], o.cropHeight,
                                   o.cropWidth))
        elif o.cropType == "center":
            images.append(crop_center(sd, o.cropWidth, o.cropHeight))
            labels.append(crop_center(sg, o.cropWidth, o.cropHeight))
        elif o.cropType == "lesions":
            # connected-component-centred crops (`MSISBI2015.py:194-216`)
            lab, n = ndi.label(sg > 0)
            for i in range(1, n + 1):
                ys, xs = np.where(lab == i)
                cy = int(np.clip(ys.mean(), o.cropHeight // 2,
                                 sd.shape[0] - o.cropHeight // 2))
                cx = int(np.clip(xs.mean(), o.cropWidth // 2,
                                 sd.shape[1] - o.cropWidth // 2))
                ic = crop(sd, cy - o.cropHeight // 2, cx - o.cropWidth // 2,
                          o.cropHeight, o.cropWidth)
                sc = crop(sg, cy - o.cropHeight // 2, cx - o.cropWidth // 2,
                          o.cropHeight, o.cropWidth)
                if ic.shape == (o.cropHeight, o.cropWidth):
                    images.append(ic)
                    labels.append(sc)
        else:
            raise ValueError(f"unknown cropType {o.cropType!r}")
        return images, labels

    def _load_or_build_slices(self) -> None:
        o = self.options
        path = self.cache_path()
        native_path = path.replace(".npz", ".uadc")
        if o.cache and os.path.isfile(native_path):
            from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import (
                native,
            )

            if native.available():
                images, labels, sets = native.read_cache(native_path)
                self._images = np.asarray(images)[..., None]
                self._labels = np.asarray(labels)
                self._sets = np.asarray(sets)
                return
        if o.cache and os.path.isfile(path):
            blob = np.load(path)
            self._images = blob["images"]
            self._labels = blob["labels"]
            self._sets = blob["sets"]
            return
        if self._try_import_reference_tfrecord():
            if o.cache:
                self._write_cache()  # one-time import: next load is mmap
            return
        self._crop_rng = np.random.default_rng(o.seed + 2)
        images, labels, sets = [], [], []
        for patient in self.patients:
            split_idx = None
            for i, s in enumerate(SET_TYPES):
                if patient["name"] in self.patients_split[s]:
                    split_idx = i
                    break
            if split_idx is None:
                continue
            if 0 < o.numSamples <= len(images):
                break  # quota filled — don't preprocess remaining volumes
            imgs, labs = self._gather_patient(patient)
            if 0 < o.numSamples < len(images) + len(imgs):
                imgs = imgs[: max(o.numSamples - len(images), 0)]
                labs = labs[: len(imgs)]
            images.extend(imgs)
            labels.extend(labs)
            sets.extend([split_idx] * len(imgs))
        self._images = (np.stack(images)[..., None].astype(np.float32)
                        if images else np.zeros((0, 1, 1, 1), np.float32))
        self._labels = (np.stack(labels).astype(np.float32)
                        if labels else np.zeros((0, 1, 1), np.float32))
        self._sets = np.asarray(sets, np.int32)
        if o.cache:
            self._write_cache()

    def _write_cache(self) -> None:
        path = self.cache_path()
        native_path = path.replace(".npz", ".uadc")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import (
            native,
        )

        if native.available() and len(self._images):
            # native binary cache: mmap-able on reload (zero-copy)
            native.write_cache(
                native_path, self._images[..., 0], self._labels,
                self._sets)
        else:
            np.savez_compressed(path, images=self._images,
                                labels=self._labels, sets=self._sets)

    # ------------------------------------------------------------------
    # reference TFRecord slice-cache interchange

    def _try_import_reference_tfrecord(self) -> bool:
        """Load the slice pool from a reference-written TFRecord cache
        (`utils/tfrecord_utils.py:36-52`) so a user migrating from the
        reference reuses their preprocessed caches instead of
        re-preprocessing.  Explicit ``Options.importTFRecord`` wins; else
        a UNIQUE `<NAME>*.tfrecord` in the dataset/cache dir is imported
        (several candidates = ambiguous; none is guessed).  The imported
        pool is trusted as-is — it embodies the options it was built
        with, which the filename encodes (`BRAINWEB.py:358-381`)."""
        import glob as _glob
        import logging

        o = self.options
        tfr = o.importTFRecord
        if tfr:
            if not os.path.isfile(tfr):
                raise FileNotFoundError(
                    f"importTFRecord points at a missing file: {tfr}")
        else:
            if not o.cache:  # cache=False means ignore found caches
                return False
            candidates: List[str] = []
            for root in {o.dir, o.cacheDir or o.dir}:
                candidates += _glob.glob(
                    os.path.join(root, f"{self.name}*.tfrecord"))
            # our own export_tfrecord() default names embed the options
            # cache key (`<name>_<16 hex>.tfrecord`); an export made under
            # DIFFERENT options must not satisfy the current ones, or a
            # stale export silently replaces re-preprocessing after an
            # option change.  Reference-written caches encode options in
            # the readable filename instead and never match this shape.
            own_re = re.compile(
                re.escape(self.name) + r"_[0-9a-f]{16}\.tfrecord$")
            own_key = f"{self.name}_{self.cache_key()}.tfrecord"
            stale = [c for c in candidates
                     if own_re.search(os.path.basename(c))
                     and os.path.basename(c) != own_key]
            if stale:
                logging.getLogger(__name__).info(
                    "%s: skipping TFRecord export(s) built under other "
                    "options: %s", self.name,
                    ", ".join(os.path.basename(c) for c in stale))
            candidates = sorted(set(candidates) - set(stale))
            if len(candidates) > 1:
                logging.getLogger(__name__).warning(
                    "%s: several reference TFRecord caches found (%s); "
                    "set Options.importTFRecord to pick one",
                    self.name, ", ".join(candidates))
                return False
            if not candidates:
                return False
            tfr = candidates[0]
        from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import (
            tfrecord,
        )

        # full payload CRC32C even without the native lib: this is a
        # one-time migration of training data — silent corruption here
        # poisons every later run through the write-through cache.
        try:
            images, labels, sets = tfrecord.read_tf_record(tfr, verify=True)
        except Exception as e:
            if o.importTFRecord:
                raise  # the user asked for this exact file: fail loudly
            logging.getLogger(__name__).warning(
                "%s: auto-discovered TFRecord cache %s is unreadable (%s) "
                "— falling back to preprocessing", self.name, tfr, e)
            return False
        if images.shape[0] == 0:
            # never import (and then cache) an empty pool: an interrupted
            # export would poison every subsequent run
            if o.importTFRecord:
                raise ValueError(
                    f"importTFRecord file {tfr} holds no records")
            logging.getLogger(__name__).warning(
                "%s: TFRecord cache %s holds no records — ignoring it",
                self.name, tfr)
            return False
        expect = ((o.cropHeight, o.cropWidth) if o.useCrops
                  else tuple(o.sliceResolution) if o.sliceResolution
                  else None)
        if expect and tuple(images.shape[1:3]) != expect:
            if not o.importTFRecord:
                logging.getLogger(__name__).warning(
                    "%s: TFRecord cache %s holds %dx%d slices but the "
                    "options ask for %dx%d — ignoring it (set "
                    "importTFRecord to force)",
                    self.name, tfr, images.shape[1], images.shape[2],
                    *expect)
                return False
            logging.getLogger(__name__).warning(
                "%s: TFRecord cache %s holds %dx%d slices but the options "
                "ask for %dx%d — importing anyway (importTFRecord set)",
                self.name, tfr, images.shape[1], images.shape[2], *expect)
        logging.getLogger(__name__).info(
            "%s: imported %d slices from reference TFRecord cache %s",
            self.name, images.shape[0], tfr)
        self._images = images.astype(np.float32, copy=False)
        self._labels = labels[..., 0].astype(np.float32, copy=False)
        self._sets = sets.reshape(-1).astype(np.int32, copy=False)
        return True

    def export_tfrecord(self, path: Optional[str] = None) -> str:
        """Write the in-memory slice pool as a reference-compatible
        TFRecord (`utils/tfrecord_utils.py:14-33` schema) — the reverse
        migration: caches preprocessed HERE load in the reference."""
        from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import (
            tfrecord,
        )

        if path is None:
            path = self.cache_path().replace(".npz", ".tfrecord")
        tfrecord.write_tf_record(self._images, self._labels, self._sets,
                                 path)
        return path

    # ------------------------------------------------------------------
    # pool API (jitted epoch engine)

    def _split_indices(self, split: str) -> np.ndarray:
        return np.where(self._sets == SET_TYPES.index(split))[0]

    def slices(self, split: str) -> np.ndarray:
        return self._images[self._split_indices(split)]

    def labels(self, split: str) -> np.ndarray:
        return self._labels[self._split_indices(split)]

    def brainmasks(self, split: str) -> np.ndarray:
        idx = self._split_indices(split)
        return self.brainmask_from(self._images[idx], self._labels[idx])

    # ------------------------------------------------------------------
    # reference batching API (`BRAINWEB.py:406-478`)

    def num_batches(self, batchsize: int, set: str = "TRAIN") -> int:
        return len(self._split_indices(set)) // batchsize

    def next_batch(self, batch_size: int, shuffle: bool = True,
                   set: str = "TRAIN", return_brainmask: bool = False):
        idx = self._split_indices(set)
        n = len(idx)
        start = self._index_in_epoch[set]
        if start == 0 and shuffle:
            self._order = {**getattr(self, "_order", {}),
                           set: self._rng.permutation(n)}
        order = getattr(self, "_order", {}).get(set, np.arange(n))
        if start + batch_size > n:
            self._epochs_completed[set] += 1
            rest = idx[order[start:]]
            if shuffle:
                order = self._rng.permutation(n)
                # _order may not exist yet if the epoch STARTED unshuffled
                # (start==0 branch above only creates it when shuffling)
                self._order = {**getattr(self, "_order", {}), set: order}
            new_start = batch_size - len(rest)
            self._index_in_epoch[set] = new_start
            sel = np.concatenate([rest, idx[order[:new_start]]])
        else:
            self._index_in_epoch[set] = start + batch_size
            sel = idx[order[start: start + batch_size]]
        images = self._images[sel].copy()
        labels = self._labels[sel].copy()
        if self.options.addInstanceNoise:
            images += self._rng.normal(0, 0.01, images.shape)
        assert images.size, "The batch is empty!"
        if return_brainmask:
            return images, labels, self.brainmask_from(images, labels)
        return images, labels, None

    # ------------------------------------------------------------------
    # debug helpers (`dataloaders/BRAINWEB.py:390-404`)

    def export_slices(self, out_dir: str, limit: int = 100) -> None:
        """Dump pool slices as PNGs for inspection."""
        import imageio.v2 as imageio

        os.makedirs(out_dir, exist_ok=True)
        for i in range(min(len(self._images), limit)):
            img = self._images[i, :, :, 0]
            lo, hi = img.min(), img.max()
            if hi > lo:
                img = (img - lo) / (hi - lo)
            imageio.imwrite(os.path.join(out_dir, f"slice_{i:04d}.png"),
                            (img * 255).astype(np.uint8))

    def visualize(self, pause: float = 1.0, set: str = "TRAIN") -> None:
        """Interactive patch/groundtruth browser (debug only)."""
        import matplotlib.pyplot as plt

        idx = self._split_indices(set)
        for i in idx[:10]:
            fig, (ax1, ax2) = plt.subplots(1, 2)
            ax1.imshow(self._images[i, :, :, 0], cmap="gray")
            ax1.set_title("Patch")
            ax2.imshow(self._labels[i], cmap="gray")
            ax2.set_title("Groundtruth")
            plt.pause(pause)
            plt.close(fig)

    # ------------------------------------------------------------------
    # eval API (volume arrays, axial on last axis)

    def load_volume_and_groundtruth(self, patient: Dict[str, Any]):
        """(vol, gt, brainmask, skullmap) numpy arrays with axial slices on
        axis 2, as consumed by eval/evaluate.py.

        Side effect: ``self.last_geometry`` records the source volume's
        native geometry (shape, iteration-axis index, pixdim, affine) so
        the eval driver can re-export residual volumes into the original
        scan's frame (`utils/Evaluation.py:323-334`)."""
        vol, seg, skullmap = self.load_volumes(patient)
        geo = vol.geometry()
        geo["axis_index"] = geo["view_mapping"][self.options.axis]
        self.last_geometry = geo

        def to_axial_last(a: np.ndarray, mapping) -> np.ndarray:
            return np.moveaxis(a, mapping[self.options.axis], 2)

        v = to_axial_last(np.asarray(vol.data, np.float32),
                          vol.view_mapping)
        g = to_axial_last(np.asarray(seg.data, np.float32),
                          seg.view_mapping)
        sm = to_axial_last(np.asarray(skullmap.data, np.float32),
                           skullmap.view_mapping)
        return v, g, (sm > 0).astype(np.float32), sm
