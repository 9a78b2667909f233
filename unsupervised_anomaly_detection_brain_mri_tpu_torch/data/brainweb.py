"""BrainWeb phantom dataset loader.

Parity: `dataloaders/BRAINWEB.py` — MINC phantom volumes in
``normal/`` + ``lesions/{mild,moderate,severe}/`` folders with
per-severity crisp tissue-label groundtruth volumes in ``groundtruth/``,
skullmap derived from tissue labels, lesion label 10 binarised as GT,
per-volume normalization with 99.8 upper percentile.

Copy of `unsupervised_anomaly_detection_brain_mri_tpu/data/brainweb.py`
for the port: only the import paths differ.
"""

from __future__ import annotations

import copy
import dataclasses
import glob
import os
from typing import Any, Dict, List, Tuple

import numpy as np

from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.base import (
    BaseDataset,
    BaseOptions,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.volume import MINC, NII

LABELS = {"BACKGROUND": 0, "CSF": 1, "GM": 2, "WM": 3, "FAT": 4,
          "MUSCLE": 5, "SKIN": 6, "SKULL": 7, "GLIALMATTER": 8,
          "CONNECTIVE": 9, "LESION": 10}
PROTOCOL_MAPPINGS = {"FLAIR": "flair*", "T2": "t2*"}
FILTER_TYPES = ("NORMAL", "MILDMS", "MODERATEMS", "SEVEREMS")
VIEW_MAPPING = {"saggital": 0, "coronal": 1, "axial": 2}

_GT_FILES = {
    "NORMAL": "normal.mnc.gz",
    "MILDMS": "mild_lesions.mnc.gz",
    "MODERATEMS": "moderate_lesions.mnc.gz",
    "SEVEREMS": "severe_lesions.mnc.gz",
}


@dataclasses.dataclass
class BrainwebOptions(BaseOptions):
    folderNormal: str = "normal"
    folderMildMS: str = os.path.join("lesions", "mild")
    folderModerateMS: str = os.path.join("lesions", "moderate")
    folderSevereMS: str = os.path.join("lesions", "severe")
    folderGT: str = "groundtruth"
    sliceStart: int = 20
    sliceEnd: int = 140


class BRAINWEB(BaseDataset):
    name = "BRAINWEB"
    options_cls = BrainwebOptions
    Options = BrainwebOptions

    def _get_patients(self) -> List[Dict[str, Any]]:
        o = self.options
        folder_types = [
            (o.folderNormal, "NORMAL"), (o.folderMildMS, "MILDMS"),
            (o.folderModerateMS, "MODERATEMS"),
            (o.folderSevereMS, "SEVEREMS")]
        patients = []
        for folder, _type in folder_types:
            if o.filterType and _type not in o.filterType:
                continue
            if o.filterProtocol:
                protos = ([o.filterProtocol] if isinstance(
                    o.filterProtocol, str) else list(o.filterProtocol))
                patterns = [PROTOCOL_MAPPINGS[p] + ".mnc.gz"
                            for p in protos]
            else:
                patterns = ["*.mnc.gz"]
            for pattern in patterns:
                for fname in sorted(glob.glob(
                        os.path.join(o.dir, folder, pattern))):
                    patients.append({
                        "name": os.path.basename(fname),
                        "type": _type,
                        "fullpath": fname,
                        "filtered_files": [fname],
                        "groundtruth_filename": os.path.join(
                            o.dir, o.folderGT, _GT_FILES[_type]),
                    })
        return patients

    def load_volumes(self, patient: Dict[str, Any],
                     filename: str = None) -> Tuple[NII, NII, NII]:
        """(`dataloaders/BRAINWEB.py:255-298`).  BrainWeb patients carry a
        single volume; ``filename`` is accepted for interface parity."""
        o = self.options
        minc = MINC(patient["fullpath"])
        minc.set_view_mapping(VIEW_MAPPING)
        minc_seg = MINC(patient["groundtruth_filename"])
        minc_seg.set_view_mapping(VIEW_MAPPING)
        skullmap = copy.deepcopy(minc_seg)
        skullmap.data = skullmap.data * 0.0 + 1.0

        if o.skullRemoval:
            for lbl in ("FAT", "MUSCLE", "SKIN", "SKULL", "CONNECTIVE"):
                skullmap.data[minc_seg.data == LABELS[lbl]] = 0
        if o.backgroundRemoval:
            skullmap.data[minc_seg.data == LABELS["BACKGROUND"]] = 0

        lesion = minc_seg.data == LABELS["LESION"]
        minc_seg.data = lesion.astype(np.float64)

        if o.skullRemoval or o.backgroundRemoval:
            minc.apply_skullmap(skullmap)
        minc.normalize(method=o.normalizationMethod, lowerpercentile=0.0,
                       upperpercentile=99.8)
        return minc, minc_seg, skullmap
