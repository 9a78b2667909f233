"""MS-lesion dataset loaders: MSISBI2015, MSLUB, MSSEG2008.

Parity:
  * `dataloaders/MSISBI2015.py` — ISBI-2015 challenge layout:
    ``training0x/preprocessed/*_flair_pp.nii`` (raw) or ``*.aligned.nii.gz``
    (aligned), GT ``masks/<name>_mask1.nii``, skullmap
    ``preprocessed/<name>_skullmap.nii.gz``; denoise + NaN cleanup + GT
    binarize at 0.9 + skull-strip + normalize 0/99.8; empty-slice rule =
    90th percentile < 0.2; view mapping axial=0.
  * `dataloaders/MSLUB.py` — Ljubljana layout: ``data/<patient>/`` with
    ``<name>_FLAIR.nii.gz`` etc., consensus GT ``_consensus_gt``,
    brainmask ``_brainmask``.
  * `dataloaders/MSSEG2008.py` — MICCAI08 layout: ``{train,test1}_partX``
    folders under UNC/CHB roots, ``<name>_<PROTO>.nhdr`` raw (NRRD) or
    ``.aligned.nii.gz``, GT ``_lesion``, skullmap ``_skullmap``.

Copy of `unsupervised_anomaly_detection_brain_mri_tpu/data/ms_datasets.py`
for the port: only the import paths differ.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.base import (
    BaseDataset,
    BaseOptions,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.volume import (
    NII,
    open_volume,
)

MS_VIEW_MAPPING = {"saggital": 2, "coronal": 1, "axial": 0}


@dataclasses.dataclass
class MSOptions(BaseOptions):
    sliceStart: int = 0
    sliceEnd: int = 155
    format: str = "raw"  # raw | aligned


class _MSBase(BaseDataset):
    """Shared MS-dataset behaviour: denoised NII volumes, binarized GT,
    percentile slice filter, pad-then-zoom resize."""

    options_cls = MSOptions
    Options = MSOptions

    def keep_slice(self, slice_data: np.ndarray) -> bool:
        # (`MSISBI2015.py:156-157`)
        return float(np.percentile(slice_data, 90)) >= 0.2

    def resize_mode(self) -> str:
        return "pad_then_zoom"

    def load_volumes(self, patient: Dict[str, Any],
                     filename: str = None) -> Tuple[NII, NII, NII]:
        # (`MSISBI2015.py:225-254`)
        o = self.options
        nii = open_volume(filename or patient["filtered_files"][0])
        nii.denoise()
        nii.set_view_mapping(MS_VIEW_MAPPING)
        nii.data = np.nan_to_num(nii.data)

        seg = open_volume(patient["groundtruth"])
        seg.set_view_mapping(MS_VIEW_MAPPING)
        seg.data = np.where(seg.data < 0.9, 0.0, 1.0)

        skullmap = None
        if o.skullStripping and os.path.exists(patient.get("skullmap", "")):
            skullmap = open_volume(patient["skullmap"])
            skullmap.set_view_mapping(MS_VIEW_MAPPING)
            nii.apply_skullmap(skullmap)
        if skullmap is None:
            skullmap = NII(data=(nii.data > 0).astype(np.float64))
            skullmap.set_view_mapping(MS_VIEW_MAPPING)

        nii.normalize(method=o.normalizationMethod, lowerpercentile=0,
                      upperpercentile=99.8)
        return nii, seg, skullmap


class MSISBI2015(_MSBase):
    name = "MSISBI2015"
    PROTOCOL_MAPPINGS = {"FLAIR": ["flair"], "MPRAGE": ["mprage"],
                         "PD": ["pd"], "T2": ["t2"]}

    def _get_patients(self) -> List[Dict[str, Any]]:
        o = self.options
        folders = [f"training{i:02d}" for i in range(1, 6)]
        protos = list(o.filterProtocol or [])
        patients = []
        for folder in folders:
            pattern = os.path.join(o.dir, folder, "preprocessed",
                                   folder + "_*_flair_pp.nii")
            for pname in sorted(glob.glob(pattern)):
                name = os.path.basename(pname).replace("_flair_pp.nii", "")
                base = os.path.join(o.dir, folder, "preprocessed")
                patient: Dict[str, Any] = {
                    "name": name,
                    "fullpath": base,
                    "filtered_files": [],
                }
                for proto, arr in self.PROTOCOL_MAPPINGS.items():
                    if protos and proto not in protos:
                        continue
                    if o.format == "raw":
                        f = os.path.join(base, f"{name}_{arr[0]}_pp.nii")
                    else:
                        f = os.path.join(
                            base, f"{name}_{arr[0]}.aligned.nii.gz")
                    patient[proto] = f
                    patient["filtered_files"].append(f)
                if o.format == "raw":
                    patient["groundtruth"] = os.path.join(
                        o.dir, folder, "masks", f"{name}_mask1.nii")
                    patient["skullmap"] = os.path.join(
                        base, f"{name}_skullmap.nii.gz")
                else:
                    patient["groundtruth"] = os.path.join(
                        base, f"{name}_mask1.aligned.nii.gz")
                    patient["skullmap"] = os.path.join(
                        base, f"{name}_skullmap.aligned.nii.gz")
                patients.append(patient)
        return patients


class MSLUB(_MSBase):
    name = "MSLUB"
    PROTOCOL_MAPPINGS = {"FLAIR": ["FLAIR"], "T1": ["T1W"],
                         "TWKS": ["T1WKS"], "T2": ["T2W"]}

    def _get_patients(self) -> List[Dict[str, Any]]:
        o = self.options
        root = os.path.join(o.dir, "data")
        if not os.path.isdir(root):
            return []
        protos = list(o.filterProtocol or [])
        patients = []
        for entry in sorted(os.scandir(root), key=lambda e: e.name):
            if not entry.is_dir():
                continue
            name = entry.name
            full = entry.path
            patient: Dict[str, Any] = {
                "name": name, "fullpath": full, "filtered_files": []}
            for proto, arr in self.PROTOCOL_MAPPINGS.items():
                if protos and proto not in protos:
                    continue
                if o.format == "raw":
                    f = os.path.join(full, f"{name}_{arr[0]}.nii.gz")
                else:
                    f = os.path.join(full,
                                     f"{name}_{arr[0]}.aligned.nii.gz")
                patient[proto] = f
                patient["filtered_files"].append(f)
            if o.format == "raw":
                patient["groundtruth"] = os.path.join(
                    full, f"{name}_consensus_gt.nii.gz")
                patient["skullmap"] = os.path.join(
                    full, f"{name}_brainmask.nii.gz")
            else:
                patient["groundtruth"] = os.path.join(
                    full, f"{name}_consensus_gt.aligned.nii.gz")
                patient["skullmap"] = os.path.join(
                    full, f"{name}_brainmask.aligned.nii.gz")
            patients.append(patient)
        return patients


@dataclasses.dataclass
class MSSEG2008Options(MSOptions):
    folderTrainUNC: str = "train_part1"
    folderTestUNC: str = "test1_part1"
    folderTrainCHB: str = "train_part2"
    folderTestCHB: str = "test1_part2"
    filterScanner: Optional[Sequence[str]] = None  # UNC | CHB


class MSSEG2008(_MSBase):
    name = "MSSEG2008"
    options_cls = MSSEG2008Options
    Options = MSSEG2008Options
    PROTOCOLS = ("FLAIR", "T1", "T2")

    def _get_patients(self) -> List[Dict[str, Any]]:
        o = self.options
        folders = [o.folderTrainUNC, o.folderTestUNC, o.folderTrainCHB,
                   o.folderTestCHB]
        protos = list(o.filterProtocol or [])
        patients = []
        for folder in folders:
            root = os.path.join(o.dir, folder)
            if not os.path.isdir(root):
                continue
            for entry in sorted(os.scandir(root), key=lambda e: e.name):
                if not entry.is_dir():
                    continue
                name = entry.name
                if o.filterScanner and not any(
                        s in name for s in o.filterScanner):
                    continue
                patient: Dict[str, Any] = {
                    "name": name, "fullpath": entry.path,
                    "filtered_files": []}
                for proto in self.PROTOCOLS:
                    if protos and proto not in protos:
                        continue
                    if o.format == "raw":
                        f = os.path.join(entry.path, f"{name}_{proto}.nhdr")
                    else:
                        f = os.path.join(entry.path,
                                         f"{name}_{proto}.aligned.nii.gz")
                    patient[proto] = f
                    patient["filtered_files"].append(f)
                if o.format == "raw":
                    patient["groundtruth"] = os.path.join(
                        entry.path, f"{name}_lesion.nhdr")
                    patient["skullmap"] = os.path.join(
                        entry.path, f"{name}_skullmap.nhdr")
                else:
                    patient["groundtruth"] = os.path.join(
                        entry.path, f"{name}_lesion.aligned.nii.gz")
                    # NO .aligned infix, unlike the volumes/lesion — the
                    # reference names it this way too (`MSSEG2008.py:319`)
                    patient["skullmap"] = os.path.join(
                        entry.path, f"{name}_skullmap.nii.gz")
                patients.append(patient)
        return patients
