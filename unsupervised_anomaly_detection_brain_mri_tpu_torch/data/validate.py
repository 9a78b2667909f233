"""Dataset-layout validation: dry-run patient discovery with actionable
errors, BEFORE committing to a full (cache-building) dataset load.

The reference's loaders fail deep inside slice assembly when an archive is
mislaid (`dataloaders/*.py` discovery paths); this module runs ONLY the
discovery step plus per-file existence checks and reports exactly what was
found and what is missing, so the first run against a freshly downloaded
archive fails fast and legibly.  Exposed on the CLI as
``python -m unsupervised_anomaly_detection_brain_mri_tpu_torch validate-data``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

# expected top-level layout per dataset, shown when discovery comes up
# empty (mirrors the reference's discovery globs:
# BRAINWEB.py:209-253, MSISBI2015.py:260-306, MSLUB.py:271-313,
# MSSEG2008.py:276-324)
_LAYOUT_HINTS = {
    "BRAINWEB": (
        "expected layout: <dir>/normal/*.mnc.gz, "
        "<dir>/lesions/{mild,moderate,severe}/*.mnc.gz, "
        "<dir>/groundtruth/{normal,mild_lesions,moderate_lesions,"
        "severe_lesions}.mnc.gz (protocol files e.g. flair_*.mnc.gz; "
        "see data/download.py to fetch BrainWeb)"),
    "MSISBI2015": (
        "expected layout: <dir>/training0{1..5}/preprocessed/"
        "training0X_0Y_flair_pp.nii (+ _mprage/_pd/_t2), "
        "<dir>/training0X/masks/training0X_0Y_mask1.nii"),
    "MSLUB": (
        "expected layout: <dir>/data/<patient>/<patient>_FLAIR.nii.gz "
        "(+ _T1W/_T1WKS/_T2W), <patient>_consensus_gt.nii.gz, "
        "<patient>_brainmask.nii.gz"),
    "MSSEG2008": (
        "expected layout: <dir>/{train_part1,test1_part1,train_part2,"
        "test1_part2}/<case>/<case>_FLAIR.nhdr (+ _T1/_T2), "
        "<case>_lesion.nhdr, <case>_skullmap.nhdr"),
}


def _dataset_shell(kind: str, directory: str,
                   protocols: Optional[Sequence[str]],
                   fmt: str):
    """Instantiate a dataset WITHOUT running its (cache-building)
    ``__init__`` — discovery (`_get_patients`) and `load_volumes` only
    need ``self.options``."""
    kind = kind.upper()
    if kind == "BRAINWEB":
        from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.brainweb import (
            BRAINWEB as cls,
        )
    elif kind == "MSISBI2015":
        from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.ms_datasets import (
            MSISBI2015 as cls,
        )
    elif kind == "MSLUB":
        from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.ms_datasets import (
            MSLUB as cls,
        )
    elif kind == "MSSEG2008":
        from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.ms_datasets import (
            MSSEG2008 as cls,
        )
    else:
        raise ValueError(
            f"unknown dataset {kind!r}; expected one of "
            f"{sorted(_LAYOUT_HINTS)}")
    opts = cls.options_cls(dir=directory, filterProtocol=protocols,
                           format=fmt)
    ds = object.__new__(cls)
    ds.options = opts
    return ds


def validate_dataset_dir(kind: str, directory: str,
                         protocols: Optional[Sequence[str]] = None,
                         fmt: str = "raw",
                         deep: bool = False) -> Dict[str, Any]:
    """Dry-run discovery for one dataset directory.

    Returns a report dict:
      ok          — True when at least one patient was found and every
                    discovered patient's volume/GT/skullmap files exist
      patients    — number of patients discovered
      by_type     — patient counts per type/folder (BRAINWEB severity,
                    MS cohort folder)
      protocols   — per-protocol file coverage {proto: n_found}
      missing     — list of {patient, role, path} for absent files
      errors      — top-level actionable problems (dir missing, nothing
                    discovered, unreadable volume in --deep)
    """
    kind = kind.upper()
    if kind not in _LAYOUT_HINTS:
        raise ValueError(
            f"unknown dataset {kind!r}; expected one of "
            f"{sorted(_LAYOUT_HINTS)}")
    report: Dict[str, Any] = {
        "dataset": kind, "dir": directory, "ok": False, "patients": 0,
        "by_type": {}, "protocols": {}, "missing": [], "errors": [],
    }
    if not os.path.isdir(directory):
        report["errors"].append(
            f"directory does not exist: {directory!r} — set the "
            f"{kind} path in config.default.json or pass --dir")
        return report
    try:
        ds = _dataset_shell(kind, directory, protocols, fmt)
        patients = ds._get_patients()
    except Exception as e:  # discovery itself blew up — report, don't raise
        report["errors"].append(f"patient discovery failed: {e!r}")
        return report

    if not patients:
        report["errors"].append(
            f"no patients discovered under {directory!r}; "
            + _LAYOUT_HINTS[kind])
        return report

    report["patients"] = len(patients)
    for p in patients:
        ptype = p.get("type") or os.path.basename(
            os.path.dirname(p.get("fullpath", ""))) or "?"
        report["by_type"][ptype] = report["by_type"].get(ptype, 0) + 1

        files = p.get("filtered_files")
        files = [files] if isinstance(files, str) else list(files or [])
        for f in files:
            proto = os.path.basename(f)
            # count per named protocol key when the loader recorded one
            for key, val in p.items():
                if val == f and key not in ("filtered_files", "fullpath",
                                            "name", "groundtruth",
                                            "groundtruth_filename",
                                            "skullmap", "type"):
                    proto = key
                    break
            if os.path.exists(f):
                report["protocols"][proto] = (
                    report["protocols"].get(proto, 0) + 1)
            else:
                report["missing"].append(
                    {"patient": p["name"], "role": f"volume[{proto}]",
                     "path": f})
        gt = p.get("groundtruth") or p.get("groundtruth_filename")
        if gt and not os.path.exists(gt):
            report["missing"].append(
                {"patient": p["name"], "role": "groundtruth", "path": gt})
        sk = p.get("skullmap")
        if sk and not os.path.exists(sk):
            report["missing"].append(
                {"patient": p["name"], "role": "skullmap", "path": sk})

    if deep and not report["missing"]:
        try:
            vol, seg, skullmap = ds.load_volumes(patients[0])
            if vol.data.ndim != 3:
                report["errors"].append(
                    f"first volume is {vol.data.ndim}-D, expected 3-D")
            elif vol.data.shape != seg.data.shape:
                report["errors"].append(
                    f"volume/groundtruth shape mismatch: "
                    f"{vol.data.shape} vs {seg.data.shape}")
        except Exception as e:
            report["errors"].append(
                f"deep check: loading patient "
                f"{patients[0]['name']!r} failed: {e!r}")

    report["ok"] = not report["errors"] and not report["missing"]
    return report


def format_report(report: Dict[str, Any]) -> str:
    lines: List[str] = []
    status = "OK" if report["ok"] else "PROBLEMS"
    lines.append(f"[{status}] {report['dataset']} at {report['dir']}")
    lines.append(f"  patients discovered: {report['patients']}")
    if report["by_type"]:
        counts = ", ".join(f"{k}: {v}"
                           for k, v in sorted(report["by_type"].items()))
        lines.append(f"  by type/folder: {counts}")
    if report["protocols"]:
        counts = ", ".join(f"{k}: {v}"
                           for k, v in sorted(report["protocols"].items()))
        lines.append(f"  protocol files found: {counts}")
    for m in report["missing"][:20]:
        lines.append(
            f"  MISSING {m['role']} for {m['patient']}: {m['path']}")
    if len(report["missing"]) > 20:
        lines.append(f"  ... and {len(report['missing']) - 20} more "
                     f"missing files")
    for e in report["errors"]:
        lines.append(f"  ERROR: {e}")
    return "\n".join(lines)
