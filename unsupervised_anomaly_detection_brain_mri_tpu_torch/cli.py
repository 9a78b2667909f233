"""Command-line interface of the port: the ``infer`` subcommand.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/cli.py::
infer_main`: the same flags, outputs and ``report.json``, plus ``--device``
(default ``cuda``; asking for a card that is not there raises, it does not
fall back to the CPU).

    python -m unsupervised_anomaly_detection_brain_mri_tpu_torch infer \\
        --workdir W -i scan.nii.gz

Training and evaluation subcommands are not ported yet: they print so and
exit with status 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from unsupervised_anomaly_detection_brain_mri_tpu.utils.misc import (
    json_sanitize,
)


def _scan_stem(path: str) -> str:
    name = os.path.basename(path)
    for ext in (".nii.gz", ".mnc.gz", ".nii", ".mnc", ".nrrd", ".nhdr"):
        if name.endswith(ext):
            return name[: -len(ext)]
    return os.path.splitext(name)[0]


def _unique_stems(inputs: List[str]) -> List[str]:
    """One output stem per input; a repeated basename gets ``_2``, ``_3``,
    ... never colliding with an actual stem later in the list."""
    all_stems = [_scan_stem(p) for p in inputs]
    taken = set(all_stems)
    used, stems = set(), []
    for s in all_stems:
        out, n = s, 2
        while out in used or (out != s and out in taken):
            out = f"{s}_{n}"
            n += 1
        used.add(out)
        stems.append(out)
    return stems


def infer_main(argv: Optional[List[str]] = None) -> int:
    """``infer``: serve a workdir on new scans; write the anomaly map in the
    source scan's geometry and a ``report.json`` per scan."""
    p = argparse.ArgumentParser(
        prog="infer",
        description="Detect anomalies in new scans with a trained workdir")
    p.add_argument("--workdir", required=True, type=str,
                   help="workdir (config.json + torch/model.pt; a "
                        "calibration.json is auto-loaded)")
    p.add_argument("-i", "--input", action="append", required=True,
                   type=str, help="scan path (.nii[.gz], .mnc[.gz], "
                                  ".nrrd/.nhdr); repeatable")
    p.add_argument("--brainmask", action="append", default=None, type=str,
                   help="brainmask volume per input (repeatable, matched "
                        "by position); default: intensity > 0.05 mask")
    p.add_argument("-O", "--threshold", default=None, type=float,
                   help="override the calibrated threshold")
    p.add_argument("-n", "--numMonteCarloSamples", default=None, type=int,
                   help="override the calibrated MC sample count")
    p.add_argument("-o", "--output-dir", default=None, type=str,
                   help="output directory (default: "
                        "<workdir>/inference/<scan-stem>)")
    p.add_argument("--no-export", action="store_true",
                   help="skip NIfTI export; write report.json only")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device to serve on (default: cuda)")
    args = p.parse_args(argv)

    if args.brainmask and len(args.brainmask) != len(args.input):
        p.error(f"{len(args.brainmask)} --brainmask for "
                f"{len(args.input)} --input (must match by position)")

    import numpy as np

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import (
        open_volume,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate import (
        export_residual_volume,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.inference import (
        AnomalyDetector,
    )

    det = AnomalyDetector.from_workdir(args.workdir, threshold=args.threshold,
                                       device=args.device)
    if args.numMonteCarloSamples is not None:
        det.options = det.options.replace(
            numMonteCarloSamples=args.numMonteCarloSamples)
    if det.threshold is None:
        print("NOTE: no threshold (no calibration.json in the workdir and "
              "no -O/--threshold) — anomaly maps only, no binary masks.")

    stems = _unique_stems(args.input)
    for idx, path in enumerate(args.input):
        nii = open_volume(path)
        axis = nii.view_mapping["axial"]
        vol = np.moveaxis(np.asarray(nii.data, np.float32), axis, 2)
        bm = None
        if args.brainmask:
            bnii = open_volume(args.brainmask[idx])
            bm = np.moveaxis(np.asarray(bnii.data, np.float32),
                             bnii.view_mapping["axial"], 2)
        res = det.detect(vol, brainmask=bm)

        stem = stems[idx]
        outdir = args.output_dir or os.path.join(
            args.workdir, "inference", stem)
        os.makedirs(outdir, exist_ok=True)

        files = {}
        if not args.no_export:
            geo = nii.geometry()
            geo["axis_index"] = axis
            geo["slice_range"] = (0, vol.shape[2])
            map_path = os.path.join(outdir, f"{stem}.anomaly.nii.gz")
            export_residual_volume(map_path, res["anomaly_map"], geo,
                                   threshold=det.threshold)
            files["anomaly_map"] = map_path
            if det.threshold is not None:
                files["binary_mask"] = map_path[:-7] + ".binary.nii.gz"

        report = {
            "input": os.path.abspath(path),
            "workdir": os.path.abspath(args.workdir),
            "threshold": det.threshold,
            "calibration": det.calibration,
            "model_resolution": [int(v) for v in
                                 res["anomaly_map"].shape[1:]],
            "num_slices": int(vol.shape[2]),
            "slice_scores": [float(v) for v in res["scores"]],
            "files": files,
        }
        for key in ("anomalous_voxels", "cc_converged"):
            if key in res:
                report[key] = res[key]
        report_path = os.path.join(outdir, f"{stem}.report.json")
        with open(report_path, "w") as f:
            json.dump(json_sanitize(report), f, indent=2)

        summary = f"{path}: peak slice score {max(report['slice_scores']):.4f}"
        if "anomalous_voxels" in report:
            summary += f", {report['anomalous_voxels']} anomalous voxels"
        print(summary)
        print(f"  report: {report_path}")
        for k, v in files.items():
            print(f"  {k}: {v}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "infer":
        return infer_main(argv[1:])
    what = argv[0] if argv and not argv[0].startswith("-") else "training"
    print(f"'{what}' is not yet ported to the PyTorch package (only 'infer' "
          f"is); see ROADMAP.md, or use unsupervised_anomaly_detection_"
          f"brain_mri_tpu", file=sys.stderr)
    return 2
