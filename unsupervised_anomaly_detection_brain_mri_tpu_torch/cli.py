"""Command-line interface of the port: training with the evaluation
protocol, and ``infer``.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/cli.py`, with
its parser, flag defaults, presets and ``build_dataset`` (imported from
there: that module imports no JAX at module level).  Added: ``--device``
(default ``cuda``; asking for a card that is not there raises, nothing
falls back to the CPU).

    python -m unsupervised_anomaly_detection_brain_mri_tpu_torch \
        --preset AE --synthetic --device cuda
    python -m unsupervised_anomaly_detection_brain_mri_tpu_torch infer \
        --workdir W -i scan.nii.gz

Training runs the JAX CLI's protocol: ``fit``, best-Dice ``evaluate()``
without and with the hyperintensity prior, the threshold fitted on the
lesion cohort's VAL split (written to ``calibration.json``), and
``evaluate()`` again at that threshold; ``--metrics-out`` collects one
JSON row per evaluation.  The port always runs the parity architecture:
``--parity`` and ``--fast-convt-grad`` are accepted and change nothing;
``--tpu-fast``, ``--s2d-stem``, ``--d2s-head``, ``--mesh-data`` and
``--tb-every-n`` raise ``NotImplementedError``.  ``validate-data`` is not
ported yet (exit status 2).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from unsupervised_anomaly_detection_brain_mri_tpu.cli import (
    CLI_DEFAULTS,
    build_dataset,
    make_parser,
)
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    Config,
    Dataset,
    Optimizer,
    Options,
    PathConfig,
    preset,
)
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


# flags of the JAX CLI that select something the port does not have yet
_S2D_D2S = "the non-parity s2d/d2s options, ROADMAP.md queue item 3"
_NOT_PORTED_FLAGS = (
    ("tpu_fast", "--tpu-fast", _S2D_D2S),
    ("s2d_stem", "--s2d-stem", _S2D_D2S),
    ("d2s_head", "--d2s-head", _S2D_D2S),
    ("mesh_data", "--mesh-data", "the parallel layer, ROADMAP.md queue "
                                 "item 4"),
    ("tb_every_n", "--tb-every-n", "TensorBoard logging"),
)


def train_main(argv: Optional[List[str]] = None) -> int:
    """Train, evaluate and calibrate, like the JAX CLI's ``main``."""
    parser = make_parser()
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to train and evaluate on "
                             "(default: cuda)")
    args = parser.parse_args(argv)
    for attr, flag, what in _NOT_PORTED_FLAGS:
        if getattr(args, attr):
            raise NotImplementedError(
                f"{flag} is not yet ported to the PyTorch package ({what})")

    import torch

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested but no CUDA "
                           "device is available")

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate import (
        determine_threshold_on_labeled_patients,
        evaluate,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.inference import (
        save_calibration,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    passed = {k for k, v in vars(args).items()
              if v is not None and k in CLI_DEFAULTS}
    for k, v in CLI_DEFAULTS.items():
        if getattr(args, k, None) is None:
            setattr(args, k, v)

    paths = (PathConfig.from_json(args.config) if args.config
             else PathConfig())
    inter = tuple(int(v) for v in str(
        args.intermediateResolutions).split(","))
    overrides = dict(
        trainer=args.trainer, model=args.model,
        batchsize=args.batchsize, learningrate=args.lr,
        numEpochs=args.numEpochs, zDim=args.zDim,
        outputWidth=args.outputWidth, outputHeight=args.outputHeight,
        optimizer=Optimizer(args.optimizer),
        intermediateResolutions=inter,
        compute_dtype=args.precision,
        kappa=args.kappa, scale=args.scale, rho=args.rho,
        dim_c=args.dim_c, dim_z=args.dim_z, dim_w=args.dim_w,
        c_lambda=args.c_lambda, restore_lr=args.restore_lr,
        restore_steps=args.restore_steps, tv_lambda=args.tv_lambda,
        use_gradient_based_restoration=args.use_gradient_based_restoration,
        fastConvTGrad=args.fast_convt_grad,
    )
    if args.preset:
        # preset values win over flags the user did not pass
        flag_to_field = {"lr": "learningrate"}
        keep = {flag_to_field.get(flag, flag) for flag in passed}
        config = preset(args.preset)
        config = config.replace(
            **{k: v for k, v in overrides.items() if k in keep})
        config = config.replace(compute_dtype=args.precision,
                                fastConvTGrad=args.fast_convt_grad)
    else:
        config = Config().replace(**overrides)
    options = Options(paths=paths, sliceStart=args.slices_start,
                      sliceEnd=args.slices_end,
                      numMonteCarloSamples=args.numMonteCarloSamples,
                      threshold=args.threshold,
                      # 12 erosions at 128x128, scaled with the resolution
                      erosionIterations=max(
                          1, (12 * args.outputWidth) // 128),
                      logEveryNBatches=args.log_every_n,
                      streamPool=args.stream_pool)

    trainer_cls = get_trainer(config.trainer)
    train_ds_kind = Dataset.SYNTH if args.synthetic else Dataset.BRAINWEB
    dataset_hc = build_dataset(options, config, train_ds_kind, "healthy")
    workdir = args.workdir or os.path.join(
        paths.checkpoint_dir, config.model,
        config.model_dir(train_ds_kind.value))
    os.makedirs(workdir, exist_ok=True)
    trainer = trainer_cls(config, options, workdir=workdir,
                          device=args.device)
    trainer.fit(dataset_hc)

    def eval_ds(kind: Dataset):
        return build_dataset(options, config, kind, "pathological")

    metric_rows: List[dict] = []

    def record_metrics(res: dict, kind: Dataset, description: str) -> None:
        if not args.metrics_out:
            return
        train_rows = [h for h in trainer.history
                      if "train" in str(h.get("phase", "")).lower()]
        final_train_loss = (float(train_rows[-1].get("loss", float("nan")))
                            if train_rows else None)
        metric_rows.append({
            "preset": args.preset, "trainer": config.trainer,
            "model": config.model, "dataset": kind.value,
            "description": description,
            "AUROC": res.get("diff_AUC"), "AUPRC": res.get("diff_AUPRC"),
            "bestDice": res.get("bestDiceScore"),
            "bestThreshold": res.get("bestThreshold"),
            "DiceScore": res.get("DiceScore"),
            "finalTrainLoss": final_train_loss,
        })

    def flush_metrics() -> None:
        if args.metrics_out and metric_rows:
            with open(args.metrics_out, "w") as f:
                for row in metric_rows:
                    f.write(json.dumps(json_sanitize(row)) + "\n")

    if args.synthetic:
        eval_kinds = [Dataset.SYNTH]
    elif args.ds:
        eval_kinds = [Dataset(args.ds)]
    else:
        eval_kinds = [Dataset.BRAINWEB, Dataset.MSLUB, Dataset.MSISBI2015]

    def run_eval(kind: Dataset, desc: str, **option_changes) -> None:
        res = evaluate(eval_ds(kind), trainer,
                       options.replace(**option_changes), config,
                       epoch=config.numEpochs, description=desc)
        record_metrics(res, kind, desc)

    if args.threshold is not None:
        for kind in eval_kinds:
            run_eval(kind, f"{kind.value}-thresh_{args.threshold}",
                     threshold=args.threshold,
                     applyHyperIntensityPrior=False)
        flush_metrics()
        return 0

    if args.ds and not args.synthetic:
        # -d without a threshold: one best-Dice evaluation with the prior
        kind = eval_kinds[0]
        run_eval(kind, f"{kind.value}_upperbound_bestdice_wPrior",
                 threshold=None, applyHyperIntensityPrior=True)
        flush_metrics()
        return 0

    # best-Dice upper bound, without and with the hyperintensity prior
    for prior in (False, True):
        for kind in eval_kinds:
            run_eval(kind, f"{kind.value}_upperbound"
                     + ("_wPrior" if prior else ""),
                     threshold=None, applyHyperIntensityPrior=prior)

    # threshold transfer from the first eval cohort's VAL split
    transfer_options = options.replace(applyHyperIntensityPrior=False,
                                       threshold=None)
    best_dice, thresh = determine_threshold_on_labeled_patients(
        [eval_ds(eval_kinds[0])], trainer, transfer_options, config)
    print(f"Optimal threshold on MS Lesion Validation Set without optimal "
          f"postprocessing: {thresh} (Dice-Score {best_dice})")
    calib_path = save_calibration(
        workdir, thresh, best_dice, transfer_options,
        dataset=eval_kinds[0].value, epoch=config.numEpochs)
    print(f"Calibration written to {calib_path}")
    for kind in eval_kinds:
        run_eval(kind, f"{kind.value}-VALthresh_{thresh:.5f}",
                 threshold=thresh, applyHyperIntensityPrior=False)
    flush_metrics()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "infer":
        return infer_main(argv[1:])
    if argv and argv[0] == "validate-data":
        print("'validate-data' is not yet ported to the PyTorch package; "
              "see ROADMAP.md, or use unsupervised_anomaly_detection_brain_"
              "mri_tpu", file=sys.stderr)
        return 2
    return train_main(argv)
