"""Command-line interface of the port: training with the evaluation
protocol, ``infer`` and ``validate-data``.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/cli.py`.
``build_dataset``, ``CLI_DEFAULTS`` and ``make_parser`` are copies of that
module's (same flags, defaults and dataset cohorts).  Added: ``--device``
(default ``cuda``; asking for a card that is not there raises, nothing
falls back to the CPU).

    python -m unsupervised_anomaly_detection_brain_mri_tpu_torch \
        --preset AE --synthetic --device cuda
    python -m unsupervised_anomaly_detection_brain_mri_tpu_torch \
        --preset AE -c paths.json --device cuda
    python -m unsupervised_anomaly_detection_brain_mri_tpu_torch infer \
        --workdir W -i scan.nii.gz

Training runs the JAX CLI's protocol: ``fit`` (on BRAINWEB's healthy
phantoms from the ``-c`` paths file, or the phantom cohort with
``--synthetic``), best-Dice ``evaluate()`` without and with the
hyperintensity prior (on BRAINWEB, MSLUB and MSISBI2015, or ``-d``'s
dataset), the threshold fitted on the first cohort's VAL split (written to
``calibration.json``), and ``evaluate()`` again at that threshold;
``--metrics-out`` collects one JSON row per evaluation.  ``--tb-every-n
N`` writes TensorBoard event files under ``<workdir>/logs/{train,val}``
(``utils/logger.py``): each epoch's scalars and image grid, and every
N-th batch's.

The architecture is the reference's by default (``resolve_tpu_fast``: the
backend is never a TPU here).  ``--tpu-fast`` turns on both non-parity
options, the space-to-depth stem and the depth-to-space head; ``--s2d-stem``
and ``--d2s-head`` turn on one each; ``--parity`` with ``--tpu-fast``
exits.  ``--fast-convt-grad`` is accepted and changes nothing (it selects
a gradient rule of XLA's transposed convolution).

``validate-data`` checks a dataset directory's layout without loading it
(``data/validate.py``), with the JAX CLI's flags, report and exit codes.

``--mesh-data N`` trains, evaluates and calibrates data-parallel on N
ranks, one process per device (``parallel/``), started by ``torchrun``:

    torchrun --nproc_per_node N -m \
        unsupervised_anomaly_detection_brain_mri_tpu_torch \
        --preset AE --synthetic --device cuda --mesh-data N

Each rank runs on ``cuda:LOCAL_RANK`` over NCCL (``--device cpu``: on the
CPU over gloo); rank 0 writes the workdir, the artifacts,
``calibration.json`` and ``--metrics-out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
    DATASET_PARTITIONS,
    Config,
    Dataset,
    MeshConfig,
    Optimizer,
    Options,
    PathConfig,
    preset,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils.misc import (
    json_sanitize,
)


def build_dataset(options: Options, config: Config, dataset: Dataset,
                  split_role: str):
    """get_datasets parity (`utils/default_config_setup.py:60-72`):
    'healthy' -> training cohort; 'pathological' -> lesion eval cohort."""
    res = (config.outputHeight, config.outputWidth)
    common = dict(
        sliceStart=options.sliceStart, sliceEnd=options.sliceEnd,
        sliceResolution=res, cache=options.cache,
        normalizationMethod=options.normalizationMethod)
    if dataset == Dataset.SYNTH:
        from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.synthetic import (
            SYNTH,
            SyntheticOptions,
        )

        if split_role == "healthy":
            return SYNTH(SyntheticOptions(
                numPatients=8, imageSize=config.outputWidth,
                numSlices=max(options.sliceEnd - options.sliceStart, 8),
                targetSize=config.outputWidth,
                partition={"TRAIN": 0.7, "VAL": 0.3, "TEST": 0.0}))
        return SYNTH(SyntheticOptions(
            numPatients=6, imageSize=config.outputWidth,
            numSlices=max(options.sliceEnd - options.sliceStart, 8),
            targetSize=config.outputWidth, withLesions=True, seed=99,
            partition={"TRAIN": 0.0, "VAL": 0.5, "TEST": 0.5}))
    if dataset == Dataset.BRAINWEB:
        from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.brainweb import (
            BRAINWEB,
            BrainwebOptions,
        )

        if split_role == "healthy":
            return BRAINWEB(BrainwebOptions(
                dir=options.paths.brainweb_dir,
                partition={"TRAIN": 0.7, "VAL": 0.3, "TEST": 0.0},
                filterType=("NORMAL",), skullRemoval=True,
                backgroundRemoval=options.backgroundRemoval, **common))
        return BRAINWEB(BrainwebOptions(
            dir=options.paths.brainweb_dir,
            partition={"TRAIN": 0.0, "VAL": 0.3, "TEST": 0.7},
            filterType=("SEVEREMS",), skullRemoval=True, **common))
    if dataset == Dataset.MSLUB:
        from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.ms_datasets import (
            MSLUB,
            MSOptions,
        )

        return MSLUB(MSOptions(
            dir=options.paths.mslub_dir,
            partition=DATASET_PARTITIONS[Dataset.MSLUB],
            filterProtocol=("FLAIR",), **common))
    if dataset == Dataset.MSISBI2015:
        from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.ms_datasets import (
            MSISBI2015,
            MSOptions,
        )

        return MSISBI2015(MSOptions(
            dir=options.paths.msisbi2015_dir,
            partition=DATASET_PARTITIONS[Dataset.MSISBI2015],
            filterProtocol=("FLAIR",), **common))
    if dataset == Dataset.MSSEG2008:
        from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.ms_datasets import (
            MSSEG2008,
            MSSEG2008Options,
        )

        return MSSEG2008(MSSEG2008Options(
            dir=options.paths.msseg2008_dir,
            partition=DATASET_PARTITIONS[Dataset.MSSEG2008],
            filterProtocol=("FLAIR",), **common))
    raise ValueError(f"unknown dataset {dataset}")


# Reference `run.py:122-150` flag defaults.  The parser itself uses None
# sentinels so "explicitly passed (even at the default value)" is
# distinguishable from "not passed" — presets only yield to flags the user
# actually typed.
CLI_DEFAULTS = {
    "batchsize": 8, "lr": 0.0001, "numEpochs": 1000, "zDim": 128,
    "outputWidth": 128, "outputHeight": 128, "optimizer": "ADAM",
    "intermediateResolutions": "8,8", "slices_start": 20,
    "slices_end": 130, "trainer": "AE", "model": "autoencoder",
    "numMonteCarloSamples": 0, "use_gradient_based_restoration": 0.0,
    "kappa": 1.0, "scale": 10.0, "rho": 1.0, "dim_c": 9, "dim_z": 128,
    "dim_w": 1, "c_lambda": 1.0, "restore_lr": 1e-3,
    "restore_steps": 150, "tv_lambda": -1.0,
}


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Framework",
        epilog="subcommands (run as the first argument): "
               "'validate-data' dry-runs dataset-layout discovery; "
               "'infer' serves a calibrated workdir on new scans — "
               "see 'run.py validate-data --help' / 'run.py infer --help'")
    p.add_argument("-c", "--config", default=None, type=str,
                   help="config-path (JSON path roots)")
    p.add_argument("-b", "--batchsize", default=None, type=int)
    p.add_argument("-l", "--lr", default=None, type=float)
    p.add_argument("-E", "--numEpochs", default=None, type=int)
    p.add_argument("-z", "--zDim", default=None, type=int)
    p.add_argument("-w", "--outputWidth", default=None, type=int)
    p.add_argument("-g", "--outputHeight", default=None, type=int)
    p.add_argument("-o", "--optimizer", default=None, type=str)
    p.add_argument("-i", "--intermediateResolutions", default=None,
                   type=str, help="Spatial bottleneck resolution, e.g. 8,8")
    p.add_argument("-s", "--slices_start", default=None, type=int)
    p.add_argument("-e", "--slices_end", default=None, type=int)
    p.add_argument("-t", "--trainer", default=None, type=str)
    p.add_argument("-m", "--model", default=None, type=str)
    p.add_argument("-O", "--threshold", default=None, type=float)
    p.add_argument("-d", "--ds", default=None, type=str,
                   help="Only evaluate on the given dataset")
    # per-architecture extras
    p.add_argument("-n", "--numMonteCarloSamples", default=None, type=int)
    p.add_argument("-G", "--use_gradient_based_restoration", default=None,
                   type=float)
    p.add_argument("-K", "--kappa", default=None, type=float)
    p.add_argument("-M", "--scale", default=None, type=float)
    p.add_argument("-R", "--rho", default=None, type=float)
    p.add_argument("-C", "--dim_c", default=None, type=int)
    p.add_argument("-Z", "--dim_z", default=None, type=int)
    p.add_argument("-W", "--dim_w", default=None, type=int)
    p.add_argument("-A", "--c_lambda", default=None, type=float)
    p.add_argument("-L", "--restore_lr", default=None, type=float)
    p.add_argument("-S", "--restore_steps", default=None, type=int)
    p.add_argument("-T", "--tv_lambda", default=None, type=float)
    # TPU-native additions
    p.add_argument("--synthetic", action="store_true",
                   help="hermetic run on the procedural phantom dataset")
    p.add_argument("--mesh-data", default=None, type=int,
                   help="data-parallel device count (default: all)")
    p.add_argument("--precision", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--s2d-stem", action="store_true",
                   help="opt-in NON-PARITY space-to-depth input stem "
                        "(Config.spaceToDepthStem)")
    p.add_argument("--d2s-head", action="store_true",
                   help="opt-in NON-PARITY depth-to-space decoder head "
                        "(Config.depthToSpaceHead)")
    p.add_argument("--fast-convt-grad", dest="fast_convt_grad",
                   action="store_true", default=True,
                   help="PARITY-PRESERVING perf (default ON): reverse-"
                        "free ConvT kernel gradient (Config.fastConvTGrad"
                        "; same math and checkpoints, 1.08x on TPU v5e)")
    p.add_argument("--no-fast-convt-grad", dest="fast_convt_grad",
                   action="store_false",
                   help="disable the reverse-free ConvT kernel gradient "
                        "(use jax's built-in transpose rule)")
    p.add_argument("--tpu-fast", dest="tpu_fast", action="store_true",
                   default=None,
                   help="validated TPU perf profile: enables the "
                        "space-to-depth stem AND the depth-to-space head "
                        "(equivalent to --s2d-stem --d2s-head; NON-PARITY "
                        "architecture, quality validated against the "
                        "18-preset scoreboard — see README).  DEFAULT when "
                        "the backend is a TPU; --parity opts out")
    p.add_argument("--parity", action="store_true",
                   help="force the reference-parity architecture (opt out "
                        "of the TPU-default fast profile).  Non-TPU "
                        "backends are parity by default")
    p.add_argument("--log-every-n", default=0, type=int,
                   help="print every n-th batch's metrics from inside the "
                        "jitted epoch (async callback; parity with the "
                        "reference's per-batch console logs, "
                        "trainers/AE.py:86).  0 = per-epoch means only")
    p.add_argument("--tb-every-n", default=0, type=int,
                   help="emit mid-epoch TensorBoard summaries (scalars + "
                        "input|rec|L1 image grid) every n-th batch, parity "
                        "with the reference's tfSummaryAfter "
                        "(trainers/DLMODEL.py:24).  Implies TensorBoard "
                        "logging; 0 = per-epoch TB only")
    p.add_argument("--stream-pool", action="store_true",
                   help="stream the training pool in host-prefetched "
                        "device chunks instead of keeping it whole in HBM "
                        "(automatic above "
                        "Options.streamPoolThresholdMB; identical updates)")
    p.add_argument("--preset", default=None, type=str,
                   help="experiment preset name (mains/ parity)")
    p.add_argument("--workdir", default=None, type=str)
    p.add_argument("--metrics-out", default=None, type=str,
                   help="write one JSON row per evaluation (AUROC/AUPRC/"
                        "bestDice/threshold + final train loss) — feeds "
                        "the run_all quality scoreboard")
    return p


def resolve_tpu_fast(tpu_fast: Optional[bool], parity: bool) -> bool:
    """The execution profile: True for the fast profile (space-to-depth
    stem and depth-to-space head), False for the reference-parity
    architecture.  ``--parity`` and ``--tpu-fast`` together exit; an
    explicit ``--tpu-fast`` wins; otherwise the JAX CLI picks the fast
    profile on a TPU backend only, and the port never runs on one, so the
    default is parity."""
    if parity and tpu_fast:
        raise SystemExit("--parity and --tpu-fast are mutually exclusive")
    if parity:
        return False
    return bool(tpu_fast)


def validate_data_main(argv: Optional[List[str]] = None) -> int:
    """``validate-data`` subcommand: dry-run patient discovery with
    actionable errors (no cache build, no training)."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.validate import (
        format_report,
        validate_dataset_dir,
    )

    p = argparse.ArgumentParser(
        prog="validate-data",
        description="Check dataset directory layouts before a real run")
    p.add_argument("-c", "--config", default=None, type=str,
                   help="config-path (JSON path roots); validates every "
                        "dataset root it names")
    p.add_argument("-d", "--ds", default=None, type=str,
                   help="dataset to validate (BRAINWEB, MSLUB, "
                        "MSISBI2015, MSSEG2008)")
    p.add_argument("--dir", default=None, type=str,
                   help="dataset directory (overrides the config root)")
    p.add_argument("--protocol", action="append", default=None,
                   help="protocol filter (repeatable), e.g. FLAIR")
    p.add_argument("--format", default="raw", choices=("raw", "aligned"))
    p.add_argument("--deep", action="store_true",
                   help="additionally load the first patient's volumes")
    args = p.parse_args(argv)

    paths = (PathConfig.from_json(args.config) if args.config
             else PathConfig())
    roots = {
        "BRAINWEB": paths.brainweb_dir,
        "MSLUB": paths.mslub_dir,
        "MSISBI2015": paths.msisbi2015_dir,
        "MSSEG2008": paths.msseg2008_dir,
    }
    if args.ds:
        name = args.ds.upper()
        if name not in roots:
            p.error(f"unknown dataset {args.ds!r} "
                    f"(choose from {', '.join(sorted(roots))})")
        targets = {name: args.dir or roots[name]}
    elif args.dir:
        p.error("--dir requires --ds to name the dataset")
    else:
        targets = roots
    rc = 0
    for kind, directory in targets.items():
        report = validate_dataset_dir(
            kind, str(directory), protocols=args.protocol, fmt=args.format,
            deep=args.deep)
        print(format_report(report))
        if not report["ok"]:
            rc = 1
    return rc


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


def make_train_parser() -> argparse.ArgumentParser:
    """``make_parser`` with the port's ``--device``: the training CLI's
    flags."""
    parser = make_parser()
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to train and evaluate on "
                             "(default: cuda)")
    return parser


def train_main(argv: Optional[List[str]] = None) -> int:
    """Train, evaluate and calibrate, like the JAX CLI's ``main``."""
    args = make_train_parser().parse_args(argv)
    args.tpu_fast = resolve_tpu_fast(args.tpu_fast, args.parity)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested but no CUDA "
                           "device is available")

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel import (
        make_mesh,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.collectives import (
        initialize_multihost,
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
        spaceToDepthStem=args.s2d_stem or args.tpu_fast,
        depthToSpaceHead=args.d2s_head or args.tpu_fast,
        fastConvTGrad=args.fast_convt_grad,
        mesh=MeshConfig(data=args.mesh_data),
    )
    if args.preset:
        # preset values win over flags the user did not pass
        flag_to_field = {"lr": "learningrate"}
        keep = {flag_to_field.get(flag, flag) for flag in passed}
        config = preset(args.preset)
        config = config.replace(
            **{k: v for k, v in overrides.items() if k in keep})
        config = config.replace(
            compute_dtype=args.precision,
            spaceToDepthStem=args.s2d_stem or args.tpu_fast,
            depthToSpaceHead=args.d2s_head or args.tpu_fast,
            fastConvTGrad=args.fast_convt_grad,
            mesh=MeshConfig(data=args.mesh_data))
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
                      tbEveryNBatches=args.tb_every_n,
                      tensorboard=args.tb_every_n > 0,
                      streamPool=args.stream_pool)

    trainer_cls = get_trainer(config.trainer)
    train_ds_kind = Dataset.SYNTH if args.synthetic else Dataset.BRAINWEB
    mesh, owns_group = None, False
    if args.mesh_data:
        # one process per device: NCCL for ranks on cards, gloo on the CPU
        joined = torch.distributed.is_initialized()
        initialize_multihost(backend="nccl" if device.type == "cuda"
                             else "gloo")
        owns_group = not joined and torch.distributed.is_initialized()
        try:
            mesh = make_mesh(config.mesh, devices=None
                             if device.type == "cuda"
                             else [device] * args.mesh_data)
        except (ValueError, RuntimeError):
            if owns_group:
                torch.distributed.destroy_process_group()
            raise
        print(f"[mesh] rank {mesh.rank} of {mesh.n_data} on {mesh.device}"
              + (f" ({mesh.backend})" if mesh.parallel else ""))
    try:
        rc = _train_protocol(args, config, options, paths, trainer_cls,
                             train_ds_kind, mesh)
        if mesh is not None:
            mesh.barrier()
        return rc
    finally:
        if owns_group:
            torch.distributed.destroy_process_group()


def _train_protocol(args, config: Config, options: Options,
                    paths: PathConfig, trainer_cls, train_ds_kind: Dataset,
                    mesh) -> int:
    """``fit``, the evaluations and the threshold transfer of
    ``train_main``; under a mesh every rank runs them and rank 0 writes
    ``calibration.json`` and ``--metrics-out``."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate import (
        determine_threshold_on_labeled_patients,
        evaluate,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.inference import (
        save_calibration,
    )

    dataset_hc = build_dataset(options, config, train_ds_kind, "healthy")
    workdir = args.workdir or os.path.join(
        paths.checkpoint_dir, config.model,
        config.model_dir(train_ds_kind.value))
    os.makedirs(workdir, exist_ok=True)
    trainer = trainer_cls(config, options, workdir=workdir,
                          device=args.device, mesh=mesh)
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
        if args.metrics_out and metric_rows and trainer.is_writer:
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
    if trainer.is_writer:
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
        return validate_data_main(argv[1:])
    return train_main(argv)
