#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero without its
last line):
  1. device: the card's name and power limit, torch/CUDA versions, and the
     kernel build from ``csrc/`` (nvcc, sm_90a) with its time;
  2. kernel vs plain: ``median_filter_3d_cuda`` must equal the plain
     PyTorch median bit for bit at the serving shape (110, 128, 128) and at
     ragged shapes, on uniform and on tied, signed data; warm times of both
     by CUDA events (median of 20 runs);
  3. serve: a full-width ``AE`` workdir (128x128 slices, zDim 128, seeded
     Glorot init, bf16 compute) with a fixed calibrated threshold serves 3
     lesioned 110-slice phantoms through ``infer --device cuda``; the kernel
     launch count must rise by exactly 3; then warm ``detect`` times;
  4. card vs CPU: one request through the same workdir in float32 (TF32
     off) on the card and on the CPU (plain versions); anomaly map and
     scores within 1e-4, masks equal except within 1e-4 of the threshold;
  5. train + evaluate: the port's CLI ``--preset AE --synthetic --device
     cuda`` at full width (2 epochs, bf16, batch 128) trains, evaluates with
     and without the prior, fits and writes the threshold, evaluates at it,
     and writes ``--metrics-out``; losses finite and falling, checkpoints,
     ``calibration.json`` and finite AUROC/AUPRC/Dice in every
     ``evalPC.json``; the kernel launch count must rise by exactly the
     number of volumes the protocol evaluates (3 x TEST + VAL, counted from
     the dataset); then ``infer --device cuda`` serves the trained workdir;
  6. train card vs CPU: 5 Adam steps at 128x128, batch 8, float32, TF32 off,
     dropout 0, from the same init: free-running losses within 1e-3
     relative (float32 trajectories drift apart at (Leaky)ReLU kinks), and
     step by step from the CPU's state losses within 1e-4 relative and
     each tensor and its update within the bounds of ``compare_training``;
     the gradients of step 1's differing elements are printed;
  7. timings: warm train slices/s (CUDA events over one warm run of 100
     steps, the epoch's index matrix repeated) and warm ``evaluate()`` of
     the TEST cohort split into reconstruct, postprocess, curves and
     components; a profile of the 100 steps and of one ``evaluate()`` is
     queued for phase 9;
  8. the VAE family at full width (128x128, zDim 128, intermediate
     resolution 8, bf16), each sub-phase with its wall time:
     a. ``--preset VAE_You -E 1`` through the CLI: training, the lambda
        sweep on the card (timed; ``tv_lambda.json`` with lambda in
        [0, 1.9]), 3 evaluations and the threshold fit with batched
        150-step restoration, then ``infer``; b. ``--preset VAE -n 4``: MC
        evaluation and a served MC request whose epistemic variance is
        finite, positive inside the eroded brainmask and 0 outside;
        c. ``--preset ceVAE`` (gradient restoration) and warm train steps of
        ``STEP_PRESETS`` with finite losses; in a, b and c the median is
        launched exactly once per evaluated or served volume; d. card vs
        CPU in float32 with the same weights and noise: VAE and ceVAE
        forwards within TOL; the first FLIP_STEPS restoration steps
        from one input on both, with the voxels where the gradients
        differ and the subgradient sign flips that explain them; one
        150-step ``VAE_You`` restoration of a 110-slice volume within
        RESTORE_FLIP_STEPS x restore_lr; e. warm VAE train slices/s at
        batch 8 and 128, the warm ``VAE_You`` ``evaluate()`` split and a
        warm lambda sweep, with their profiles queued for phase 9;
  9. profiles, after every timing (a ``torch.profiler`` session slows
     every later launch): a ``torch.profiler`` summary of each queued run
     with the device's busy share over its own profiled span, printed and
     kept in ``build/chip_smoke_profile.txt``.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "unsupervised_anomaly_detection_brain_mri_tpu_torch"
SEED = 0
SERVE_SHAPE = (110, 128, 128)
RAGGED_SHAPES = ((7, 37, 45), (2, 1, 5))
N_REQUESTS = 3
THRESHOLD = 0.25
TOL = 1e-4
TRAIN_STEPS = 5
KINK_FRACTION = 3e-3
KINK_FLOOR = 3
UPDATE_TOL = 0.25
FREE_RUN_TOL = 1e-3
TIMED_STEPS = 100
STEP_PRESETS = ("VAE_Zimmerer", "ceVAE_Zimmerer", "AE_spatial", "CE")
WARM_STEPS = 3
# card-vs-CPU drift of the 150-step restoration, in restore_lr steps: a
# sign flip of the L1 or TV subgradient moves a voxel by whole multiples
# of restore_lr (5 measured on an H100, phase 8d)
RESTORE_FLIP_STEPS = 10
FLIP_STEPS = 3
DEVICE = "cuda"
PROFILE_OUT = os.path.join(ROOT, "build", "chip_smoke_profile.txt")
PROFILES = []  # (key, fn, title) queued for phase 9


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, n=20, warmup=3):
    """Median warm time of ``fn`` in ms, by CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, n=5, warmup=1):
    """Median warm wall time of ``fn`` in ms; ``fn`` must synchronise."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_device():
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, {torch.cuda.device_count()} device(s): "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    path, log = _build.build_library()
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"[device] kernel library {os.path.relpath(path, ROOT)} built and "
          f"loaded in {build_s:.2f} s")
    for line in log.strip().splitlines():
        print(f"[device] nvcc: {line}")
    return build_s


def phase_kernel():
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops.median import (
        median_filter_3d,
        median_filter_3d_cuda,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED)
    max_err = 0.0
    serve_vol = None
    for shape in (SERVE_SHAPE, *RAGGED_SHAPES):
        uniform = torch.rand(shape, generator=g, device="cuda")
        # ties, exact zeros and negative values: the order-key sign flip
        # and the bisection bracket on repeated keys
        tied = (torch.floor(torch.rand(shape, generator=g, device="cuda") * 9)
                / 8.0 - 0.5) * (torch.rand(shape, generator=g, device="cuda")
                                > 0.4)
        for name, vol in (("uniform", uniform), ("tied", tied)):
            got = median_filter_3d_cuda(vol.contiguous())
            ref = median_filter_3d(vol)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got, ref),
                  f"median kernel != plain at {shape} ({name}): "
                  f"max|diff| {err}")
            print(f"[kernel] {shape} {name}: equal (max|diff| {err})")
        if shape == SERVE_SHAPE:
            serve_vol = uniform
    plain_ms = cuda_ms(lambda: median_filter_3d(serve_vol))
    kernel_ms = cuda_ms(lambda: median_filter_3d_cuda(serve_vol))
    print(f"[kernel] median 5^3 at {SERVE_SHAPE}: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms (CUDA events, median of 20)")
    return max_err, kernel_ms, plain_ms


def make_workdir(base):
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch import (
        Config,
        Options,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import (
        make_phantom,
        write_nifti,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.inference import (
        save_calibration,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    wd = os.path.join(base, "workdir")
    os.makedirs(wd)
    config = Config(trainer="AE", model="autoencoder")  # full published width
    trainer = get_trainer("AE")(config, workdir=wd, device="cuda")
    trainer.init_state(torch.Generator().manual_seed(config.seed))
    trainer.save_checkpoint()
    save_calibration(wd, THRESHOLD, 0.0, Options(), dataset="phantom",
                     epoch=0)
    scans = []
    S, H, _ = SERVE_SHAPE
    for i in range(N_REQUESTS):
        ph = make_phantom(np.random.default_rng(SEED + i), size=H,
                          n_slices=S, with_lesions=True)
        path = os.path.join(base, f"phantom{i}.nii.gz")
        write_nifti(path, ph["volume"])
        scans.append(path)
    return wd, scans


def phase_serve(wd, scans):
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import (
        normalize_volume,
        open_volume,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate import (
        _eroded_mask,
        _postprocess,
        _reconstruct_volume,
        _zoom_volume,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.inference import (
        AnomalyDetector,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import median
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
        postprocess as P,
    )

    argv = ["infer", "--workdir", wd, "--device", "cuda"]
    for s in scans:
        argv += ["-i", s]
    median.LAUNCHES = 0
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = median.LAUNCHES
    check(rc == 0, f"infer exited {rc}")
    check(launches == N_REQUESTS,
          f"median kernel launched {launches} times for {N_REQUESTS} "
          f"requests")
    S, H, W = SERVE_SHAPE
    for i in range(N_REQUESTS):
        out = os.path.join(wd, "inference", f"phantom{i}")
        with open(os.path.join(out, f"phantom{i}.report.json")) as f:
            report = json.load(f)
        check(report["cc_converged"] is True, "connected components did not "
              "converge")
        check(report["model_resolution"] == [H, W]
              and report["num_slices"] == S
              and len(report["slice_scores"]) == S, "report shapes")
        amap = open_volume(os.path.join(out, f"phantom{i}.anomaly.nii.gz"))
        check(amap.data.shape == (H, W, S)
              and np.isfinite(amap.data).all(), "exported anomaly map")
        print(f"[serve] phantom{i}: {report['anomalous_voxels']} anomalous "
              f"voxels, peak slice score {max(report['slice_scores']):.4f}")
    print(f"[serve] infer CLI, {N_REQUESTS} requests (incl. model load and "
          f"NIfTI I/O): {cli_s:.3f} s; median kernel launches: {launches}")

    det = AnomalyDetector.from_workdir(wd, device="cuda")
    vol = np.asarray(open_volume(scans[0]).data, np.float32)
    res = det.detect(vol)
    check(res["anomaly_map"].shape == SERVE_SHAPE
          and np.isfinite(res["anomaly_map"]).all(), "detect anomaly map")
    detect_ms = host_ms(lambda: det.detect(vol))
    print(f"[serve] warm detect, one {S}x{H}x{W} request: {detect_ms:.3f} ms "
          f"(host clock, median of 5)")

    # where a request's time goes: detect's steps, each synchronised
    o, c = det.options, det.config
    state = {}

    def prep():
        v = normalize_volume(vol, method=o.normalizationMethod,
                             upper_percentile=o.upperpercentile)
        x = _zoom_volume(v, (c.outputHeight, c.outputWidth))
        state["q"] = float(np.quantile(v, 0.9))
        state["x"] = torch.from_numpy(x).cuda()
        state["skm"] = (state["x"] > 0.05).float()
        torch.cuda.synchronize()

    def recon():
        state["rec"] = _reconstruct_volume(
            det.trainer, state["x"][..., None], o)["reconstruction"][..., 0]
        torch.cuda.synchronize()

    def post():
        state["diff"] = _postprocess(
            state["x"], state["rec"], _eroded_mask(state["skm"], o),
            state["q"], o)
        torch.cuda.synchronize()

    def cc():
        P.filter_small_components(state["diff"] > THRESHOLD, o.minLesionSize)
        torch.cuda.synchronize()

    parts = {"host prep": host_ms(prep), "reconstruct": host_ms(recon),
             "postprocess": host_ms(post), "components": host_ms(cc)}
    print("[serve] breakdown (host clock, median of 5): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in parts.items()))
    return launches, detect_ms


def phase_card_vs_cpu(wd, scans):
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch import Config
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import (
        open_volume,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.inference import (
        AnomalyDetector,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_path = os.path.join(wd, "config.json")
    with open(cfg_path) as f:
        config = Config.from_json(f.read())
    with open(cfg_path, "w") as f:
        f.write(config.replace(compute_dtype="float32").to_json())
    vol = np.asarray(open_volume(scans[0]).data, np.float32)
    res = {dev: AnomalyDetector.from_workdir(wd, device=dev).detect(vol)
           for dev in ("cuda", "cpu")}
    gpu, cpu = res["cuda"], res["cpu"]
    map_err = float(np.abs(gpu["anomaly_map"] - cpu["anomaly_map"]).max())
    rec_err = float(np.abs(gpu["reconstruction"]
                           - cpu["reconstruction"]).max())
    score_err = float(np.abs(gpu["scores"] - cpu["scores"]).max())
    differ = gpu["mask"] != cpu["mask"]
    near = np.abs(cpu["anomaly_map"] - THRESHOLD) <= TOL
    print(f"[card-vs-cpu] float32, TF32 off: max|d reconstruction| "
          f"{rec_err:.3e}, max|d anomaly map| {map_err:.3e}, max|d scores| "
          f"{score_err:.3e}, mask voxels differing {int(differ.sum())} "
          f"(of which within {TOL} of the threshold "
          f"{int((differ & near).sum())}), anomalous voxels card "
          f"{gpu['anomalous_voxels']} cpu {cpu['anomalous_voxels']}")
    check(map_err <= TOL, f"anomaly map differs by {map_err}")
    check(score_err <= TOL, f"scores differ by {score_err}")
    check(not (differ & ~near).any(), "masks differ away from the threshold")
    return map_err


def lesion_cohort(name="AE"):
    """The CLI's lesioned synthetic cohort (``build_dataset``) and the
    options and config the CLI builds for ``--preset <name> --synthetic``."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import (
        Dataset,
        Options,
        build_dataset,
        preset,
    )

    config = preset(name)
    options = Options()
    return (config, options,
            build_dataset(options, config, Dataset.SYNTH, "healthy"),
            build_dataset(options, config, Dataset.SYNTH, "pathological"))


def phase_train_evaluate(base, scan):
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import median

    config, _, healthy, cohort = lesion_cohort()
    # a VAL pass needs one full batch of VAL slices
    val_epochs = 2 if len(healthy.slices("VAL")) >= config.batchsize else 0
    n_test = len(cohort.patients_of("TEST"))
    n_val = len(cohort.patients_of("VAL"))
    # two best-Dice evaluations and one at the transferred threshold of the
    # TEST volumes, one threshold fit over the VAL volumes
    expected = 3 * n_test + n_val
    wd = os.path.join(base, "trained")
    metrics_path = os.path.join(base, "metrics.jsonl")
    paths = os.path.join(base, "paths.json")
    with open(paths, "w") as f:
        json.dump({"SAMPLEDIR": os.path.join(base, "samples"),
                   "CHECKPOINTDIR": os.path.join(base, "checkpoints")}, f)
    median.LAUNCHES = 0
    t0 = time.perf_counter()
    rc = cli.main(["--preset", "AE", "--synthetic", "--device", DEVICE,
                   "--workdir", wd, "--metrics-out", metrics_path,
                   "-c", paths])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = median.LAUNCHES
    check(rc == 0, f"training CLI exited {rc}")
    check(launches == expected,
          f"median kernel launched {launches} times for {expected} "
          f"evaluated volumes (3 x {n_test} TEST + {n_val} VAL)")
    with open(os.path.join(wd, "curves.json")) as f:
        history = json.load(f)
    train = [h["loss"] for h in history if h["phase"] == "TRAIN"]
    val = [h["loss"] for h in history if h["phase"] == "VAL"]
    check(len(train) == 2 and len(val) == val_epochs
          and np.isfinite(train + val).all(), f"losses {history}")
    check(train[-1] < train[0], f"train loss did not fall: {train}")
    for name in ("torch/model.pt", "torch/ckpt/epoch_000001.pt",
                 "torch/ckpt/epoch_000002.pt", "calibration.json",
                 "config.json", "Curves.npy"):
        check(os.path.isfile(os.path.join(wd, name)), f"missing {name}")
    evals = []
    for dirpath, _, files in os.walk(os.path.join(base, "samples")):
        if "evalPC.json" in files:
            with open(os.path.join(dirpath, "evalPC.json")) as f:
                ev = json.load(f)
            for k in ("diff_AUC", "diff_AUPRC", "bestDiceScore",
                      "DiceScore"):
                check(k in ev and np.isfinite(ev[k]),
                      f"{dirpath}: {k} = {ev.get(k)}")
            evals.append(ev)
    check(len(evals) == 3, f"{len(evals)} evalPC.json files, expected 3")
    with open(metrics_path) as f:
        rows = [json.loads(line) for line in f]
    check(len(rows) == 3, f"{len(rows)} metric rows")
    with open(os.path.join(wd, "calibration.json")) as f:
        calib = json.load(f)
    print(f"[train] CLI train + 3 evaluations + threshold fit: {cli_s:.2f} s;"
          f" train loss {train}, VAL loss {val}; median kernel launches "
          f"{launches} (3 x {n_test} TEST + {n_val} VAL); calibrated "
          f"threshold {calib['threshold']:.5f} (VAL Dice "
          f"{calib['bestDiceVAL']:.4f})")
    for row in rows:
        print(f"[train] {row['description']}: AUROC {row['AUROC']:.4f} "
              f"AUPRC {row['AUPRC']:.4f} bestDice {row['bestDice']:.4f} "
              f"Dice {row['DiceScore']:.4f}")

    median.LAUNCHES = 0
    out = os.path.join(base, "served")
    rc = cli.main(["infer", "--workdir", wd, "-i", scan, "-o", out,
                   "--device", DEVICE])
    served = median.LAUNCHES
    check(rc == 0 and served == 1,
          f"infer on the trained workdir: rc {rc}, {served} launches")
    stem = os.path.basename(scan)[:-len(".nii.gz")]
    with open(os.path.join(out, f"{stem}.report.json")) as f:
        report = json.load(f)
    check(report["threshold"] == calib["threshold"],
          "served threshold is not the calibrated one")
    print(f"[train] infer on the trained workdir: "
          f"{report['anomalous_voxels']} anomalous voxels at the calibrated "
          f"threshold; median kernel launches {served}")
    return launches + served


def adam_step_bound(t, b1, b2):
    """Largest |m_hat / sqrt(v_hat)| of Adam's t-th step over all gradient
    histories (Cauchy-Schwarz over the two moment weights)."""
    import numpy as np

    i = np.arange(1, t + 1)
    a = (1 - b1) * b1 ** (t - i) / (1 - b1 ** t)
    w = (1 - b2) * b2 ** (t - i) / (1 - b2 ** t)
    return float(np.sqrt(np.sum(a * a / w)))


def bn_fed_bias(name):
    """The bias of a convolution that feeds a BatchNorm: its true gradient
    is zero (BatchNorm removes it), so round-off steers its Adam steps."""
    return name.endswith(".bias") and (".enc_conv_" in name
                                       or ".dec_convT_" in name
                                       or "intermediate_conv_reverse" in name)


def compare_training(card, cpu, start, config, t):
    """Parameters and BatchNorm statistics after Adam step ``t`` taken on
    the card and on the CPU from the same state ``start``.

    Bounds, per tensor: no element may differ by more than both devices'
    largest possible Adam moves, 2 * lr * adam_step_bound(t) (+1e-6 for
    float32 rounding); at most KINK_FLOOR elements, or KINK_FRACTION of
    them if that is more, may differ by more than 1e-5 (lr / 10); and its
    update (new minus ``start``) must agree with the CPU's within
    UPDATE_TOL relative (L2).  Where the loss or an activation has a kink
    (|x - rec| and LeakyReLU at 0), a value within round-off of it takes
    the other side on one device and changes the gradients of the weights
    behind it by a finite amount; an element whose gradient is smaller
    than that change takes the opposite Adam step (at step 1 on an H100,
    1,126 of 1,627,249 elements, each by 2 lr, at most 3 in a tensor under
    3,000 elements).  A missing or wrong update moves most elements of its
    tensor by ~lr and its relative update error to ~1.  The BN-fed conv
    biases are held to the Adam bound only.  Every failing tensor is
    named before the check fails."""
    import torch

    # + float32 rounding of the updated parameters
    bound = 2 * config.learningrate * adam_step_bound(
        t, config.beta1, config.beta2) + 1e-6
    worst, worst_fed, worst_frac, worst_upd, beyond = 0.0, 0.0, 0.0, 0.0, 0
    faults = []
    for k, v in cpu.items():
        c = card[k].cpu()
        if k.endswith("num_batches_tracked"):
            if not torch.equal(c, v):
                faults.append(f"{k} differs")
            continue
        d = (c - v).abs()
        if float(d.max()) > bound:
            faults.append(f"{k}: max|diff| {float(d.max())} beyond the Adam "
                          f"bound {bound}")
        if bn_fed_bias(k):
            worst_fed = max(worst_fed, float(d.max()))
            continue
        n = int((d > 1e-5).sum())
        if n > max(KINK_FLOOR, KINK_FRACTION * d.numel()):
            faults.append(f"{k}: {n} of {d.numel()} elements differ by more "
                          f"than 1e-5")
        upd_cpu = v - start[k]
        upd_err = float(torch.linalg.vector_norm((c - start[k]) - upd_cpu))
        upd_norm = float(torch.linalg.vector_norm(upd_cpu))
        if not upd_err <= UPDATE_TOL * upd_norm:
            faults.append(f"{k}: update differs from the CPU's by "
                          f"{upd_err:.3e} (L2) against its norm "
                          f"{upd_norm:.3e}")
        worst = max(worst, float(d.max()))
        worst_frac = max(worst_frac, n / d.numel())
        worst_upd = max(worst_upd, upd_err / max(upd_norm, 1e-30))
        beyond += n
    check(not faults, f"step {t}: " + "; ".join(faults))
    return bound, worst_fed, worst, beyond, worst_frac, worst_upd


def flipped_gradients(card, cpu, start, x):
    """Why step 1's parameters differ by more than 1e-5 between the card
    and the CPU (outside the BN-fed conv biases).  Prints, for those
    elements, their |grad| and how many took opposite gradient signs, and
    for their tensors the card-vs-CPU gradient difference (median, max)
    beside float32 rounding (2^-23 of the tensor's largest |grad|); then
    the pixels of the batch whose residual x - rec has opposite signs on
    the two devices (the L1 loss's kink) in a train-mode forward pass from
    ``start``."""
    import torch

    eps32 = float(torch.finfo(torch.float32).eps)
    n, n_sign, g_max, rel_max, ulp_max, dg_med, dg_max = (
        0, 0, 0.0, 0.0, 0.0, 0.0, 0.0)
    tensors = []
    card_params = dict(card.model.named_parameters())
    for k, p in cpu.model.named_parameters():
        q = card_params[k]
        mask = (q.detach().cpu() - p.detach()).abs() > 1e-5
        if bn_fed_bias(k) or p.grad is None or not mask.any():
            continue
        g, gc = p.grad, q.grad.cpu()
        dg = (gc - g).abs()
        top = float(g.abs().max())
        n += int(mask.sum())
        n_sign += int((torch.sign(g[mask]) != torch.sign(gc[mask])).sum())
        g_max = max(g_max, float(g[mask].abs().max()))
        rel_max = max(rel_max, float(g[mask].abs().max()) / top)
        ulp_max = max(ulp_max, eps32 * top)
        dg_med = max(dg_med, float(dg.median()))
        dg_max = max(dg_max, float(dg.max()))
        tensors.append(f"{k} {int(mask.sum())}/{p.numel()}: max|g| there "
                       f"{float(g[mask].abs().max()):.2e}; |dg| median "
                       f"{float(dg.median()):.2e}, max {float(dg.max()):.2e};"
                       f" float32 rounding {eps32 * top:.2e}")
    res = {}
    for name, trainer in (("card", card), ("cpu", cpu)):
        model = copy.deepcopy(trainer.model)
        model.load_state_dict(start)
        model.train()
        with torch.no_grad():
            xd = x.to(trainer.device)
            rec = model(xd, None)[trainer.spec.reconstruction_key]
            res[name] = (xd - rec).cpu()
    flips = int((torch.sign(res["card"]) != torch.sign(res["cpu"])).sum())
    print(f"[train-card-vs-cpu] step 1: {n} elements beyond 1e-5 in "
          f"{len(tensors)} tensors, {n_sign} with opposite gradient signs; "
          f"their |grad| up to {g_max:.3e} ({rel_max:.2e} of their tensor's "
          f"largest); card-vs-CPU gradient difference in those tensors: "
          f"median up to {dg_med:.3e}, max {dg_max:.3e}; float32 rounding "
          f"up to {ulp_max:.3e}; residual signs differing at {flips} of "
          f"{res['cpu'].numel()} pixels")
    for line in tensors:
        print(f"[train-card-vs-cpu]   {line}")


def phase_train_card_vs_cpu():
    """The same TRAIN_STEPS batches on the card and on the CPU, twice:
    free-running from the same init (float32 trajectories through
    (Leaky)ReLU kinks drift apart: 1.4e-4 relative after 5 steps on an
    H100, so FREE_RUN_TOL), then step by step from the CPU's state (losses
    within TOL relative, parameters and their updates within
    ``compare_training``'s bounds)."""
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import preset
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.engine import (
        epoch_indices,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = preset("AE", batchsize=8, dropout_rate=0.0,
                    compute_dtype="float32")
    _, _, healthy, _ = lesion_cohort()
    pool = np.asarray(healthy.slices("TRAIN"), np.float32)
    idxs = epoch_indices(np.random.default_rng((config.seed + 1, 0)),
                         len(pool), config.batchsize)[:TRAIN_STEPS]

    def pair():
        out = [get_trainer("AE")(config, device=dev)
               for dev in (DEVICE, "cpu")]
        for t in out:
            t.init_state()
        return out

    def step(trainer, rows):
        batch = {"x": torch.from_numpy(pool[rows]).to(trainer.device)}
        return float(trainer.train_step(batch)["loss"])

    card, cpu = pair()
    free = [(step(card, rows), step(cpu, rows)) for rows in idxs]
    free_rel = max(abs(a - b) / abs(b) for a, b in free)
    check(free_rel <= FREE_RUN_TOL, f"free-running losses differ by "
          f"{free_rel} relative: {free}")

    card, cpu = pair()
    forced, stats = [], []
    for t, rows in enumerate(idxs, 1):
        start = {k: v.detach().clone()
                 for k, v in cpu.model.state_dict().items()}
        card.model.load_state_dict(start)
        card.optimizer.load_state_dict(
            copy.deepcopy(cpu.optimizer.state_dict()))
        forced.append((step(card, rows), step(cpu, rows)))
        a, b = forced[-1]
        check(abs(a - b) <= TOL * abs(b), f"step {t}: loss card {a} vs cpu "
              f"{b}")
        if t == 1:
            flipped_gradients(card, cpu, start,
                              torch.from_numpy(pool[rows]))
        stats.append(compare_training(card.model.state_dict(),
                                      cpu.model.state_dict(), start, config,
                                      t))
    rel = max(abs(a - b) / abs(b) for a, b in forced)
    print(f"[train-card-vs-cpu] {TRAIN_STEPS} Adam steps at "
          f"{config.outputWidth}x{config.outputHeight}, batch 8, float32, "
          f"TF32 off, from the same init: free-running losses (card, cpu) "
          f"{free}, max relative diff {free_rel:.3e} (bound "
          f"{FREE_RUN_TOL}); each step from the CPU's state: max relative "
          f"loss diff {rel:.3e} (bound {TOL})")
    for t, (bound, worst_fed, worst, beyond, frac, upd) in enumerate(stats,
                                                                     1):
        print(f"[train-card-vs-cpu] step {t}: parameters max|diff| "
              f"{worst:.3e}, {beyond} elements beyond 1e-5 (largest share "
              f"in one tensor {frac:.3e}, bound {KINK_FRACTION}), largest "
              f"relative update error {upd:.3e} (bound {UPDATE_TOL}); BN-fed "
              f"conv biases max|diff| {worst_fed:.3e} (bound {bound:.3e})")
    return rel


def _device_time_us(event):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def profile_summary(fn, title):
    """Run ``fn`` once under ``torch.profiler``: the device kernels (and
    copies) with the most time, and the device's busy share, their total
    time over the profiled run's own span (host clock, from a synchronised
    start to the device's end).  Only device activity is traced: tracing
    host operators too doubles a launch-bound loop's span, and its
    ``record_function`` ranges (``Optimizer.step``) appear as device
    events that overlap the kernels.  The port runs on one stream, so
    kernels do not overlap and a share above 100 % is a fault of the
    measurement; what the profiler still costs lengthens the span, so the
    share is a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    # kernel-level events only: an operator's device time is its kernels'
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    device_ms = sum(_device_time_us(e) for e in kernels) / 1e3
    busy = device_ms / span_ms
    top = sorted(kernels, key=_device_time_us, reverse=True)[:12]
    lines = [f"== {title}: device time {device_ms:.3f} ms of the profiled "
             f"span {span_ms:.3f} ms ({100 * busy:.1f} % busy"
             + ("; above 100 %: a fault of the measurement" if busy > 1
                else "") + ")"]
    lines += [f"  {_device_time_us(e) / 1e3:10.3f} ms  {e.count:6d}x  "
              f"{e.key[:100]}" for e in top]
    return "\n".join(lines), busy


def defer_profile(key, fn, title):
    """Queue a profile of ``fn`` for phase 9.  A ``torch.profiler`` session
    slows every later launch of the process (by 4-5 ms per training step on
    the H100), so no timing may follow one: every profile runs after the
    last timing."""
    PROFILES.append((key, fn, title))


def warm_train(trainer, pool, seed, label):
    """Warm slices/s of ``trainer`` over one run of TIMED_STEPS steps (the
    epoch's index matrix repeated, so the run's one index upload and one
    host sync are spread thin), by CUDA events, median of 3 runs; a profile
    of one more run is queued under ``label + " train"``."""
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.engine import (
        epoch_indices,
    )

    bs = trainer.config.batchsize
    n = int(pool["x"].shape[0])
    idxs = epoch_indices(np.random.default_rng((seed + 1, 0)), n, bs)
    reps = -(-TIMED_STEPS // idxs.shape[0])
    steps = np.tile(idxs, (reps, 1))[:TIMED_STEPS]
    trainer._run_epoch("TRAIN", pool, idxs[:10])  # warm-up
    torch.cuda.synchronize()
    run_ms, enqueue_ms = [], []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        # returns device tensors without a sync: the host's enqueue time
        metrics = trainer._run_epoch("TRAIN", pool, steps)
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        run_ms.append(start.elapsed_time(end))
    check(all(bool(torch.isfinite(v)) for v in metrics.values()),
          f"{label}: non-finite training metrics {metrics}")
    ms = statistics.median(run_ms)
    sps = steps.size / (ms / 1e3)
    print(f"[timing] warm {label} training: {steps.shape[0]} steps x batch "
          f"{bs} = {steps.size} slices in {ms:.3f} ms (CUDA events, median "
          f"of 3 runs; each {[round(v, 3) for v in run_ms]}) -> {sps:.1f} "
          f"slices/s, {ms / steps.shape[0]:.3f} ms per step; the host's "
          f"enqueue of each run returned after "
          f"{[round(v, 1) for v in enqueue_ms]} ms")
    defer_profile(f"{label} train",
                  lambda: trainer._run_epoch("TRAIN", pool, steps),
                  f"{steps.shape[0]} warm {label} train steps (batch {bs})")
    return sps


def warm_evaluate(cohort, trainer, options, config, label):
    """Warm ``evaluate()`` of the TEST cohort (host clock, median of 3)
    split into reconstruct (or restoration), postprocess (erosion,
    residual, prior, median), curves and components, each synchronised; the
    rest is host work.  A profile of one more call is queued under
    ``label + " evaluate"``."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval import (
        evaluate as E,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
        metrics as M,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
        postprocess as P,
    )

    parts = {"reconstruct": 0.0, "postprocess": 0.0, "curves": 0.0,
             "components": 0.0}
    which = {"_reconstruct_volume": "reconstruct",
             "_reconstruct_volume_group": "reconstruct",
             "_eroded_mask": "postprocess", "_postprocess": "postprocess",
             "anomaly_curve_summary": "curves",
             "filter_small_components": "components",
             "detection_counts_batch": "components"}
    modules = {"anomaly_curve_summary": M, "filter_small_components": P,
               "detection_counts_batch": P}
    originals = {(modules.get(name, E), name): getattr(modules.get(name, E),
                                                       name)
                 for name in which}

    def timed(part, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            parts[part] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    warm = E.evaluate(cohort, trainer, options, config)  # warm-up
    totals = []
    try:
        for (mod, name), fn in originals.items():
            setattr(mod, name, timed(which[name], fn))
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            E.evaluate(cohort, trainer, options, config)
            totals.append((time.perf_counter() - t0) * 1e3)
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    k = len(totals)
    split = {p: v / k for p, v in parts.items()}
    total = statistics.median(totals)
    spp = warm["slices_per_patient"]
    print(f"[timing] warm {label} evaluate() of the TEST cohort ({len(spp)} "
          f"volumes, {sum(spp)} slices): {total:.1f} ms (host clock, median "
          f"of {k}; each {[round(v, 1) for v in totals]}); mean split: "
          + ", ".join(f"{p} {v:.1f} ms" for p, v in split.items())
          + f", host (load, zoom, quantile, artifacts) "
          f"{total - sum(split.values()):.1f} ms")
    defer_profile(f"{label} evaluate",
                  lambda: E.evaluate(cohort, trainer, options, config),
                  f"one warm {label} evaluate() of the TEST cohort")
    return total, split


def timing_options(options):
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import (
        PathConfig,
    )

    return options.replace(
        paths=PathConfig(sample_dir=os.path.join(ROOT, "build", "chip_smoke",
                                                 "timing")),
        threshold=None, applyHyperIntensityPrior=False)


def device_pool(dataset, masks=False):
    import numpy as np
    import torch

    pool = {"x": torch.from_numpy(np.asarray(dataset.slices("TRAIN"),
                                             np.float32)).to(DEVICE)}
    if masks:
        pool["mask"] = torch.from_numpy(np.asarray(
            dataset.brainmasks("TRAIN"), np.float32)).to(DEVICE)
    return pool


def phase_timings(cudnn_tf32, matmul_tf32):
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    # the CLI's defaults again (phases 4 and 6 turned TF32 off)
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    config, options, healthy, cohort = lesion_cohort()
    options = timing_options(options)
    trainer = get_trainer("AE")(config, options, device=DEVICE)
    trainer.init_state()
    sps = warm_train(trainer, device_pool(healthy), config.seed, "AE")
    total, split = warm_evaluate(cohort, trainer, options, config, "AE")
    return sps, total, split


# ---------------------------------------------------------------------------
# phase 8: the VAE family at full width (128x128, zDim 128, intermediate
# resolution 8, bf16), MC dropout, restoration


def run_protocol(base, name, extra=()):
    """``--preset <name> --synthetic --device cuda -E 1`` through the CLI:
    train, evaluate twice, fit and write the threshold, evaluate at it.
    The median kernel must be launched exactly once per evaluated volume
    (3 x TEST + VAL, counted from the dataset), whatever the MC sample
    count; losses finite, checkpoint, calibration and three finite
    ``evalPC.json``."""
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import median

    _, _, _, cohort = lesion_cohort(name)
    n_test = len(cohort.patients_of("TEST"))
    n_val = len(cohort.patients_of("VAL"))
    expected = 3 * n_test + n_val
    wd = os.path.join(base, name)
    metrics_path = os.path.join(base, f"{name}.metrics.jsonl")
    paths = os.path.join(base, f"{name}.paths.json")
    samples = os.path.join(base, f"{name}.samples")
    with open(paths, "w") as f:
        json.dump({"SAMPLEDIR": samples,
                   "CHECKPOINTDIR": os.path.join(base, "checkpoints")}, f)
    median.LAUNCHES = 0
    t0 = time.perf_counter()
    rc = cli.main(["--preset", name, "--synthetic", "--device", DEVICE,
                   "-E", "1", "--workdir", wd, "--metrics-out", metrics_path,
                   "-c", paths, *extra])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = median.LAUNCHES
    check(rc == 0, f"{name}: training CLI exited {rc}")
    check(launches == expected,
          f"{name}: median kernel launched {launches} times for {expected} "
          f"evaluated volumes (3 x {n_test} TEST + {n_val} VAL)")
    with open(os.path.join(wd, "curves.json")) as f:
        history = json.load(f)
    losses = [h["loss"] for h in history]
    check(losses and np.isfinite(losses).all(), f"{name}: losses {history}")
    for file in ("torch/model.pt", "calibration.json", "config.json"):
        check(os.path.isfile(os.path.join(wd, file)),
              f"{name}: missing {file}")
    evals = 0
    for dirpath, _, files in os.walk(samples):
        if "evalPC.json" in files:
            with open(os.path.join(dirpath, "evalPC.json")) as f:
                ev = json.load(f)
            for k in ("diff_AUC", "diff_AUPRC", "bestDiceScore",
                      "DiceScore"):
                check(k in ev and np.isfinite(ev[k]),
                      f"{dirpath}: {k} = {ev.get(k)}")
            evals += 1
    check(evals == 3, f"{name}: {evals} evalPC.json files, expected 3")
    with open(metrics_path) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(wd, "calibration.json")) as f:
        calib = json.load(f)
    print(f"[{name}] CLI train (1 epoch) + 3 evaluations + threshold fit: "
          f"{cli_s:.2f} s; losses {[round(v, 3) for v in losses]}; median "
          f"kernel launches {launches} (3 x {n_test} TEST + {n_val} VAL); "
          f"calibrated threshold {calib['threshold']:.5f} (VAL Dice "
          f"{calib['bestDiceVAL']:.4f})")
    for row in rows:
        print(f"[{name}] {row['description']}: AUROC {row['AUROC']:.4f} "
              f"AUPRC {row['AUPRC']:.4f} bestDice {row['bestDice']:.4f} "
              f"Dice {row['DiceScore']:.4f}")
    return wd, launches, calib


def serve_once(wd, scan, out):
    """``infer --device cuda`` of one scan on a trained workdir: one median
    launch, the calibrated threshold."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import median

    median.LAUNCHES = 0
    rc = cli.main(["infer", "--workdir", wd, "-i", scan, "-o", out,
                   "--device", DEVICE])
    served = median.LAUNCHES
    check(rc == 0 and served == 1,
          f"infer on {wd}: rc {rc}, {served} launches")
    with open(os.path.join(wd, "calibration.json")) as f:
        calib = json.load(f)
    stem = os.path.basename(scan)[:-len(".nii.gz")]
    with open(os.path.join(out, f"{stem}.report.json")) as f:
        report = json.load(f)
    check(report["threshold"] == calib["threshold"],
          "served threshold is not the calibrated one")
    return served


def phase_vae_you(base, scan):
    """a. ``--preset VAE_You``: training, the lambda sweep on the card
    (timed), 3 evaluations and the threshold fit with batched 150-step
    restoration (one restoration per group of up to
    ``restorationVolumeBatch`` volumes), then ``infer``."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval import (
        evaluate as E,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
        base as B,
    )

    sweep, groups = {}, []
    real_sweep = B.VAE_You.determine_best_lambda
    real_group = E._reconstruct_volume_group

    def timed_sweep(self, dataset):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep["lambda"] = real_sweep(self, dataset)
        torch.cuda.synchronize()
        sweep["s"] = time.perf_counter() - t0
        return sweep["lambda"]

    def counted_group(trainer, xs, *args, **kwargs):
        groups.append(len(xs))
        return real_group(trainer, xs, *args, **kwargs)

    B.VAE_You.determine_best_lambda = timed_sweep
    E._reconstruct_volume_group = counted_group
    try:
        wd, launches, _ = run_protocol(base, "VAE_You")
    finally:
        B.VAE_You.determine_best_lambda = real_sweep
        E._reconstruct_volume_group = real_group
    with open(os.path.join(wd, "tv_lambda.json")) as f:
        lam = json.load(f)["tv_lambda_value"]
    check("lambda" in sweep and lam == sweep["lambda"]
          and 0.0 <= lam <= 1.9, f"tv_lambda.json {lam}, sweep {sweep}")
    _, _, _, cohort = lesion_cohort("VAE_You")
    n_test = len(cohort.patients_of("TEST"))
    n_val = len(cohort.patients_of("VAL"))
    check(sum(groups) == 3 * n_test + n_val and max(groups) > 1,
          f"restoration groups {groups}")
    served = serve_once(wd, scan, os.path.join(base, "served_VAE_You"))
    print(f"[VAE_You] lambda sweep on the card: lambda {lam} in "
          f"{sweep['s']:.2f} s (cold, host clock); restoration groups "
          f"{groups} volumes; infer: {served} median launch")
    return wd, launches + served, sweep["s"], lam


def phase_vae_mc(base, scan):
    """b. ``--preset VAE -n 4``: MC evaluation launches the median once per
    volume; a served request under the calibrated 4 MC samples returns
    an epistemic variance that is finite, positive somewhere inside the
    eroded brainmask and 0 outside it."""
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import (
        normalize_volume,
        open_volume,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate import (
        _eroded_mask,
        _zoom_volume,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.inference import (
        AnomalyDetector,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import median

    wd, launches, calib = run_protocol(base, "VAE", ("-n", "4"))
    check(calib["options"]["numMonteCarloSamples"] == 4,
          f"calibration options {calib['options']}")
    launches += serve_once(wd, scan, os.path.join(base, "served_VAE"))
    det = AnomalyDetector.from_workdir(wd, device=DEVICE)
    o, c = det.options, det.config
    vol = np.asarray(open_volume(scan).data, np.float32)
    median.LAUNCHES = 0
    res = det.detect(vol)
    check(median.LAUNCHES == 1, f"MC detect: {median.LAUNCHES} launches")
    launches += median.LAUNCHES
    x = _zoom_volume(normalize_volume(vol, method=o.normalizationMethod,
                                      upper_percentile=o.upperpercentile),
                     (c.outputHeight, c.outputWidth))
    eroded = _eroded_mask(torch.from_numpy((x > 0.05).astype(np.float32))
                          .to(DEVICE), o).cpu().numpy()
    ev = res["epistemic_variance"]
    check(np.isfinite(ev).all() and (ev[eroded] > 0).any()
          and not ev[~eroded].any(),
          "epistemic variance not finite, not positive inside or not 0 "
          "outside the eroded mask")
    print(f"[VAE -n 4] served MC request: epistemic variance max "
          f"{float(ev.max()):.3e}, mean inside the eroded mask "
          f"{float(ev[eroded].mean()):.3e}, positive at "
          f"{int((ev[eroded] > 0).sum())} of {int(eroded.sum())} voxels "
          f"inside, 0 outside; median launches {launches} in all")
    return launches


def phase_cevae_and_steps(base):
    """c. ``--preset ceVAE`` (gradient restoration 0.1) through the
    protocol, then warm train steps at full width of the presets that no
    other phase trains: finite losses."""
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import preset
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.base import (
        count_params,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.engine import (
        epoch_indices,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    _, launches, _ = run_protocol(base, "ceVAE")
    _, _, healthy, _ = lesion_cohort("CE")
    for name in STEP_PRESETS:
        config = preset(name)
        trainer = get_trainer(config.trainer)(config, device=DEVICE)
        trainer.init_state()
        pool = device_pool(healthy, masks=trainer.needs_brainmask)
        idxs = epoch_indices(np.random.default_rng(SEED),
                             int(pool["x"].shape[0]), config.batchsize)
        trainer._run_epoch("TRAIN", pool, idxs[:1])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer._run_epoch("TRAIN", pool,
                                     idxs[1:1 + WARM_STEPS])
        metrics = {k: float(v) for k, v in metrics.items()}
        step_ms = (time.perf_counter() - t0) * 1e3 / WARM_STEPS
        check(np.isfinite(list(metrics.values())).all(),
              f"{name}: losses {metrics}")
        print(f"[steps] {name} ({config.model}, {count_params(trainer.model):,}"
              f" parameters, batch {config.batchsize}): {WARM_STEPS} warm "
              f"steps, {step_ms:.2f} ms per step (host clock), mean "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(metrics.items())))
    return launches


def restoration_flips(card, cpu, x, noise, lam):
    """The first FLIP_STEPS steps of the ``VAE_You`` restoration along the
    CPU's trajectory: at each step both devices take one gradient from the
    same input.  Counts the voxels where the sign of the residual
    ``x - x_hat`` (the L1 term's subgradient) or of a TV difference of it
    differs between the two, the voxels whose gradients differ by more
    than a quarter of the smallest flip jump (min(1, 2 lambda)), how many
    of those lie at or beside a flip, and how close their gradient
    differences are to whole multiples of the jump: one update moves such
    a voxel by that multiple of restore_lr."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.losses import (
        total_variation,
    )

    def one_step(trainer, xin):
        with torch.enable_grad():
            xi = xin.detach().to(trainer.device).requires_grad_(True)
            pixel, x_hat = trainer._restoration_fn(False)(
                xi, noise.to(trainer.device))
            total = torch.sum(pixel + lam * total_variation(xi - x_hat))
            (g,) = torch.autograd.grad(total, xi)
        return (xi - x_hat).detach().cpu(), g.cpu()

    def signs_differ(a, b):
        return torch.sign(a) != torch.sign(b)

    unit = min(1.0, 2.0 * lam)
    lr = cpu.config.restore_lr
    xin = x.clone()
    for step in range(1, FLIP_STEPS + 1):
        (r_c, g_c), (r_p, g_p) = one_step(card, xin), one_step(cpu, xin)
        pixel = signs_differ(r_c, r_p)
        dh = signs_differ(r_c[:, 1:] - r_c[:, :-1], r_p[:, 1:] - r_p[:, :-1])
        dw = signs_differ(r_c[:, :, 1:] - r_c[:, :, :-1],
                          r_p[:, :, 1:] - r_p[:, :, :-1])
        beside = pixel.clone()
        beside[:, 1:] |= dh
        beside[:, :-1] |= dh
        beside[:, :, 1:] |= dw
        beside[:, :, :-1] |= dw
        dg = (g_c - g_p).abs()
        big = dg > 0.25 * unit
        k = dg[big] / unit
        whole = int(((k - k.round()).abs() <= 0.05).sum())
        rest = float(dg[~big].max()) if (~big).any() else 0.0
        print(f"[vae-card-vs-cpu] restoration step {step} from one input: "
              f"residual signs differ at {int(pixel.sum())} voxels, TV "
              f"difference signs at {int(dh.sum())} + {int(dw.sum())}; "
              f"{int(big.sum())} voxels with |dg| > {0.25 * unit:g}, "
              f"{int((big & beside).sum())} of them at or beside a flip, "
              f"|dg| / {unit:g} within 0.05 of a whole number at {whole} "
              f"(values {sorted({round(float(v), 3) for v in k})[:8]}); "
              f"max |dg| elsewhere {rest:.3e}, i.e. {lr * rest:.1e} per "
              f"update")
        xin = xin - lr * g_p


def phase_vae_card_vs_cpu():
    """d. Float32, TF32 off, the same seeded weights on the card and the
    CPU, and the same noise drawn on the CPU: the VAE and ceVAE forwards of
    8 slices within TOL; ``restoration_flips`` on a 110-slice volume; one
    150-step ``VAE_You`` restoration of it within RESTORE_FLIP_STEPS x
    restore_lr."""
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import preset
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, healthy, cohort = lesion_cohort("VAE")
    g = torch.Generator().manual_seed(SEED)
    x = torch.from_numpy(np.asarray(healthy.slices("VAL")[:8], np.float32))
    noise = torch.randn((8, 128), generator=g)
    for name in ("VAE", "ceVAE"):
        config = preset(name, compute_dtype="float32")
        out = {}
        for dev in (DEVICE, "cpu"):
            t = get_trainer(config.trainer)(config, device=dev)
            t.init_state()
            with torch.no_grad():
                out[dev] = t._call(t.model_inputs({"x": x.to(dev)}, False),
                                   False, noise.to(dev))
        errs = {k: float((out[DEVICE][k].cpu() - v).abs().max())
                for k, v in out["cpu"].items()}
        print(f"[vae-card-vs-cpu] {name} forward, 8 slices, float32: max|d| "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        check(max(errs.values()) <= TOL, f"{name} forward differs: {errs}")
    config = preset("VAE_You", compute_dtype="float32", tv_lambda=0.5)
    vol = cohort.load_volume_and_groundtruth(cohort.patients_of("TEST")[0])[0]
    xv = torch.from_numpy(np.ascontiguousarray(np.transpose(
        vol, (2, 0, 1))[..., None], np.float32))
    noise = torch.randn((xv.shape[0], 128), generator=g)
    trainers = {dev: get_trainer("VAE_You")(config, device=dev)
                for dev in (DEVICE, "cpu")}
    for t in trainers.values():
        t.init_state()
    restoration_flips(trainers[DEVICE], trainers["cpu"], xv, noise,
                      config.tv_lambda)
    out, secs = {}, {}
    for dev, t in trainers.items():
        t0 = time.perf_counter()
        out[dev] = t.reconstruct_device(xv.to(dev), generator=noise.to(dev))[
            "reconstruction"].cpu()
        secs[dev] = time.perf_counter() - t0
    d = (out[DEVICE] - out["cpu"]).abs()
    moved = float((out["cpu"] - xv).abs().max())
    steps = float(d.max()) / config.restore_lr
    print(f"[vae-card-vs-cpu] VAE_You restoration of {tuple(xv.shape)}, "
          f"{config.restore_steps} steps, float32, same noise: max|d| "
          f"{float(d.max()):.3e} = {steps:.3f} x restore_lr, mean|d| "
          f"{float(d.mean()):.3e}, voxels beyond 1e-4 {int((d > 1e-4).sum())}"
          f" of {d.numel()} (bound {RESTORE_FLIP_STEPS} x restore_lr); the "
          f"restoration moved the input by up to {moved:.3e}; card "
          f"{secs[DEVICE]:.2f} s, CPU {secs['cpu']:.2f} s")
    check(steps <= RESTORE_FLIP_STEPS,
          f"restoration differs by {float(d.max())}")
    return float(d.max())


def phase_vae_timings(cudnn_tf32, matmul_tf32, vae_you_wd):
    """e. Warm VAE train slices/s at batch 8 and 128; the warm VAE_You
    ``evaluate()`` split; a warm lambda sweep; profiles."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch import Config
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    config, options, healthy, cohort = lesion_cohort("VAE")
    pool = device_pool(healthy)
    sps = {}
    for bs in (config.batchsize, 128):
        t = get_trainer("VAE")(config.replace(batchsize=bs), device=DEVICE)
        t.init_state()
        sps[bs] = warm_train(t, pool, config.seed, f"VAE b{bs}")
    with open(os.path.join(vae_you_wd, "config.json")) as f:
        you_config = Config.from_json(f.read())
    options = timing_options(options)
    t = get_trainer("VAE_You")(you_config, options, workdir=vae_you_wd,
                               device=DEVICE)
    check(t.load_checkpoint() is not None, "VAE_You checkpoint")
    total, split = warm_evaluate(cohort, t, options, you_config, "VAE_You")
    t.workdir = None  # keep the workdir's tv_lambda.json
    healthy = lesion_cohort("VAE_You")[2]
    healthy.slices("VAL")  # phantoms are made on the first call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.determine_best_lambda(healthy)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    print(f"[timing] warm lambda sweep: {sweep_s:.2f} s (host clock)")
    return sps, total, split, sweep_s


def phase_profiles():
    """9. The queued profiles, after every timing: printed, kept in
    PROFILE_OUT; returns each one's device busy share by key."""
    busy, texts = {}, []
    for key, fn, title in PROFILES:
        text, busy[key] = profile_summary(fn, title)
        print(text)
        texts.append(text)
    os.makedirs(os.path.dirname(PROFILE_OUT), exist_ok=True)
    with open(PROFILE_OUT, "w") as f:
        f.write("\n\n".join(texts) + "\n")
    return busy


def timed_phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s wall")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        raise SystemExit(f"chip_smoke.py: {PKG}/ not found next to this "
                         f"script; run it from a checkout of the repository")
    sys.path.insert(0, ROOT)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)

    build_s = timed_phase("1 device", phase_device)
    max_err, kernel_ms, plain_ms = timed_phase("2 kernel", phase_kernel)
    base = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(base, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=base)
    try:
        wd, scans = make_workdir(tmp)
        launches, detect_ms = timed_phase("3 serve", phase_serve, wd, scans)
        timed_phase("4 card vs cpu", phase_card_vs_cpu, wd, scans)
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        launches += timed_phase("5 train + evaluate", phase_train_evaluate,
                                tmp, scans[0])
        train_rel = timed_phase("6 train card vs cpu",
                                phase_train_card_vs_cpu)
        sps, eval_ms, split = timed_phase("7 timings", phase_timings, *tf32)
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        you_wd, you_launches, sweep_cold_s, lam = timed_phase(
            "8a VAE_You", phase_vae_you, tmp, scans[0])
        launches += you_launches
        launches += timed_phase("8b VAE -n 4", phase_vae_mc, tmp, scans[0])
        launches += timed_phase("8c ceVAE + warm steps",
                                phase_cevae_and_steps, tmp)
        restore_err = timed_phase("8d VAE card vs cpu",
                                  phase_vae_card_vs_cpu)
        vae_sps, you_eval_ms, you_split, sweep_s = timed_phase(
            "8e VAE timings", phase_vae_timings, *tf32, you_wd)
        busy = timed_phase("9 profiles", phase_profiles)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(os.path.join(base, "timing"), ignore_errors=True)
    check("jax" not in sys.modules, "jax was imported")
    print(f"[summary] build {build_s:.2f} s, median kernel {kernel_ms:.4f} ms "
          f"vs plain {plain_ms:.4f} ms, warm detect {detect_ms:.3f} ms, "
          f"warm train {sps:.1f} slices/s (device busy "
          f"{100 * busy['AE train']:.1f} %), warm evaluate() "
          f"{eval_ms:.1f} ms for the TEST cohort (device busy "
          f"{100 * busy['AE evaluate']:.1f} %), train card vs CPU max "
          f"relative loss diff {train_rel:.3e}")
    print(f"[summary] VAE family: warm VAE train {vae_sps[8]:.1f} slices/s "
          f"at batch 8 (device busy {100 * busy['VAE b8 train']:.1f} %), "
          f"{vae_sps[128]:.1f} at batch 128 (busy "
          f"{100 * busy['VAE b128 train']:.1f} %); VAE_You lambda {lam}, "
          f"sweep {sweep_cold_s:.2f} s cold, {sweep_s:.2f} s warm; warm "
          f"VAE_You evaluate() {you_eval_ms:.1f} ms for the TEST cohort ("
          + ", ".join(f"{p} {v:.1f} ms" for p, v in you_split.items())
          + f"; device busy {100 * busy['VAE_You evaluate']:.1f} %); "
          f"150-step restoration card vs CPU max|d| {restore_err:.3e}")
    print(json.dumps({"kernels": [{
        "name": "median5",
        "route": "cuda",
        "source": f"{PKG}/csrc/median5.cu",
        "replaces": "unsupervised_anomaly_detection_brain_mri_tpu/ops/"
                    "pallas_median.py:94",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
