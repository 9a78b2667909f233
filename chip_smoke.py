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
     components; a ``torch.profiler`` summary of the 100 steps and of one
     ``evaluate()``, each with the device's busy share over its own
     profiled span, is printed and kept in
     ``build/chip_smoke_profile.txt``.

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
DEVICE = "cuda"
PROFILE_OUT = os.path.join(ROOT, "build", "chip_smoke_profile.txt")


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
        _erode_and_postprocess,
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
        state["diff"] = _erode_and_postprocess(
            state["x"], state["rec"], state["skm"], state["q"], o)
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


def lesion_cohort():
    """The CLI's lesioned synthetic cohort (``build_dataset``) and the
    options and config the CLI builds for ``--preset AE --synthetic``."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import (
        Dataset,
        Options,
        build_dataset,
        preset,
    )

    config = preset("AE")
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


def phase_timings(cudnn_tf32, matmul_tf32):
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import (
        PathConfig,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval import (
        evaluate as E,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
        metrics as M,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
        postprocess as P,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.engine import (
        epoch_indices,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    # the CLI's defaults again (phases 4 and 6 turned TF32 off)
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    config, options, healthy, cohort = lesion_cohort()
    options = options.replace(
        paths=PathConfig(sample_dir=os.path.join(ROOT, "build", "chip_smoke",
                                                 "timing")),
        threshold=None, applyHyperIntensityPrior=False)
    trainer = get_trainer("AE")(config, options, device=DEVICE)
    trainer.init_state()
    pool = {"x": torch.from_numpy(np.asarray(healthy.slices("TRAIN"),
                                             np.float32)).to(DEVICE)}
    n = int(pool["x"].shape[0])
    idxs = epoch_indices(np.random.default_rng((config.seed + 1, 0)), n,
                         config.batchsize)
    # one run of TIMED_STEPS steps: the epoch's index matrix repeated, so
    # the run's one index upload and one host sync are spread thin
    reps = -(-TIMED_STEPS // idxs.shape[0])
    steps = np.tile(idxs, (reps, 1))[:TIMED_STEPS]
    trainer._run_epoch("TRAIN", pool, idxs)  # warm-up
    torch.cuda.synchronize()
    run_ms, enqueue_ms = [], []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        # returns device tensors without a sync: the host's enqueue time
        trainer._run_epoch("TRAIN", pool, steps)
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        run_ms.append(start.elapsed_time(end))
    ms = statistics.median(run_ms)
    sps = steps.size / (ms / 1e3)
    print(f"[timing] warm training: {steps.shape[0]} steps x batch "
          f"{config.batchsize} = {steps.size} slices in {ms:.3f} ms "
          f"(CUDA events, median of 3 runs; each {run_ms}) -> "
          f"{sps:.1f} slices/s, {ms / steps.shape[0]:.3f} ms per step; the "
          f"host's enqueue of each run returned after "
          f"{[round(v, 1) for v in enqueue_ms]} ms")
    train_prof, train_busy = profile_summary(
        lambda: trainer._run_epoch("TRAIN", pool, steps),
        f"{steps.shape[0]} warm train steps")

    parts = {"reconstruct": 0.0, "postprocess": 0.0, "curves": 0.0,
             "components": 0.0}

    def timed(part, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            parts[part] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    originals = {(E, "_reconstruct_volume"): E._reconstruct_volume,
                 (E, "_erode_and_postprocess"): E._erode_and_postprocess,
                 (M, "anomaly_curve_summary"): M.anomaly_curve_summary,
                 (P, "filter_small_components"): P.filter_small_components,
                 (P, "detection_counts_batch"): P.detection_counts_batch}
    warm = E.evaluate(cohort, trainer, options, config)  # warm-up
    totals = []
    try:
        for mod, name in originals:
            part = {"_reconstruct_volume": "reconstruct",
                    "_erode_and_postprocess": "postprocess",
                    "anomaly_curve_summary": "curves"}.get(name, "components")
            setattr(mod, name, timed(part, originals[(mod, name)]))
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
    print(f"[timing] warm evaluate() of the TEST cohort ({len(spp)} volumes,"
          f" {sum(spp)} slices): {total:.1f} ms (host clock, median of {k}; each "
          f"{[round(v, 1) for v in totals]}); mean split: "
          + ", ".join(f"{p} {v:.1f} ms" for p, v in split.items())
          + f", host (load, zoom, quantile, artifacts) "
          f"{total - sum(split.values()):.1f} ms")
    eval_prof, eval_busy = profile_summary(
        lambda: E.evaluate(cohort, trainer, options, config),
        "one warm evaluate() of the TEST cohort")
    os.makedirs(os.path.dirname(PROFILE_OUT), exist_ok=True)
    with open(PROFILE_OUT, "w") as f:
        f.write(train_prof + "\n\n" + eval_prof + "\n")
    print(train_prof)
    print(eval_prof)
    return sps, total, split, train_busy, eval_busy


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

    build_s = phase_device()
    max_err, kernel_ms, plain_ms = phase_kernel()
    base = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(base, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=base)
    try:
        wd, scans = make_workdir(tmp)
        launches, detect_ms = phase_serve(wd, scans)
        phase_card_vs_cpu(wd, scans)
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        launches += phase_train_evaluate(tmp, scans[0])
        train_rel = phase_train_card_vs_cpu()
        sps, eval_ms, split, train_busy, eval_busy = phase_timings(*tf32)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(os.path.join(base, "timing"), ignore_errors=True)
    check("jax" not in sys.modules, "jax was imported")
    print(f"[summary] build {build_s:.2f} s, median kernel {kernel_ms:.4f} ms "
          f"vs plain {plain_ms:.4f} ms, warm detect {detect_ms:.3f} ms, "
          f"warm train {sps:.1f} slices/s (device busy "
          f"{100 * train_busy:.1f} %), warm evaluate() "
          f"{eval_ms:.1f} ms for the TEST cohort (device busy "
          f"{100 * eval_busy:.1f} %), train card vs CPU max relative loss "
          f"diff {train_rel:.3e}")
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
