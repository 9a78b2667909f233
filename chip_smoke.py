#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero without its
last line):
  1. device: the card's name and power limit, torch/CUDA versions, and the
     kernel build from ``csrc/`` (nvcc, sm_90a) with its time;
  2. kernel vs plain: ``median_filter_3d_cuda`` must equal the plain
     PyTorch median at the serving shape (110, 128, 128) and at ragged
     shapes, on uniform data, tied signed data and values spread over
     e^+-80 with +-0.0, and at the serving shape on a served-like residual
     map; warm times by CUDA events (median of 20 samples of one call
     each) of the kernel on uniform data and on the served map, of the
     plain version and of ``torch.median`` over the pre-built windows
     (selection only, the ``library_ms`` yardstick; the port never calls
     it); the kernel's times again with each sample spanning KERNEL_BATCH
     back-to-back calls (``batched_ms``: the host's enqueue gap drops out);
     the bytes bound;
     ``median_select_reference`` on the uniform volume's windows on the
     card: equal to the kernel, its mean and warp-max rounds;
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
  9. the GMVAE family and the latent-critic AAE family at full width
     (a-e: ``GMVAE_spatial``, ``GMVAE_You`` and ``AAE`` through the CLI,
     card vs CPU, timings), then the ResNet stack and the image critics:
     f. ``constrainedAAE_Chen``, ``fAnoGAN`` (one WGAN and one encoder
     epoch), ``fAnoGAN_schlegl`` and ``AnoVAEGAN`` through the protocol
     and ``infer``, with each batch's updates per group counted; g. their
     forwards card vs CPU within TOL, and one batch of each adversarial
     schedule at batch 2 with 1 critic update, losses within SPREAD_FACTOR
     x float32 rounding's spread; h. warm train slices/s of each schedule
     with its FLOPs per step (``torch.utils.flop_counter``) and the rate
     they make, and the warm Chen ``evaluate()`` split; i. the parallel
     layer: a. ``--preset AE --synthetic --device cuda --mesh-data 1``
     through the CLI on 16 slices per volume (batch 32, 1 epoch) with
     torchrun's environment for one rank: an NCCL group of one, one median
     launch per evaluated volume; b. two ranks on this one card over gloo
     (``chip_smoke.py --rank-worker RANK 2 DIR``): which gloo collectives
     take CUDA tensors, the sharded median of (110, 128, 128) (each rank's
     (59, 128, 128) slab through the kernel) bit-equal to the whole-volume
     kernel, one float32 AE step (batch 128 as 64 + 64) within
     ``compare_training``'s bounds of one process, one AAE batch within
     phase 9d's bounds, ``reconstruct_device`` of 37 slices with MC dropout
     within TOL, and their times; c. the AE preset's step with no mesh and
     with a one-rank mesh, in turns; j. the last features: a. ``--preset AE
     --synthetic --device cuda --tpu-fast --tb-every-n 4`` through the CLI
     at the preset's width (1 epoch, 3 evaluations, threshold fit, one
     median launch per evaluated volume, ``infer``), ``model_dir`` tagged
     ``_s2d_d2s``, the TensorBoard event files read back (tags, steps,
     CRCs, grids) without TensorBoard, the s2d/d2s forward card vs CPU
     within TOL, warm train slices/s with ``--tpu-fast`` and with the
     parity architecture; b. tensor parallelism, two gloo ranks on this
     card at dp1 x tp2 (``chip_smoke.py --tp-worker RANK 2 DIR``), AE at
     128 x 128, batch 128, float32: ``evaluate()`` of one volume (one
     median launch per rank) and a reconstruction against one process, one
     step within ``compare_training``'s bounds, its checkpoint restored in
     one process bit-equal, the step's time beside one process's;
     c. ``validate-data`` on a BrainWeb-layout phantom tree (exit 0) and on
     an empty directory (non-zero, with the layout hint); k. the
     all-preset sweep, ``run_all --device cuda`` at the quality tables'
     recipe (``--synthetic -E 1 -w 32 -g 32 -s 0 -e 8 -z 16 -b 8 -O 0.5
     --precision float32``, PyTorch's default TF32 state): all 18 presets
     with ``--check`` against ``scoreboards/expected_h100.json``, then all
     18 with ``--tpu-fast`` against ``expected_h100_fast.json``; one median launch per evaluated volume
     (at the recipe's ``-O 0.5`` the CLI evaluates the TEST volumes once);
     each preset's wall time and metrics beside the port's CPU table and
     the JAX tables (the TPU's labelled as such, not targets);
 10. profiles, after every timing (a ``torch.profiler`` session slows
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
KERNEL_BATCH = 10  # back-to-back kernel calls per pair of CUDA events
STEP_PRESETS = ("VAE_Zimmerer", "ceVAE_Zimmerer", "AE_spatial", "CE",
                "GMVAE", "constrainedAE", "constrainedAAE")
AAE_TIMED_STEPS = 5  # an AAE step at ae_iters 20 is 41 substeps
WARM_STEPS = 3
# card-vs-CPU drift of the 150-step restoration, in restore_lr steps: a
# sign flip of the L1 or TV subgradient moves a voxel by whole multiples
# of restore_lr (5 measured on an H100, phase 8d)
RESTORE_FLIP_STEPS = 10
# the 150-step CPU restoration of phase 8d runs on the middle slices of
# its volume (each slice restores on its own): all 110 took 290-460 s, 40
# took ~110 s, 20 ~55 s; 10 since the sweep of phase 9k was added
RESTORE_CHECK_SLICES = 10
# the AAE critic's and generator's losses read the train-mode encoder's
# z_, which one float32 rounding of the state moves ~100x further; they
# are held to SPREAD_FACTOR x the spread of ROUNDING_RUNS CPU batches from
# the start state perturbed by one rounding
SPREAD_FACTOR = 30
ROUNDING_RUNS = 3
FLIP_STEPS = 3
DEVICE = "cuda"
PROFILE_OUT = os.path.join(ROOT, "build", "chip_smoke_profile.txt")
PROFILES = []  # (key, fn, title) queued for phase 9


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, n=20, warmup=3, batch=1):
    """Median warm time of one ``fn`` call in ms, by CUDA events: each of
    the ``n`` samples spans ``batch`` back-to-back calls.  With ``batch``
    > 1 the device's queue stays full, so the host's time to enqueue a call
    (Python, checks, allocation, launch) drops out of a short kernel's
    time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
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


def spread_volume(shape, g):
    """Values spread over e^-80..e^80 of both signs, with +0.0 and -0.0
    mixed in: the order keys' sign flip, and many binades per window."""
    import torch

    mag = torch.exp((torch.rand(shape, generator=g, device=DEVICE) - 0.5)
                    * 160.0)
    sign = torch.where(torch.rand(shape, generator=g, device=DEVICE) < 0.5,
                       -1.0, 1.0)
    vol = mag * sign
    u = torch.rand(shape, generator=g, device=DEVICE)
    vol = torch.where(u < 0.1, torch.zeros_like(vol), vol)
    return torch.where(u < 0.05, -torch.zeros_like(vol), vol)


def served_residual():
    """A residual map shaped like a served one, at SERVE_SHAPE: a lesioned
    phantom through the port's residual pipeline up to the median (eroded
    brainmask, hyperintensity prior), with a blurred copy of the input as
    the reconstruction.  Mostly zero background."""
    import numpy as np
    import torch
    from scipy import ndimage as ndi

    from unsupervised_anomaly_detection_brain_mri_tpu_torch import Options
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import (
        make_phantom,
        normalize_volume,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate import (
        _eroded_mask,
        _postprocess,
        _zoom_volume,
    )

    S, H, W = SERVE_SHAPE
    o = Options(medianFiltering=False)
    ph = make_phantom(np.random.default_rng(SEED), size=H, n_slices=S,
                      with_lesions=True)
    v = normalize_volume(ph["volume"], method=o.normalizationMethod,
                         upper_percentile=o.upperpercentile)
    x = _zoom_volume(v, (H, W))
    rec = ndi.gaussian_filter(x, sigma=(0.0, 1.5, 1.5)).astype(np.float32)
    xt = torch.from_numpy(x).to(DEVICE)
    diff = _postprocess(xt, torch.from_numpy(rec).to(DEVICE),
                        _eroded_mask((xt > 0.05).float(), o),
                        float(np.quantile(v, 0.9)), o)
    return diff.contiguous()


def median_windows(vol):
    """The (S*H*W, 125) windows of a volume, 'reflect' borders, in the
    kernel's output order (a warp's 32 outputs are 32 consecutive rows)."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops.median import (
        _symmetric_pad,
    )

    p = _symmetric_pad(vol, 2)
    return p.unfold(0, 5, 1).unfold(1, 5, 1).unfold(2, 5, 1).reshape(-1, 125)


def phase_kernel():
    """2. The median kernel against the plain version on every data set
    and shape, its times (uniform and served map), its bound, the
    selection-only library time and the selection rule's rounds."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops.median import (
        median_filter_3d,
        median_filter_3d_cuda,
        median_select_reference,
    )

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    max_err = 0.0
    serve_vol = None
    for shape in (SERVE_SHAPE, *RAGGED_SHAPES):
        uniform = torch.rand(shape, generator=g, device=DEVICE)
        # ties, exact zeros and negative values: the order-key sign flip
        # and the bisection bracket on repeated keys
        tied = (torch.floor(torch.rand(shape, generator=g, device=DEVICE) * 9)
                / 8.0 - 0.5) * (torch.rand(shape, generator=g, device=DEVICE)
                                > 0.4)
        sets = [("uniform", uniform), ("tied", tied),
                ("spread", spread_volume(shape, g))]
        if shape == SERVE_SHAPE:
            sets.append(("served", served_residual()))
        for name, vol in sets:
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
            serve_vol, served = uniform, sets[-1][1]
    print(f"[kernel] served map: {100 * float((served == 0).float().mean()):.1f}"
          " % zero voxels")
    plain_ms = cuda_ms(lambda: median_filter_3d(serve_vol))
    # one event pair per call, the host's enqueue gap included
    kernel_ms = cuda_ms(lambda: median_filter_3d_cuda(serve_vol))
    served_ms = cuda_ms(lambda: median_filter_3d_cuda(served))
    batched_ms = cuda_ms(lambda: median_filter_3d_cuda(serve_vol),
                         batch=KERNEL_BATCH)
    served_batched_ms = cuda_ms(lambda: median_filter_3d_cuda(served),
                                batch=KERNEL_BATCH)
    # least time: each input byte read once, each output byte written once
    # at the H100's 3.35 TB/s; a median does no floating-point products
    bound_ms = 2 * serve_vol.numel() * 4 / 3.35e12 * 1e3
    windows = median_windows(serve_vol)
    library_ms = cuda_ms(lambda: torch.median(windows, dim=-1))
    med, rounds = median_select_reference(windows)
    check(torch.equal(med.view(SERVE_SHAPE), median_filter_3d_cuda(serve_vol)),
          "median_select_reference != kernel on the uniform volume")
    check(int(rounds.max()) <= 32, f"{int(rounds.max())} rounds")
    mean_rounds = float(rounds.double().mean())
    warp_rounds = float(rounds.view(-1, 32).max(dim=1).values.double().mean())
    del windows, med, rounds
    print(f"[kernel] median 5^3 at {SERVE_SHAPE} (CUDA events, median of "
          f"20 samples of one call): kernel {kernel_ms:.4f} ms on uniform "
          f"data, {served_ms:.4f} ms on the served map; plain "
          f"{plain_ms:.4f} ms; bound {bound_ms * 1e3:.2f} us (bytes), "
          f"{100 * bound_ms / kernel_ms:.2f} % of it; library (selection "
          f"only: torch.median over the pre-built (S*H*W, 125) windows) "
          f"{library_ms:.4f} ms")
    print(f"[kernel] batched (median of 20 samples of {KERNEL_BATCH} "
          f"back-to-back calls, per call): kernel {batched_ms:.4f} ms on "
          f"uniform data ({100 * bound_ms / batched_ms:.2f} % of the bound), "
          f"{served_batched_ms:.4f} ms on the served map")
    print(f"[kernel] selection rounds on the uniform volume's windows: mean "
          f"{mean_rounds:.3f}, warp max {warp_rounds:.3f}")
    return dict(max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms,
                served_ms=served_ms, batched_ms=batched_ms,
                served_batched_ms=served_batched_ms, bound_ms=bound_ms,
                library_ms=library_ms, rounds=mean_rounds,
                warp_rounds=warp_rounds)


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


def free_bias(name):
    """A bias whose true gradient is zero, so that round-off steers its Adam
    steps: that of a convolution feeding a norm (the unified backbones'
    convolutions, a ResNet block's conv1, the decoder's or generator's last
    block), or an image critic's convolution or output bias, which reaches
    the score only through LayerNorms or adds the same constant to the real
    and the fake scores, whose difference the WGAN loss takes."""
    return name.endswith(".bias") and (
        ".enc_conv_" in name or ".dec_convT_" in name
        or "intermediate_conv_reverse" in name) or name.endswith(
        ".conv1.bias") or (
        name.startswith(("decoder.res4.", "generator.res4."))
        and name.endswith(("conv2.bias", "shortcut.bias"))) or (
        name.startswith("disc_features.")
        and name.endswith((".stem.bias", "conv2.bias", "shortcut.bias"))) \
        or name == "disc_dense.bias"


def compare_training(card, cpu, start, config, t, bound_of=None):
    """Parameters and BatchNorm statistics after Adam step ``t`` taken on
    the card and on the CPU from the same state ``start``.  ``bound_of``
    (name -> bound) replaces the Adam bound where an element takes several
    steps of several optimizers (the adversarial trainers' batch); the
    count of elements beyond 1e-5 is then not limited, since over many
    steps the devices' rounding differences carry past 1e-5 (in an AAE
    batch on an H100, in up to 4 of the 32 elements of a BatchNorm's
    running mean and 5 % of a critic weight's).

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
    tensor by ~lr and its relative update error to ~1.  The biases whose
    true gradient is zero (``free_bias``) are held to the Adam bound
    only.  Every failing tensor is
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
        kb = bound if bound_of is None else bound_of(k)
        if float(d.max()) > kb:
            faults.append(f"{k}: max|diff| {float(d.max())} beyond the Adam "
                          f"bound {kb}")
        if free_bias(k):
            worst_fed = max(worst_fed, float(d.max()))
            continue
        n = int((d > 1e-5).sum())
        if bound_of is None and n > max(KINK_FLOOR,
                                        KINK_FRACTION * d.numel()):
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
        if free_bias(k) or p.grad is None or not mask.any():
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


def warm_train(trainer, pool, seed, label, timed_steps=TIMED_STEPS,
               profiled_steps=None):
    """Warm slices/s of ``trainer`` over one run of ``timed_steps`` steps
    (the epoch's index matrix repeated, so the run's one index upload and
    one host sync are spread thin), by CUDA events, median of 3 runs; a
    profile of one more run (of its first ``profiled_steps`` steps, default
    all) is queued under ``label + " train"``."""
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.engine import (
        epoch_indices,
    )

    bs = trainer.config.batchsize
    n = int(pool["x"].shape[0])
    idxs = epoch_indices(np.random.default_rng((seed + 1, 0)), n, bs)
    reps = -(-timed_steps // idxs.shape[0])
    steps = np.tile(idxs, (reps, 1))[:timed_steps]
    trainer._run_epoch("TRAIN", pool, idxs[:min(10, timed_steps)])  # warm-up
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
    profiled = steps[:profiled_steps]
    defer_profile(f"{label} train",
                  lambda: trainer._run_epoch("TRAIN", pool, profiled),
                  f"{profiled.shape[0]} warm {label} train steps (batch "
                  f"{bs})")
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
    # fAnoGAN's entries carry gen_loss (WGAN phase) or enc_loss
    losses = [h.get("loss", h.get("enc_loss", h.get("gen_loss")))
              for h in history]
    check(losses and None not in losses and np.isfinite(losses).all(),
          f"{name}: losses {history}")
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
    150-step ``VAE_You`` restoration of its middle RESTORE_CHECK_SLICES
    slices within RESTORE_FLIP_STEPS x restore_lr."""
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
    lo = max(0, (xv.shape[0] - RESTORE_CHECK_SLICES) // 2)
    xv = xv[lo:lo + RESTORE_CHECK_SLICES]
    noise = noise[lo:lo + RESTORE_CHECK_SLICES]
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



# ---------------------------------------------------------------------------
# phase 9: the GMVAE family and the latent-critic AAE family at full width
# (128x128, the presets' batch, zDim, dims and intermediate resolution,
# bf16)


def phase_gmvae_spatial(base, scan):
    """a. ``--preset GMVAE_spatial``: training, the lambda sweep on the
    card (timed), 3 evaluations and the threshold fit with batched 150-step
    restoration, then ``infer``."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval import (
        evaluate as E,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
        base as B,
    )

    sweep, groups = {}, []
    real_sweep = B.GMVAE.determine_best_lambda
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

    B.GMVAE.determine_best_lambda = timed_sweep
    E._reconstruct_volume_group = counted_group
    try:
        wd, launches, _ = run_protocol(base, "GMVAE_spatial")
    finally:
        B.GMVAE.determine_best_lambda = real_sweep
        E._reconstruct_volume_group = real_group
    with open(os.path.join(wd, "tv_lambda.json")) as f:
        lam = json.load(f)["tv_lambda_value"]
    check("lambda" in sweep and lam == sweep["lambda"]
          and 0.0 <= lam <= 1.9, f"tv_lambda.json {lam}, sweep {sweep}")
    _, _, _, cohort = lesion_cohort("GMVAE_spatial")
    n_test = len(cohort.patients_of("TEST"))
    n_val = len(cohort.patients_of("VAL"))
    check(sum(groups) == 3 * n_test + n_val and max(groups) > 1,
          f"restoration groups {groups}")
    served = serve_once(wd, scan, os.path.join(base, "served_GMVAE_spatial"))
    print(f"[GMVAE_spatial] lambda sweep on the card: lambda {lam} in "
          f"{sweep['s']:.2f} s (cold, host clock); restoration groups "
          f"{groups} volumes; infer: {served} median launch")
    return wd, launches + served, sweep["s"], lam


def phase_gmvae_you_and_aae(base, scan):
    """b. ``--preset GMVAE_You`` and ``--preset AAE`` through the protocol,
    each then served by ``infer``: AAE epoch 0 runs 20 AE and 20 critic
    updates and 1 generator update per batch, its ``disc_loss`` and
    ``gen_loss`` are finite, and its checkpoint holds the three optimizer
    states."""
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import gan

    _, launches, _ = run_protocol(base, "GMVAE_You")
    launches += serve_once(os.path.join(base, "GMVAE_You"), scan,
                           os.path.join(base, "served_GMVAE_You"))
    counts = {"ae": 0, "disc": 0, "gen": 0, "batches": 0}
    real_update, real_step = gan.AAE.update, gan.AAE.train_step

    def counted_update(self, group, loss):
        counts[group] += 1
        return real_update(self, group, loss)

    def counted_step(self, batch):
        counts["batches"] += 1
        return real_step(self, batch)

    gan.AAE.update, gan.AAE.train_step = counted_update, counted_step
    try:
        wd, aae_launches, _ = run_protocol(base, "AAE")
    finally:
        gan.AAE.update, gan.AAE.train_step = real_update, real_step
    n = counts["batches"]
    check(n > 0 and counts == {"ae": 20 * n, "disc": 20 * n, "gen": n,
                               "batches": n},
          f"AAE epoch 0 schedule: {counts}")
    with open(os.path.join(wd, "curves.json")) as f:
        train = [h for h in json.load(f) if h["phase"] == "TRAIN"]
    check(len(train) == 1 and np.isfinite(
        [train[0]["disc_loss"], train[0]["gen_loss"]]).all(),
        f"AAE losses {train}")
    ckpt = torch.load(os.path.join(wd, "torch", "ckpt", "epoch_000001.pt"),
                      map_location="cpu", weights_only=True)
    check(sorted(ckpt["optimizer"]) == ["ae", "disc", "gen"]
          and "gp_generator" in ckpt, f"AAE checkpoint {sorted(ckpt)}")
    served = serve_once(wd, scan, os.path.join(base, "served_AAE"))
    print(f"[AAE] epoch 0: {n} batches x (20 AE + 20 critic + 1 generator) "
          f"updates; disc_loss {train[0]['disc_loss']:.4f}, gen_loss "
          f"{train[0]['gen_loss']:.4f}; checkpoint holds optimizers "
          f"{sorted(ckpt['optimizer'])}; infer: {served} median launch")
    return launches + aae_launches + served


def draw_shapes(trainer, x):
    """The GMVAE draws' shapes, from one forward on the CPU."""
    import torch

    with torch.no_grad():
        out = trainer._call((x,), False, torch.Generator().manual_seed(SEED))
    return {"w": out["w_mu"].shape, "z": out["z_mu"].shape,
            "z_wc": out["z_wc_mus"].shape}


def phase_families_card_vs_cpu():
    """d. Float32, TF32 off, the same seeded weights on the card and the
    CPU and the same noise drawn on the CPU: the six networks' forwards of
    8 slices within TOL; one ``AAE`` batch at batch 8 (ae_iters 1, 20
    critic iterations, the same prior latents and eps, from the CPU's state
    after 2 batches) with each loss within TOL relative or SPREAD_FACTOR x
    float32 rounding's spread of that loss, whichever is larger, and each
    group's update within ``compare_training``'s bounds; a ``GMVAE`` 3-step
    restoration of a 110-slice volume within RESTORE_FLIP_STEPS x
    restore_lr."""
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import preset
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import aae
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.engine import (
        epoch_indices,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, healthy, cohort = lesion_cohort("AAE")
    g = torch.Generator().manual_seed(SEED)
    x = torch.from_numpy(np.asarray(healthy.slices("VAL")[:8], np.float32))
    worst = 0.0
    for name in ("GMVAE", "GMVAE_spatial", "GMVAE_You", "constrainedAE",
                 "AAE", "constrainedAAE"):
        config = preset(name, compute_dtype="float32")
        pair = {dev: get_trainer(config.trainer)(config, device=dev)
                for dev in (DEVICE, "cpu")}
        for t in pair.values():
            t.init_state()
        cpu = pair["cpu"]
        if name.startswith("GMVAE"):
            noise = {k: torch.randn(s, generator=g)
                     for k, s in draw_shapes(cpu, x).items()}
            args, kwargs = (), {"sample": noise}
        elif cpu.spec.takes_prior_z:
            args = (torch.randn((8, config.zDim), generator=g),)
            kwargs = {"gp": torch.rand((8, 1), generator=g)}
        else:
            args, kwargs = (), {}
        out = {}
        for dev, t in pair.items():
            t.model.eval()
            with torch.no_grad():
                out[dev] = t.model(
                    x.to(dev), *[a.to(dev) for a in args],
                    **{k: ({n: v.to(dev) for n, v in a.items()}
                           if isinstance(a, dict) else a.to(dev))
                       for k, a in kwargs.items()})
        # relative to each output's largest magnitude where it exceeds 1
        # (the dense GMVAE's pc_logit sums 128 log-likelihoods)
        errs = {k: float((out[DEVICE][k].cpu() - v).abs().max())
                / max(1.0, float(v.abs().max()))
                for k, v in out["cpu"].items()}
        worst = max(worst, max(errs.values()))
        print(f"[families-card-vs-cpu] {name} forward, 8 slices, float32: "
              f"max|d| / max(1, max|output|) "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        check(max(errs.values()) <= TOL, f"{name} forward differs: {errs}")

    # one AAE batch from one state: the same prior latents and eps on both
    config = preset("AAE", batchsize=8, dropout_rate=0.0, learningrate=5e-5,
                    compute_dtype="float32")
    pool = np.asarray(healthy.slices("TRAIN"), np.float32)
    idxs = epoch_indices(np.random.default_rng((config.seed + 1, 0)),
                         len(pool), config.batchsize)[:3]
    zs = [torch.randn((8, config.zDim), generator=g) for _ in range(20)]
    epss = [torch.rand((8, 1), generator=g) for _ in range(20)]
    real_uniform = aae.uniform

    def run(trainer, rows):
        draws = {"z": iter(zs), "eps": iter(epss)}
        trainer.sample_z = lambda generator, n: next(draws["z"]).to(
            trainer.device)
        aae.uniform = lambda source, shape, device: next(draws["eps"]).to(
            device)
        try:
            batch = {"x": torch.from_numpy(pool[rows]).to(trainer.device)}
            return {k: float(v) for k, v in trainer.train_step(batch).items()}
        finally:
            aae.uniform = real_uniform

    card, cpu = (get_trainer("AAE")(config, device=dev)
                 for dev in (DEVICE, "cpu"))
    for t in (card, cpu):
        t.init_state()
        t.epoch = 6  # ae_iters 1
    for rows in idxs[:2]:  # Adam's first steps move every element by lr
        run(cpu, rows)
    start = {k: v.detach().clone() for k, v in cpu.model.state_dict().items()}
    opt_start = copy.deepcopy(cpu.optimizer.state_dict())
    card.model.load_state_dict(start)
    card.optimizer.load_state_dict(copy.deepcopy(opt_start))
    m_card, m_cpu = run(card, idxs[2]), run(cpu, idxs[2])
    # float32 rounding's own spread: CPU batches from the start state with
    # each element moved by one rounding (2^-23 relative, normal)
    spread = dict.fromkeys(m_cpu, 0.0)
    pg = torch.Generator().manual_seed(SEED + 1)
    for _ in range(ROUNDING_RUNS):
        t = get_trainer("AAE")(config, device="cpu")
        t.init_state()
        t.epoch = 6
        t.model.load_state_dict({
            k: v * (1 + 2 ** -23 * torch.randn(v.shape, generator=pg))
            if v.is_floating_point() else v for k, v in start.items()})
        t.optimizer.load_state_dict(copy.deepcopy(opt_start))
        m = run(t, idxs[2])
        spread = {k: max(s, abs(m[k] - m_cpu[k])) for k, s in spread.items()}
    rel = {k: abs(m_card[k] - v) / abs(v) for k, v in m_cpu.items()}
    over = {k: abs(m_card[k] - v) / max(TOL * abs(v), SPREAD_FACTOR * spread[k])
            for k, v in m_cpu.items()}
    print(f"[families-card-vs-cpu] AAE batch (1 AE, 20 critic, 1 generator "
          f"update) from the CPU's state after 2 batches, batch 8, float32: "
          f"losses card {m_card}, cpu {m_cpu}; relative diff "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f"; CPU spread under one rounding of the state ({ROUNDING_RUNS} "
          f"runs) " + ", ".join(f"{k} {v / abs(m_cpu[k]):.2e}"
                                for k, v in spread.items())
          + f"; diff / max(TOL, {SPREAD_FACTOR} x spread) "
          + ", ".join(f"{k} {v:.3f}" for k, v in over.items()))
    check(max(over.values()) <= 1.0, f"AAE losses differ: {rel}")
    def bound_of(k):
        """Both devices' largest moves over the Adam steps this batch takes
        (the third of each optimizer, and the critic's 41st to 60th)."""
        steps = [3] + ([3] if k in card.groups["gen"] else []) + (
            list(range(41, 61)) if k in card.groups["disc"] else [])
        return 2 * config.learningrate * sum(
            adam_step_bound(t, 0.5, 0.9) for t in steps) + 1e-6

    bound, worst_fed, p_worst, beyond, frac, upd = compare_training(
        card.model.state_dict(), cpu.model.state_dict(), start, config, 1,
        bound_of)
    print(f"[families-card-vs-cpu] AAE batch: parameters max|diff| "
          f"{p_worst:.3e}, {beyond} elements beyond 1e-5 (largest share in "
          f"one tensor {frac:.3e}), largest relative update error {upd:.3e} "
          f"(bound {UPDATE_TOL}); BN-fed conv biases max|diff| "
          f"{worst_fed:.3e}")

    # a GMVAE 3-step restoration of a 110-slice volume
    config = preset("GMVAE", compute_dtype="float32", tv_lambda=0.5)
    vol = cohort.load_volume_and_groundtruth(cohort.patients_of("TEST")[0])[0]
    xv = torch.from_numpy(np.ascontiguousarray(np.transpose(
        vol, (2, 0, 1))[..., None], np.float32))
    trainers = {dev: get_trainer("GMVAE")(config, device=dev)
                for dev in (DEVICE, "cpu")}
    for t in trainers.values():
        t.init_state()
    noise = {k: torch.randn(s, generator=g)
             for k, s in draw_shapes(trainers["cpu"], xv).items()}
    out = {dev: t.reconstruct_device(xv.to(dev), generator={
        k: v.to(dev) for k, v in noise.items()})["reconstruction"].cpu()
        for dev, t in trainers.items()}
    d = (out[DEVICE] - out["cpu"]).abs()
    moved = float((out["cpu"] - xv).abs().max())
    steps = float(d.max()) / config.restore_lr
    print(f"[families-card-vs-cpu] GMVAE restoration of {tuple(xv.shape)}, "
          f"{config.restore_steps} steps, float32, same noise: max|d| "
          f"{float(d.max()):.3e} = {steps:.3f} x restore_lr, voxels beyond "
          f"1e-4 {int((d > 1e-4).sum())} of {d.numel()} (bound "
          f"{RESTORE_FLIP_STEPS} x restore_lr); the restoration moved the "
          f"input by up to {moved:.3e}")
    check(moved > 0 and steps <= RESTORE_FLIP_STEPS,
          f"GMVAE restoration differs by {float(d.max())}")
    return worst, max(rel.values()), float(d.max())


def phase_families_timings(cudnn_tf32, matmul_tf32, spatial_wd):
    """e. Warm train slices/s of ``GMVAE_spatial`` and ``GMVAE_You`` at
    batch 8 and of ``AAE`` at batch 128 with ae_iters 20 (epoch 0) and 1
    (epoch 6); the warm ``GMVAE_spatial`` ``evaluate()`` split; profiles
    queued."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch import Config
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import preset
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    _, options, healthy, cohort = lesion_cohort("GMVAE_spatial")
    pool = device_pool(healthy)
    sps = {}
    for name in ("GMVAE_spatial", "GMVAE_You"):
        c = preset(name)
        t = get_trainer(c.trainer)(c, device=DEVICE)
        t.init_state()
        sps[name] = warm_train(t, pool, c.seed, name)
    c = preset("AAE")
    for epoch, label in ((0, "AAE ae_iters 20"), (6, "AAE ae_iters 1")):
        t = get_trainer("AAE")(c, device=DEVICE)
        t.init_state()
        t.epoch = epoch
        sps[label] = warm_train(t, pool, c.seed, label, AAE_TIMED_STEPS)
    with open(os.path.join(spatial_wd, "config.json")) as f:
        spatial_config = Config.from_json(f.read())
    options = timing_options(options)
    t = get_trainer("GMVAE_spatial")(spatial_config, options,
                                     workdir=spatial_wd, device=DEVICE)
    check(t.load_checkpoint() is not None, "GMVAE_spatial checkpoint")
    total, split = warm_evaluate(cohort, t, options, spatial_config,
                                 "GMVAE_spatial")
    return sps, total, split


# ---------------------------------------------------------------------------
# phase 9f-9h: the ResNet stack (Chen's constrained AAE, Schlegl's fAnoGAN)
# and the image critics (fAnoGAN, AnoVAEGAN) at full width (128x128, batch
# 8, the presets' zDim, ResNet dim 64, bf16)


LAST_PRESETS = ("constrainedAAE_Chen", "fAnoGAN", "fAnoGAN_schlegl",
                "AnoVAEGAN")
# (label, preset, fAnoGAN encoder phase or Chen's epoch, timed steps,
# profiled steps): an epoch-0 Chen step is 41 substeps (~1 s on an H100),
# a WGAN step 6 with 5 grad-of-grad penalties, an AnoVAEGAN step 7; a
# profile's summary costs ~0.4 s per substep of these models, so the
# profiles cover a few steps
GAN_TIMINGS = (("Chen ae_iters 20", "constrainedAAE_Chen", 0, 2, 1),
               ("Chen ae_iters 1", "constrainedAAE_Chen", 6, 6, 2),
               ("fAnoGAN WGAN", "fAnoGAN", 0, 10, 3),
               ("fAnoGAN encoder", "fAnoGAN", 1, 30, 10),
               ("fAnoGAN_schlegl WGAN", "fAnoGAN_schlegl", 0, 4, 1),
               ("fAnoGAN_schlegl encoder", "fAnoGAN_schlegl", 1, 30, 10),
               ("AnoVAEGAN", "AnoVAEGAN", 0, 10, 3))
# the protocols of phase 9f train and evaluate on 16 slices per volume
# (the CLI's slice range; width and batch are the presets'): an epoch of
# the full 110 takes Chen ~80 s on an H100
GAN_SLICES = ("-s", "20", "-e", "36")
# dense bf16 peak of an H100 SXM (TFLOP/s), for the achieved share
H100_BF16_TFLOPS = 989.0


def schedule_counts(trainer_cls):
    """Patches ``trainer_cls`` to count its ``update`` calls per group and
    its batches per phase tag; returns (counts, undo)."""
    import collections

    counts = collections.Counter()
    real_update, real_step = trainer_cls.update, trainer_cls.train_step

    def counted_update(self, group, loss):
        counts[group] += 1
        return real_update(self, group, loss)

    def counted_step(self, batch):
        counts[self.phase_tag(self.epoch)] += 1
        return real_step(self, batch)

    trainer_cls.update, trainer_cls.train_step = counted_update, counted_step

    def undo():
        trainer_cls.update, trainer_cls.train_step = real_update, real_step

    return counts, undo


def phase_last_presets(base, scan):
    """f. The four presets through the protocol on GAN_SLICES (fAnoGAN's
    ``-E 1`` is one WGAN and one encoder epoch), each then served by
    ``infer`` on a 110-slice scan: each batch
    runs the updates its schedule says (Chen in epoch 0: 20 AE, 20 critic,
    1 generator; fAnoGAN: 1 generator and 5 critic, then 1 encoder;
    AnoVAEGAN: 1 VAE, 1 generator, 5 critic); the histories carry their
    phases (fAnoGAN: TRAIN_WGAN, TRAIN_Encoder, VAL) with finite losses;
    the checkpoints hold each group's optimizer.  Returns the median
    launches and the workdirs."""
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import gan

    expected = {
        "constrainedAAE_Chen": (gan.ConstrainedAAE, ["TRAIN", "VAL"],
                                lambda n: {"ae": 20 * n["TRAIN"],
                                           "disc": 20 * n["TRAIN"],
                                           "gen": n["TRAIN"]}),
        "fAnoGAN": (gan.FAnoGAN, ["TRAIN_WGAN", "TRAIN_Encoder", "VAL"],
                    lambda n: {"gen": n["TRAIN_WGAN"],
                               "disc": 5 * n["TRAIN_WGAN"],
                               "enc": n["TRAIN_Encoder"]}),
        "AnoVAEGAN": (gan.AnoVAEGAN, ["TRAIN", "VAL"],
                      lambda n: {"vae": n["TRAIN"], "gen": n["TRAIN"],
                                 "disc": 5 * n["TRAIN"]}),
    }
    expected["fAnoGAN_schlegl"] = expected["fAnoGAN"]
    launches, wds = 0, {}
    for name in LAST_PRESETS:
        cls, phases, want = expected[name]
        counts, undo = schedule_counts(cls)
        try:
            wd, n, _ = run_protocol(base, name, GAN_SLICES)
        finally:
            undo()
        launches += n
        wds[name] = wd
        batches = {k: v for k, v in counts.items() if k.startswith("TRAIN")}
        updates = {k: counts[k] for k in want(counts)}
        check(sorted(batches) == sorted(p for p in phases if p != "VAL")
              and min(batches.values()) > 0 and updates == want(counts),
              f"{name} schedule: batches {batches}, updates {updates}")
        with open(os.path.join(wd, "curves.json")) as f:
            history = json.load(f)
        check([h["phase"] for h in history] == phases
              and all(np.isfinite(v) for h in history for k, v in h.items()
                      if k not in ("epoch", "phase")),
              f"{name} history {history}")
        epochs = 1 + max(h["epoch"] for h in history)
        ckpt = torch.load(os.path.join(
            wd, "torch", "ckpt", f"epoch_{epochs:06d}.pt"),
            map_location="cpu", weights_only=True)
        check(sorted(ckpt["optimizer"]) == sorted(want(counts)),
              f"{name} checkpoint optimizers {sorted(ckpt['optimizer'])}")
        served = serve_once(wd, scan, os.path.join(base, f"served_{name}"))
        launches += served
        print(f"[{name}] batches {batches}, updates {updates}; history "
              + "; ".join(f"{h['phase']} " + ", ".join(
                  f"{k} {v:.4f}" for k, v in sorted(h.items())
                  if k not in ("epoch", "phase")) for h in history)
              + f"; checkpoint holds optimizers {sorted(ckpt['optimizer'])};"
              f" infer: {served} median launch")
    return launches, wds


def gan_noise(config, n, g):
    """The draws of one forward of a preset's model, made on the CPU: the
    prior z, the noise seam's ``sample`` (AnoVAEGAN's eps) and ``gp``
    (Chen's scalar eps, the image critics' per-sample alpha)."""
    import torch

    gp_shape = () if config.model.endswith("_Chen") else (n, 1, 1, 1)
    return (torch.randn((n, config.zDim), generator=g),
            {"sample": torch.randn((n, config.zDim), generator=g),
             "gp": torch.rand(gp_shape, generator=g)})


def gan_batch_card_vs_cpu(name, phase, pool, idxs):
    """One batch of ``name``'s schedule at batch 2 with 1 critic update,
    float32, dropout 0, on the card and on the CPU from the CPU's state
    after 2 batches, every draw made on the CPU from one seed: each loss
    within TOL relative or SPREAD_FACTOR x float32 rounding's spread of it
    (ROUNDING_RUNS CPU batches from the start state moved by one rounding),
    whichever is larger, and the parameters within ``compare_training``'s
    bounds.  ``phase`` is Chen's epoch or fAnoGAN's encoder phase."""
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import preset
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    config = preset(name, batchsize=2, dropout_rate=0.0, learningrate=5e-5,
                    compute_dtype="float32")
    epoch = config.numEpochs * phase if config.trainer == "fAnoGAN" \
        else phase

    def make(dev):
        t = get_trainer(config.trainer)(config, device=dev)
        t.init_state()
        t.d_iters = 1
        t.epoch = epoch
        return t

    def run(trainer, rows):
        g = torch.Generator().manual_seed(SEED + 3)
        dev = trainer.device
        trainer.sample_z = lambda generator, n: gan_noise(config, n, g)[0].to(
            dev)
        trainer._noise = lambda sample, gp: {
            k: v.to(dev) for k, v in gan_noise(config, 2, g)[1].items()}
        batch = {"x": torch.from_numpy(pool[rows]).to(dev)}
        return {k: float(v) for k, v in trainer.train_step(batch).items()}

    card, cpu = make(DEVICE), make("cpu")
    for rows in idxs[:2]:  # Adam's first steps move every element by lr
        run(cpu, rows)
    start = {k: v.detach().clone() for k, v in cpu.model.state_dict().items()}
    opt_start = copy.deepcopy(cpu.optimizer.state_dict())
    card.model.load_state_dict(start)
    card.optimizer.load_state_dict(copy.deepcopy(opt_start))
    m_card, m_cpu = run(card, idxs[2]), run(cpu, idxs[2])
    spread = dict.fromkeys(m_cpu, 0.0)
    pg = torch.Generator().manual_seed(SEED + 1)
    for _ in range(ROUNDING_RUNS):
        t = make("cpu")
        t.model.load_state_dict({
            k: v * (1 + 2 ** -23 * torch.randn(v.shape, generator=pg))
            if v.is_floating_point() else v for k, v in start.items()})
        t.optimizer.load_state_dict(copy.deepcopy(opt_start))
        m = run(t, idxs[2])
        spread = {k: max(s, abs(m[k] - m_cpu[k])) for k, s in spread.items()}
    diff = {k: abs(m_card[k] - v) for k, v in m_cpu.items()}
    over = {k: d / max(TOL * abs(m_cpu[k]), SPREAD_FACTOR * spread[k])
            if d > 0 else 0.0 for k, d in diff.items()}
    label = f"{name} {card.phase_tag(epoch)}"
    stepped = [g for g in card.groups if any(
        not torch.equal(card.model.state_dict()[n].cpu(), start[n])
        for n in card.groups[g])]

    def bound_of(k):
        """Both devices' largest moves: Adam's third step of each group
        that this batch updates and that holds ``k``."""
        steps = max(1, sum(k in card.groups[g] for g in stepped))
        return 2 * config.learningrate * steps * adam_step_bound(
            3, config.beta1, config.beta2) + 1e-6

    bound, worst_free, p_worst, beyond, frac, upd = compare_training(
        card.model.state_dict(), cpu.model.state_dict(), start, config, 3,
        bound_of)
    print(f"[last-card-vs-cpu] {label} batch (batch 2, d_iters 1, "
          f"updated groups {stepped}) from the CPU's state after 2 batches, "
          f"float32: losses card {m_card}, cpu {m_cpu}; relative diff "
          + ", ".join(f"{k} {d / max(abs(m_cpu[k]), 1e-30):.2e}"
                      for k, d in diff.items())
          + f"; CPU spread under one rounding of the state ({ROUNDING_RUNS} "
          f"runs) " + ", ".join(f"{k} {v:.2e}" for k, v in spread.items())
          + f"; diff / max(TOL, {SPREAD_FACTOR} x spread) "
          + ", ".join(f"{k} {v:.3f}" for k, v in over.items())
          + f"; parameters max|diff| {p_worst:.3e}, {beyond} elements beyond "
          f"1e-5 (largest share in one tensor {frac:.3e}), largest relative "
          f"update error {upd:.3e} (bound {UPDATE_TOL}); zero-gradient "
          f"biases max|diff| {worst_free:.3e}")
    check(max(over.values()) <= 1.0, f"{label} losses differ: {diff}")
    check(sorted(stepped) == sorted(
        {"fAnoGAN": ["enc"] if phase else ["disc", "gen"],
         "ConstrainedAAE": ["ae", "disc", "gen"],
         "AnoVAEGAN": ["disc", "gen", "vae"]}[config.trainer]),
        f"{label}: groups updated {stepped}")
    return max(d / max(abs(m_cpu[k]), 1e-30) for k, d in diff.items())


def phase_last_card_vs_cpu():
    """g. Float32, TF32 off, the same seeded weights on the card and the
    CPU and the same draws made on the CPU (prior z, eps, alpha; no
    dropout): the four networks' forwards of 8 slices within TOL of each
    output's scale; one batch of each adversarial schedule (Chen, fAnoGAN
    in each phase, Schlegl's WGAN phase, AnoVAEGAN) by
    ``gan_batch_card_vs_cpu`` at batch 2 with 1 critic update: at 128x128
    a CPU batch of Chen's epoch-0 schedule (41 substeps at batch 8) is ~25
    TFLOP."""
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
    _, _, healthy, _ = lesion_cohort("fAnoGAN")
    g = torch.Generator().manual_seed(SEED)
    x = torch.from_numpy(np.asarray(healthy.slices("VAL")[:8], np.float32))
    worst = 0.0
    for name in LAST_PRESETS:
        config = preset(name, compute_dtype="float32")
        pair = {dev: get_trainer(config.trainer)(config, device=dev)
                for dev in (DEVICE, "cpu")}
        z, noise = gan_noise(config, 8, g)
        out = {}
        for dev, t in pair.items():
            t.init_state()
            t.model.eval()
            args = (x, z) if t.spec.takes_prior_z else (x,)
            with torch.no_grad():
                out[dev] = t.model(*[a.to(dev) for a in args],
                                   **{k: v.to(dev) for k, v in noise.items()})
        errs = {k: float((out[DEVICE][k].cpu() - v).abs().max())
                / max(1.0, float(v.abs().max()))
                for k, v in out["cpu"].items()}
        worst = max(worst, max(errs.values()))
        print(f"[last-card-vs-cpu] {name} forward, 8 slices, float32: "
              f"max|d| / max(1, max|output|) "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        check(max(errs.values()) <= TOL, f"{name} forward differs: {errs}")
    pool = np.asarray(healthy.slices("TRAIN"), np.float32)
    idxs = epoch_indices(np.random.default_rng((SEED + 1, 0)), len(pool),
                         2)[:3]
    rel = {}
    for name, phase in (("constrainedAAE_Chen", 6), ("fAnoGAN", 0),
                        ("fAnoGAN", 1), ("fAnoGAN_schlegl", 0),
                        ("AnoVAEGAN", 0)):
        rel[f"{name} {phase}"] = gan_batch_card_vs_cpu(name, phase, pool,
                                                       idxs)
    return worst, max(rel.values())


def step_flops(trainer, pool):
    """The FLOPs of one training step on the first batch of ``pool``: each
    operator that ``torch.utils.flop_counter`` has a formula for (matrix
    products and convolutions, forward and backward, the penalties' double
    backwards included), counted by a dispatch mode.  ``FlopCounterMode``
    itself cannot count a step: its module hooks refuse the penalty's
    ``autograd.grad`` on a leaf."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Counter(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.total += formula(*args, **kwargs, out_val=out)
            return out

    batch = {"x": pool["x"][:trainer.config.batchsize]}
    with Counter() as counter:
        trainer.train_step(batch)
    return counter.total


def phase_last_timings(cudnn_tf32, matmul_tf32, chen_wd):
    """h. Warm train slices/s at batch 8 of each of GAN_TIMINGS (fAnoGAN in
    each phase) with each step's FLOPs and the rate they make; the warm
    ``constrainedAAE_Chen`` ``evaluate()`` split; profiles queued."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch import Config
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import preset
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    _, options, healthy, cohort = lesion_cohort("constrainedAAE_Chen")
    pool = device_pool(healthy)
    sps, rates = {}, {}
    for label, name, phase, steps, profiled in GAN_TIMINGS:
        c = preset(name)
        t = get_trainer(c.trainer)(c, device=DEVICE)
        t.init_state()
        t.epoch = c.numEpochs * phase if c.trainer == "fAnoGAN" else phase
        flops = step_flops(t, pool)
        sps[label] = warm_train(t, pool, c.seed, label, steps, profiled)
        rates[label] = flops * sps[label] / c.batchsize / 1e12
        print(f"[timing] {label}: {flops / 1e12:.3f} TFLOP per step of batch "
              f"{c.batchsize} -> {rates[label]:.1f} TFLOP/s, "
              f"{100 * rates[label] / H100_BF16_TFLOPS:.1f} % of the dense "
              f"bf16 peak {H100_BF16_TFLOPS:.0f} TFLOP/s")
    with open(os.path.join(chen_wd, "config.json")) as f:
        chen_config = Config.from_json(f.read())
    options = timing_options(options)
    t = get_trainer(chen_config.trainer)(chen_config, options,
                                         workdir=chen_wd, device=DEVICE)
    check(t.load_checkpoint() is not None, "constrainedAAE_Chen checkpoint")
    total, split = warm_evaluate(cohort, t, options, chen_config,
                                 "constrainedAAE_Chen")
    return sps, rates, total, split


# ---------------------------------------------------------------------------
# phase 9i: the parallel layer (``--mesh-data``): NCCL at world 1 through
# the CLI, and two ranks on this one card over gloo


MESH_WORLD = 2
MESH_BATCH = 128  # the AE preset's batch, 64 rows per rank
MESH_CLI_BATCH = ("-b", "32")  # GAN_SLICES leave 80-96 TRAIN slices
MESH_TIMED_STEPS = 10
MESH_RECON_SLICES = 37  # odd: padded to 38, 19 rows per rank
MESH_TIMEOUT_S = 300


def torchrun_env(port):
    """``torchrun``'s environment for one rank of a world of one."""
    return {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_mesh_cli(base):
    """a. ``--preset AE --synthetic --device cuda --mesh-data 1`` through
    the CLI on GAN_SLICES (batch 32, 1 epoch) with torchrun's environment
    for one rank: the CLI joins an NCCL group of one (the backend it
    passes to ``init_process_group`` is recorded), trains, evaluates and
    calibrates; one median launch per evaluated volume (3 x TEST + VAL);
    the group is gone afterwards."""
    import torch
    import torch.distributed as dist

    seen = []
    real_init = dist.init_process_group

    def spy(backend=None, *args, **kwargs):
        seen.append(backend)
        return real_init(backend, *args, **kwargs)

    saved = {k: os.environ.get(k) for k in torchrun_env(0)}
    os.environ.update(torchrun_env(free_port()))
    dist.init_process_group = spy
    try:
        wd, launches, _ = run_protocol(
            base, "AE", GAN_SLICES + MESH_CLI_BATCH + ("--mesh-data", "1"))
    finally:
        dist.init_process_group = real_init
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    backend = "nccl" if torch.device(DEVICE).type == "cuda" else "gloo"
    check(seen == [backend], f"process group backends {seen}, expected "
          f"{backend}")
    check(not dist.is_initialized(), "the CLI left its process group up")
    with open(os.path.join(wd, "config.json")) as f:
        mesh = json.load(f)["mesh"]
    check(mesh["data"] == 1, f"config.json mesh {mesh}")
    print(f"[mesh] --mesh-data 1 through the CLI: {backend} group of 1 "
          f"joined from torchrun's environment and left; {launches} median "
          f"launches; config.json mesh {mesh}")
    torch.cuda.synchronize()
    return launches


def gloo_accepts(world):
    """Which gloo collectives take a CUDA tensor as it is (True) or
    refuse it (the error)."""
    import torch
    import torch.distributed as dist

    t = torch.ones(4, device=DEVICE)
    ops = {"all_reduce": lambda: dist.all_reduce(t.clone()),
           "broadcast": lambda: dist.broadcast(t.clone(), 0),
           "all_gather": lambda: dist.all_gather(
               [torch.empty_like(t) for _ in range(world)], t)}
    out = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            out[name] = True
        except (RuntimeError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    return out


def mesh_inputs():
    """The seeded inputs both ranks and the one-process references use:
    the AE batch and the uneven reconstruction batch (numpy, CPU)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    c = ae_float32()
    shape = (c.outputHeight, c.outputWidth, 1)
    x = rng.uniform(size=(MESH_BATCH,) + shape).astype(np.float32)
    rec = rng.uniform(size=(MESH_RECON_SLICES,) + shape).astype(np.float32)
    return x, rec


def mesh_volume():
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    return torch.rand(SERVE_SHAPE, generator=g, device=DEVICE)


def ae_float32():
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import preset

    return preset("AE", batchsize=MESH_BATCH, dropout_rate=0.0,
                  compute_dtype="float32")


def aae_config():
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import preset

    return preset("AAE", batchsize=8, dropout_rate=0.0, learningrate=5e-5,
                  compute_dtype="float32")


def synced_ms(fn, n):
    """Median wall time of ``fn`` in ms, each call synchronised (the
    ranks' collectives are host round trips)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rank_worker(rank, world, workdir):
    """One of the ranks of phase 9i b, on this card over gloo (run as
    ``chip_smoke.py --rank-worker RANK WORLD DIR``): gloo's acceptance of
    CUDA tensors; the sharded median of SERVE_SHAPE (its launches counted);
    ``reconstruct_device`` of MESH_RECON_SLICES slices with MC dropout from
    the seeded init; one float32 AE step of its 64 rows and the AAE batch,
    each from the start state in DIR; then its warm times.  Writes
    DIR/rank_RANK.pt."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
        MeshConfig,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import median
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel import (
        make_mesh,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.collectives import (
        all_gather_batch,
        initialize_multihost,
        psum_mean,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.distributed_eval import (
        sharded_median_filter_3d,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_multihost(f"file://{os.path.join(workdir, 'init')}", world,
                         rank, backend="gloo", timeout_s=MESH_TIMEOUT_S)
    ctx = make_mesh(MeshConfig(data=world), devices=[DEVICE] * world)
    out = {"gloo": gloo_accepts(world)}

    vol = mesh_volume()
    local = ctx.shard_batch(vol)
    median.LAUNCHES = 0
    shard = sharded_median_filter_3d(ctx, local)
    torch.cuda.synchronize()
    out["median_launches"] = median.LAUNCHES
    whole = all_gather_batch(ctx, shard)
    out["median_equal"] = bool(torch.equal(
        whole, median.median_filter_3d_cuda(vol)))

    x, rec_x = mesh_inputs()
    ae = get_trainer("AE")(ae_float32(), mesh=ctx)
    ae.init_state()
    rec = ae.reconstruct_device(
        torch.from_numpy(rec_x), dropout=True,
        generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    out["recon"] = {k: v.cpu() for k, v in rec.items()}
    start = torch.load(os.path.join(workdir, "ae_start.pt"),
                       map_location=DEVICE, weights_only=True)
    ae.model.load_state_dict(start["model"])
    ae.optimizer.load_state_dict(start["optimizer"])
    metrics = ae.train_step(ctx.shard_batch({"x": x}))
    out["ae_loss"] = float(psum_mean(ctx, metrics["loss"]))
    out["ae_state"] = {k: v.to("cpu", copy=True)
                       for k, v in ae.model.state_dict().items()}

    start = torch.load(os.path.join(workdir, "aae_start.pt"),
                       map_location=DEVICE, weights_only=True)
    aae = get_trainer("AAE")(aae_config(), mesh=ctx)
    aae.init_state()
    aae.epoch = 6  # ae_iters 1
    aae.model.load_state_dict(start["model"])
    aae.optimizer.load_state_dict(start["optimizer"])
    for k, g in aae._streams().items():
        g.set_state(start[k].cpu())
    m = aae.train_step(ctx.shard_batch({"x": start["x"]}))
    keys = sorted(m)
    out["aae_losses"] = dict(zip(keys, (float(v) for v in psum_mean(
        ctx, torch.stack([m[k] for k in keys])))))
    out["aae_state"] = {k: v.to("cpu", copy=True)
                        for k, v in aae.model.state_dict().items()}

    batch = ctx.shard_batch({"x": x})
    out["step_ms"] = synced_ms(lambda: ae.train_step(batch),
                               MESH_TIMED_STEPS)
    out["sharded_median_ms"] = synced_ms(
        lambda: sharded_median_filter_3d(ctx, local), MESH_TIMED_STEPS)
    slab = torch.cat([local[:2], local, local[-2:]]).contiguous()
    out["slab_kernel_ms"] = cuda_ms(lambda: median.median_filter_3d_cuda(
        slab))
    torch.save(out, os.path.join(workdir, f"rank_{rank}.pt"))
    ctx.barrier()
    torch.distributed.destroy_process_group()


def aae_start(workdir):
    """The one-process AAE trainer on the card after 2 batches at batch 8
    (ae_iters 1), its state, optimizer and generators saved for the ranks
    with the third batch; returns the trainer (at that state) and the
    batch."""
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.engine import (
        epoch_indices,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    config = aae_config()
    _, _, healthy, _ = lesion_cohort("AAE")
    pool = np.asarray(healthy.slices("TRAIN"), np.float32)
    idxs = epoch_indices(np.random.default_rng((config.seed + 1, 0)),
                         len(pool), config.batchsize)[:3]
    t = get_trainer("AAE")(config, device=DEVICE)
    t.init_state()
    t.epoch = 6
    for rows in idxs[:2]:
        t.train_step({"x": torch.from_numpy(pool[rows]).to(DEVICE)})
    x = torch.from_numpy(pool[idxs[2]])
    torch.save({"model": t.model.state_dict(),
                "optimizer": t.optimizer.state_dict(),
                **{k: g.get_state() for k, g in t._streams().items()},
                "x": x}, os.path.join(workdir, "aae_start.pt"))
    return t, x


def phase_mesh_ranks(base):
    """b, c. MESH_WORLD ranks on this one card over gloo (which moves the
    collectives' tensors through the host; their times measure the ranks'
    correctness and host round trips, not data-parallel throughput),
    against one process on the card:
      * the sharded median of SERVE_SHAPE, each rank's (59, 128, 128) slab
        through ``csrc/median5.cu``, bit-equal to the whole-volume kernel;
      * one float32 AE step (TF32 off, batch 128 split 64 + 64; Adam's
        third, from the one-process state after 2 steps) within
        ``compare_training``'s bounds of the one-process step on the whole
        batch, the ranks' states bit-equal;
      * one AAE batch (batch 8, ae_iters 1, 20 critic updates) from the
        one-process state after 2 batches, every draw made for the whole
        batch from the same generators: losses within TOL or SPREAD_FACTOR
        x float32 rounding's spread, parameters within phase 9d's bounds;
      * ``reconstruct_device`` of MESH_RECON_SLICES slices with MC dropout
        within TOL of one process;
    and the times of the step, the median and the slab kernel per rank.
    Returns (median launches of the ranks' sharded calls, times)."""
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import median
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    workdir = tempfile.mkdtemp(dir=base)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the one-process references, made before the ranks share the card
    aae, aae_x = aae_start(workdir)
    start = {k: v.detach().clone() for k, v in aae.model.state_dict().items()}
    opt_start = copy.deepcopy(aae.optimizer.state_dict())
    gen_start = {k: g.get_state() for k, g in aae._streams().items()}

    def aae_batch(state):
        t = get_trainer("AAE")(aae_config(), device=DEVICE)
        t.init_state()
        t.epoch = 6
        t.model.load_state_dict(state)
        t.optimizer.load_state_dict(copy.deepcopy(opt_start))
        for k, g in t._streams().items():
            g.set_state(gen_start[k])
        m = t.train_step({"x": aae_x.to(DEVICE)})
        return t, {k: float(v) for k, v in m.items()}

    aae_ref, aae_m = aae_batch(start)
    spread = dict.fromkeys(aae_m, 0.0)
    pg = torch.Generator().manual_seed(SEED + 1)
    for _ in range(ROUNDING_RUNS):
        _, m = aae_batch({k: (v * (1 + 2 ** -23 * torch.randn(
            v.shape, generator=pg).to(DEVICE))) if v.is_floating_point()
            else v for k, v in start.items()})
        spread = {k: max(s, abs(m[k] - aae_m[k])) for k, s in spread.items()}
    x, rec_x = mesh_inputs()
    ae = get_trainer("AE")(ae_float32(), device=DEVICE)
    ae.init_state()
    rec_ref = ae.reconstruct_device(
        torch.from_numpy(rec_x), dropout=True,
        generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    # the compared step is Adam's third: its first moves every element by
    # lr, so a rounding-level gradient would flip whole updates
    for warm in (x[:, ::-1], x[:, :, ::-1]):
        ae.train_step({"x": torch.from_numpy(warm.copy()).to(DEVICE)})
    ae_start = {k: v.detach().clone() for k, v in ae.model.state_dict().items()}
    torch.save({"model": ae.model.state_dict(),
                "optimizer": ae.optimizer.state_dict()},
               os.path.join(workdir, "ae_start.pt"))
    ae_loss = float(ae.train_step({"x": torch.from_numpy(x).to(DEVICE)})[
        "loss"])
    ae_ref = {k: v.detach().clone() for k, v in ae.model.state_dict().items()}
    batch = {"x": torch.from_numpy(x).to(DEVICE)}
    one_step_ms = synced_ms(lambda: ae.train_step(batch), MESH_TIMED_STEPS)
    vol = mesh_volume()
    whole_ms = cuda_ms(lambda: median.median_filter_3d_cuda(vol))
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    procs = []
    for rank in range(MESH_WORLD):
        log = open(os.path.join(workdir, f"log_{rank}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-worker",
             str(rank), str(MESH_WORLD), workdir], cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT), log))
    try:
        codes = [p.wait(timeout=MESH_TIMEOUT_S) for p, _ in procs]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    ranks_s = time.perf_counter() - t0
    for rank, code in enumerate(codes):
        with open(os.path.join(workdir, f"log_{rank}.txt")) as f:
            text = f.read()
        check(code == 0, f"rank {rank} exited {code}: {text[-3000:]}")
    outs = [torch.load(os.path.join(workdir, f"rank_{r}.pt"),
                       weights_only=False) for r in range(MESH_WORLD)]
    print(f"[mesh] {MESH_WORLD} ranks on {DEVICE} over gloo: {ranks_s:.1f} s "
          f"wall (start-up, build check, every check and timing)")
    print(f"[mesh] gloo with CUDA tensors as they are: " + ", ".join(
        f"{k} {'accepted' if v is True else 'refused (' + v + ')'}"
        for k, v in outs[0]["gloo"].items())
        + "; the port's collectives, ring shifts included, use only "
          "these")

    launches = sum(o["median_launches"] for o in outs)
    check(all(o["median_launches"] == 1 for o in outs),
          f"sharded median launches per rank "
          f"{[o['median_launches'] for o in outs]}")
    check(all(o["median_equal"] for o in outs),
          "sharded median != the whole-volume kernel")
    for name in ("ae_state", "aae_state"):
        for k, v in outs[0][name].items():
            check(torch.equal(outs[1][name][k], v),
                  f"the ranks' {name} differ at {k}")
    a, b = outs[0]["ae_loss"], ae_loss
    check(abs(a - b) <= TOL * abs(b), f"AE loss world 2 {a} vs one {b}")
    config = ae_float32()
    _, worst_fed, worst, beyond, frac, upd = compare_training(
        {k: v.to(DEVICE) for k, v in outs[0]["ae_state"].items()}, {
            k: v.cpu() for k, v in ae_ref.items()},
        {k: v.cpu() for k, v in ae_start.items()}, config, 3)
    print(f"[mesh] AE step 3, float32, batch {MESH_BATCH} as 2 x "
          f"{MESH_BATCH // MESH_WORLD}: loss {a} vs one process {b}; "
          f"parameters max|diff| {worst:.3e}, {beyond} elements beyond 1e-5 "
          f"(largest share in one tensor {frac:.3e}), relative update error "
          f"{upd:.3e}; BN-fed conv biases max|diff| {worst_fed:.3e}")

    m2 = outs[0]["aae_losses"]
    over = {k: abs(m2[k] - v) / max(TOL * abs(v), SPREAD_FACTOR * spread[k])
            for k, v in aae_m.items()}
    print(f"[mesh] AAE batch (1 AE, 20 critic, 1 generator update), batch 8 "
          f"as 2 x 4: losses world 2 {m2}, one process {aae_m}; diff / "
          f"max(TOL, {SPREAD_FACTOR} x spread) "
          + ", ".join(f"{k} {v:.3f}" for k, v in over.items()))
    check(max(over.values()) <= 1.0, f"AAE losses differ: {over}")
    groups = aae_ref.groups

    def bound_of(k):
        steps = [3] + ([3] if k in groups["gen"] else []) + (
            list(range(41, 61)) if k in groups["disc"] else [])
        return 2 * aae_config().learningrate * sum(
            adam_step_bound(t, 0.5, 0.9) for t in steps) + 1e-6

    _, a_fed, a_worst, a_beyond, _, a_upd = compare_training(
        outs[0]["aae_state"], {k: v.cpu() for k, v in
                               aae_ref.model.state_dict().items()},
        {k: v.cpu() for k, v in start.items()}, aae_config(), 1, bound_of)
    print(f"[mesh] AAE batch: parameters max|diff| {a_worst:.3e}, "
          f"{a_beyond} elements beyond 1e-5, relative update error "
          f"{a_upd:.3e}; BN-fed conv biases max|diff| {a_fed:.3e}")

    rec_err = max(float((outs[0]["recon"][k] - v.cpu()).abs().max())
                  for k, v in rec_ref.items())
    check(set(outs[0]["recon"]) == set(rec_ref) and rec_err <= TOL,
          f"reconstruct_device world 2 vs one process: {rec_err}")
    print(f"[mesh] reconstruct_device of {MESH_RECON_SLICES} slices with MC "
          f"dropout (padded to {MESH_RECON_SLICES + 1}): max|d| vs one "
          f"process {rec_err:.3e}")

    times = {"one_step_ms": one_step_ms,
             "step_ms": max(o["step_ms"] for o in outs),
             "whole_median_ms": whole_ms,
             "sharded_median_ms": max(o["sharded_median_ms"] for o in outs),
             "slab_kernel_ms": max(o["slab_kernel_ms"] for o in outs)}
    print(f"[mesh] times: AE float32 step at batch {MESH_BATCH}, one process"
          f" {one_step_ms:.2f} ms, {MESH_WORLD} gloo ranks on one card "
          f"{times['step_ms']:.2f} ms (slowest rank, host wall clock, each "
          f"step synchronised; median of {MESH_TIMED_STEPS}); median of "
          f"{SERVE_SHAPE}: whole-volume kernel {whole_ms:.4f} ms (CUDA "
          f"events), sharded call per rank {times['sharded_median_ms']:.3f}"
          f" ms (host wall clock, halo exchange through gloo included), its "
          f"{(SERVE_SHAPE[0] // MESH_WORLD + 4,) + SERVE_SHAPE[1:]} slab "
          f"kernel alone {times['slab_kernel_ms']:.4f} ms (CUDA events)")
    return launches, times


def phase_mesh_timings(cudnn_tf32, matmul_tf32):
    """c. The AE preset's train step (bf16, batch 128) at world 1: no mesh
    against a one-rank mesh, which issues no collective; after WARM_STEPS
    each, in turns (plain, mesh, mesh, plain, twice), each sample the
    median of 2 x MESH_TIMED_STEPS synchronised steps."""
    import numpy as np
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import preset
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
        MeshConfig,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel import (
        make_mesh,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    x, _ = mesh_inputs()
    batch = {"x": torch.from_numpy(x).to(DEVICE)}
    one = make_mesh(MeshConfig(data=1), devices=[DEVICE])
    trainers = {}
    for name, ctx in (("no mesh", None), ("mesh 1", one)):
        t = get_trainer("AE")(preset("AE"), device=DEVICE, mesh=ctx)
        t.init_state()
        trainers[name] = t
    for t in trainers.values():
        for _ in range(WARM_STEPS):
            t.train_step(batch)
    times = {k: [] for k in trainers}
    for name in ("no mesh", "mesh 1", "mesh 1", "no mesh") * 2:
        t = trainers[name]
        times[name].append(synced_ms(lambda: t.train_step(batch),
                                     2 * MESH_TIMED_STEPS))
    print(f"[mesh] AE preset train step (bf16, batch 128), ms, in turns: "
          + "; ".join(f"{k} {', '.join(f'{v:.3f}' for v in vs)}"
                      for k, vs in times.items()))
    return {k: statistics.median(v) for k, v in times.items()}


# ---------------------------------------------------------------------------
# phase 9j: the last features: the space-to-depth stem and depth-to-space
# head through the CLI (``--tpu-fast``, with TensorBoard), tensor
# parallelism (two gloo ranks on this card at dp1 x tp2), ``validate-data``


TB_EVERY = 4  # --tb-every-n of the --tpu-fast protocol
TP_MODEL = 2  # the model axis of phase 9j-b's mesh (data 1)
FAST = dict(spaceToDepthStem=True, depthToSpaceHead=True)
EVAL_KEYS = ("diff_AUC", "diff_AUPRC", "bestDiceScore", "DiceScore")
# the one-volume evaluation under tensor parallelism against one process:
# the reconstructions differ by float32 round-off, so the metrics by less
EVAL_ATOL = 1e-3
EVAL_SLICES = (20, 130)  # the CLI's default slice range: 110 slices


def _proto_fields(buf):
    """(field, wire type, value) of a protocol buffer: an int for varint
    and fixed fields, bytes for length-delimited ones."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.tfrecord import (
        _read_varint,
    )

    view, pos = memoryview(buf), 0
    while pos < len(buf):
        key, pos = _read_varint(view, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(view, pos)
        elif wire == 1:
            value, pos = bytes(view[pos:pos + 8]), pos + 8
        elif wire == 5:
            value, pos = bytes(view[pos:pos + 4]), pos + 4
        elif wire == 2:
            n, pos = _read_varint(view, pos)
            value, pos = bytes(view[pos:pos + n]), pos + n
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, value


def read_events(directory):
    """The events files of one phase directory, read without TensorBoard
    (the card machine has none): every record's two masked CRC32Cs are
    checked, and the ``Event`` protos decoded into ({scalar tag: [(step,
    value)]}, {image tag: [(step, height, width)]}, file versions)."""
    import struct

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.tfrecord import (
        _masked_crc,
    )

    scalars, images, versions = {}, {}, []
    for name in sorted(os.listdir(directory)):
        check("tfevents" in name, f"{directory}: unexpected file {name}")
        with open(os.path.join(directory, name), "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            header = data[pos:pos + 8]
            (n,) = struct.unpack("<Q", header)
            (crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
            payload = data[pos + 12:pos + 12 + n]
            (pcrc,) = struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])
            check(crc == _masked_crc(header) and pcrc == _masked_crc(payload),
                  f"{name}: bad CRC at byte {pos}")
            pos += 16 + n
            step = 0
            for field, _, value in _proto_fields(payload):
                if field == 2:
                    step = value
                elif field == 3:
                    versions.append(value.decode())
                elif field == 5:
                    for _, _, v in _proto_fields(value):
                        tag, simple, image = None, None, None
                        for f2, _, v2 in _proto_fields(v):
                            if f2 == 1:
                                tag = v2.decode()
                            elif f2 == 2:
                                (simple,) = struct.unpack("<f", v2)
                            elif f2 == 4:
                                image = dict((f3, v3) for f3, _, v3 in
                                             _proto_fields(v2))
                        if image is not None:
                            check(image[4][:8] == b"\x89PNG\r\n\x1a\n",
                                  f"{tag}: not a PNG")
                            images.setdefault(tag, []).append(
                                (step, image[1], image[2]))
                        else:
                            scalars.setdefault(tag, []).append(
                                (step, simple))
    return scalars, images, versions


def check_events(wd, config, healthy):
    """The ``--tb-every-n`` run's event files: in ``logs/train`` the epoch's
    ``loss`` and ``reconstructionLoss`` at step 0 and every TB_EVERY-th
    global step's ``batch/`` scalars, each finite, and the grid at all of
    them (input | reconstruction | L1 side by side: 8 rows of 128 x 384);
    in ``logs/val`` the VAL epoch's scalars and grid at step 0."""
    import numpy as np

    n_batches = len(healthy.slices("TRAIN")) // config.batchsize
    batch_steps = [s for s in range(1, n_batches + 1) if s % TB_EVERY == 0]
    check(batch_steps, f"{n_batches} TRAIN batches, none logged")
    want = {"train": ({"loss": [0], "reconstructionLoss": [0],
                       "batch/loss": batch_steps,
                       "batch/reconstructionLoss": batch_steps},
                      sorted([0] + batch_steps))}
    if len(healthy.slices("VAL")) >= config.batchsize:
        want["val"] = ({"loss": [0], "reconstructionLoss": [0]}, [0])
    logs = os.path.join(wd, "logs")
    check(sorted(os.listdir(logs)) == sorted(want),
          f"TensorBoard phases {sorted(os.listdir(logs))}")
    seen = {}
    for phase, (tags, image_steps) in want.items():
        scalars, images, versions = read_events(os.path.join(logs, phase))
        check(versions == ["brain.Event:2"], f"{phase}: versions {versions}")
        got = {t: [s for s, _ in v] for t, v in scalars.items()}
        check(got == tags, f"{phase}: scalar steps {got}, expected {tags}")
        check(all(np.isfinite(v) for ev in scalars.values() for _, v in ev),
              f"{phase}: non-finite scalars {scalars}")
        grid = sorted(images.get("reconstruction", []))
        check([s for s, _, _ in grid] == image_steps
              and all((h, w) == (8 * config.outputHeight,
                                 3 * config.outputWidth)
                      for _, h, w in grid),
              f"{phase}: image grids {grid}, expected steps {image_steps}")
        seen[phase] = (sorted(tags), len(grid))
    return seen


def phase_tpu_fast(base, scan, cudnn_tf32, matmul_tf32):
    """a. ``--preset AE --synthetic --device cuda --tpu-fast --tb-every-n
    TB_EVERY`` through the CLI at the preset's width (128 x 128, batch 128,
    zDim 128, bf16; 1 epoch): the protocol's evaluations and threshold fit
    with one median launch per evaluated volume, ``model_dir`` tagged
    ``_s2d_d2s``, finite metrics, the event files' tags and steps
    (``check_events``), then ``infer``; the s2d/d2s AE forward card vs CPU
    in float32 (TF32 off) within TOL; warm train slices/s with
    ``--tpu-fast`` and with the parity architecture, in one call.
    Returns (median launches, forward max|d|, slices/s by label)."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import preset
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
        Config,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    sub = os.path.join(base, "tpu_fast")
    os.makedirs(sub)
    wd, launches, _ = run_protocol(
        sub, "AE", ("--tpu-fast", "--tb-every-n", str(TB_EVERY)))
    with open(os.path.join(wd, "config.json")) as f:
        config = Config.from_json(f.read())
    tag = config.model_dir("SYNTH")
    check(config.spaceToDepthStem and config.depthToSpaceHead
          and f"_{config.model}_s2d_d2s_" in tag,
          f"--tpu-fast config: stem {config.spaceToDepthStem}, head "
          f"{config.depthToSpaceHead}, model_dir {tag}")
    _, _, healthy, _ = lesion_cohort("AE")
    events = check_events(wd, config, healthy)
    print(f"[tpu-fast] model_dir {tag}; TensorBoard "
          + "; ".join(f"{p}: {tags}, {n} grids" for p, (tags, n)
                      in events.items()))
    launches += serve_once(wd, scan, os.path.join(sub, "served"))

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = get_trainer("AE")(preset("AE", compute_dtype="float32", **FAST),
                            device="cpu")
    cpu.init_state()
    card = copy.deepcopy(cpu.model).to(DEVICE).eval()
    cpu.model.eval()
    size = cpu.config.outputWidth
    x = torch.rand((8, size, size, 1),
                   generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        want = cpu.model(x)
        got = card(x.to(DEVICE))
    err = max(float((got[k].cpu() - v).abs().max()) for k, v in want.items())
    check(err <= TOL, f"s2d/d2s AE forward card vs CPU: max|d| {err}")
    print(f"[tpu-fast] s2d/d2s AE forward, float32, TF32 off, batch 8: "
          f"card vs CPU max|d| {err:.3e}")

    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    pool = device_pool(healthy)
    sps = {}
    for label, flags in (("AE parity", {}), ("AE --tpu-fast", FAST)):
        t = get_trainer("AE")(preset("AE", **flags), device=DEVICE)
        t.init_state()
        sps[label] = warm_train(t, pool, config.seed, label,
                                profiled_steps=10)
    return launches, err, sps


def one_volume_cohort():
    """A lesioned phantom cohort whose TEST split is one volume of the
    EVAL_SLICES range at the AE preset's width, as the CLI's cohort builds
    its volumes."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.synthetic import (
        SYNTH,
        SyntheticOptions,
    )

    size = ae_float32().outputWidth
    return SYNTH(SyntheticOptions(
        numPatients=2, imageSize=size, numSlices=EVAL_SLICES[1] -
        EVAL_SLICES[0], targetSize=size, withLesions=True, seed=99,
        partition={"TRAIN": 0.0, "VAL": 0.5, "TEST": 0.5}))


def eval_options(base):
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import (
        Options,
        PathConfig,
    )

    return Options(paths=PathConfig(sample_dir=os.path.join(base, "samples")),
                   sliceStart=EVAL_SLICES[0], sliceEnd=EVAL_SLICES[1],
                   exportPNGs=False, exportVolumes=False)


def tp_worker(rank, world, workdir):
    """One of the ranks of phase 9j-b, on this card over gloo (run as
    ``chip_smoke.py --tp-worker RANK WORLD DIR``) at dp1 x tp2: from the
    whole start state in DIR (cut to the rank's shards), ``evaluate()`` of
    one volume (its median launches counted) and ``reconstruct_device`` of
    MESH_RECON_SLICES slices, one float32 AE step of the whole batch, the
    checkpoint of it (whole tensors, written by rank 0), then the step's
    warm time.  Writes DIR/tp_RANK.pt."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
        MeshConfig,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate import (
        evaluate,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import median
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel import (
        make_mesh,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.collectives import (
        initialize_multihost,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_multihost(f"file://{os.path.join(workdir, 'init')}", world,
                         rank, backend="gloo", timeout_s=MESH_TIMEOUT_S)
    ctx = make_mesh(MeshConfig(data=world // TP_MODEL, model=TP_MODEL),
                    devices=[DEVICE] * world)
    config = ae_float32()
    ae = get_trainer("AE")(config, mesh=ctx,
                           workdir=os.path.join(workdir, "tp_wd"))
    ae.init_state()
    start = torch.load(os.path.join(workdir, "ae_start.pt"),
                       map_location=DEVICE, weights_only=True)
    ae._load_model_state(start["model"])
    ae._load_optimizer_state(start["optimizer"])
    out = {"layout": (ctx.data_index, ctx.model_index),
           "sharded": sum(getattr(m, "tp", None) is not None
                          for m in ae.model.modules()),
           "layers": sum(hasattr(m, "tp") for m in ae.model.modules())}
    median.LAUNCHES = 0
    res = evaluate(one_volume_cohort(), ae, eval_options(workdir), config)
    out["eval_launches"] = median.LAUNCHES
    out["eval"] = {k: float(res[k]) for k in EVAL_KEYS}
    x, rec_x = mesh_inputs()
    out["recon"] = ae.reconstruct_device(torch.from_numpy(rec_x))[
        "reconstruction"].cpu()
    batch = {"x": torch.from_numpy(x).to(DEVICE)}
    out["loss"] = float(ae.train_step(batch)["loss"])
    out["state"] = {k: v.to("cpu", copy=True)
                    for k, v in ae._whole_model_state().items()}
    ae.save_checkpoint(1)
    out["step_ms"] = synced_ms(lambda: ae.train_step(batch),
                               MESH_TIMED_STEPS)
    torch.save(out, os.path.join(workdir, f"tp_{rank}.pt"))
    ctx.barrier()
    torch.distributed.destroy_process_group()


def phase_tp_ranks(base):
    """b. Tensor parallelism: MESH_WORLD ranks on this one card over gloo
    as a (data 1, model TP_MODEL) mesh (correctness and host round trips,
    not throughput), against one process on the card, AE at 128 x 128,
    batch 128, float32, TF32 off:
      * ``evaluate()`` of one 110-slice volume from the same start state
        (one median launch per rank) within EVAL_ATOL of one process, and
        ``reconstruct_device`` of MESH_RECON_SLICES slices within TOL;
      * Adam's third step within ``compare_training``'s bounds of the
        one-process step, the ranks' gathered states bit-equal;
      * the ranks' checkpoint restored in one process bit-equal to their
        gathered state;
    and the step's time beside one process's.  Returns (median launches,
    times)."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate import (
        evaluate,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import median
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    workdir = tempfile.mkdtemp(dir=base)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = ae_float32()
    x, rec_x = mesh_inputs()
    ae = get_trainer("AE")(config, device=DEVICE)
    ae.init_state()
    for warm in (x[:, ::-1], x[:, :, ::-1]):
        ae.train_step({"x": torch.from_numpy(warm.copy()).to(DEVICE)})
    start = {k: v.detach().clone() for k, v in ae.model.state_dict().items()}
    torch.save({"model": ae.model.state_dict(),
                "optimizer": ae.optimizer.state_dict()},
               os.path.join(workdir, "ae_start.pt"))
    # the one-process references (their median launch is a comparison's,
    # not counted)
    saved = median.LAUNCHES
    res = evaluate(one_volume_cohort(), ae, eval_options(workdir), config)
    median.LAUNCHES = saved
    eval_ref = {k: float(res[k]) for k in EVAL_KEYS}
    rec_ref = ae.reconstruct_device(torch.from_numpy(rec_x))[
        "reconstruction"].cpu()
    batch = {"x": torch.from_numpy(x).to(DEVICE)}
    loss_ref = float(ae.train_step(batch)["loss"])
    ref = {k: v.to("cpu", copy=True) for k, v in ae.model.state_dict().items()}
    one_step_ms = synced_ms(lambda: ae.train_step(batch), MESH_TIMED_STEPS)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    procs = []
    for rank in range(MESH_WORLD):
        log = open(os.path.join(workdir, f"tp_log_{rank}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tp-worker",
             str(rank), str(MESH_WORLD), workdir], cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT), log))
    try:
        codes = [p.wait(timeout=MESH_TIMEOUT_S) for p, _ in procs]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    ranks_s = time.perf_counter() - t0
    for rank, code in enumerate(codes):
        with open(os.path.join(workdir, f"tp_log_{rank}.txt")) as f:
            text = f.read()
        check(code == 0, f"tp rank {rank} exited {code}: {text[-3000:]}")
    outs = [torch.load(os.path.join(workdir, f"tp_{r}.pt"),
                       weights_only=False) for r in range(MESH_WORLD)]
    check([o["layout"] for o in outs] == [(0, m) for m in range(TP_MODEL)],
          f"mesh layout {[o['layout'] for o in outs]}")
    print(f"[tp] {MESH_WORLD} ranks on {DEVICE} over gloo as data 1 x model "
          f"{TP_MODEL}: {ranks_s:.1f} s wall; {outs[0]['sharded']} of "
          f"{outs[0]['layers']} conv/dense layers column parallel")

    launches = sum(o["eval_launches"] for o in outs)
    check(all(o["eval_launches"] == 1 for o in outs),
          f"median launches per rank {[o['eval_launches'] for o in outs]}")
    diff = {k: max(abs(o["eval"][k] - v) for o in outs)
            for k, v in eval_ref.items()}
    check(max(diff.values()) <= EVAL_ATOL,
          f"evaluate() under tensor parallelism {outs[0]['eval']} vs one "
          f"process {eval_ref}")
    rec_err = max(float((o["recon"] - rec_ref).abs().max()) for o in outs)
    check(rec_err <= TOL, f"reconstruct_device tp vs one process {rec_err}")
    print(f"[tp] evaluate() of one {EVAL_SLICES[1] - EVAL_SLICES[0]}-slice "
          f"volume: {outs[0]['eval']} vs "
          f"one process {eval_ref} (max|d| {max(diff.values()):.3e}); "
          f"reconstruct_device of {MESH_RECON_SLICES} slices max|d| "
          f"{rec_err:.3e}")
    for k, v in outs[0]["state"].items():
        check(torch.equal(outs[1]["state"][k], v),
              f"the ranks' gathered states differ at {k}")
    a = outs[0]["loss"]
    check(abs(a - loss_ref) <= TOL * abs(loss_ref),
          f"AE loss tp {a} vs one process {loss_ref}")
    _, worst_fed, worst, beyond, frac, upd = compare_training(
        {k: v.to(DEVICE) for k, v in outs[0]["state"].items()}, ref,
        {k: v.cpu() for k, v in start.items()}, config, 3)
    print(f"[tp] AE step 3, float32, batch {MESH_BATCH} on both ranks: loss "
          f"{a} vs one process {loss_ref}; parameters max|diff| "
          f"{worst:.3e}, {beyond} elements beyond 1e-5 (largest share in "
          f"one tensor {frac:.3e}), relative update error {upd:.3e}; "
          f"BN-fed conv biases max|diff| {worst_fed:.3e}")
    one = get_trainer("AE")(config, device=DEVICE,
                            workdir=os.path.join(workdir, "tp_wd"))
    check(one.restore_training_checkpoint() == 1,
          "no checkpoint from the tensor-parallel ranks")
    for k, v in one.model.state_dict().items():
        check(torch.equal(v.cpu(), outs[0]["state"][k]),
              f"the tensor-parallel checkpoint loads differently at {k}")
    times = {"one_step_ms": one_step_ms,
             "tp_step_ms": max(o["step_ms"] for o in outs)}
    print(f"[tp] checkpoint of the ranks restored in one process bit-equal; "
          f"AE float32 step at batch {MESH_BATCH}: one process "
          f"{one_step_ms:.2f} ms, dp1 x tp{TP_MODEL} on one card "
          f"{times['tp_step_ms']:.2f} ms (slowest rank, host wall clock, "
          f"each step synchronised; median of {MESH_TIMED_STEPS})")
    return launches, times


def brainweb_tree(root, size=24, depth=30):
    """A BrainWeb-layout phantom tree: crisp label groundtruths and two
    normal and two severe-lesion T2 volumes (MINC1)."""
    import numpy as np

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.formats import (
        write_minc1,
    )

    rng = np.random.default_rng(SEED)
    gt = os.path.join(root, "groundtruth")
    os.makedirs(gt)
    labels = np.zeros((size, size, depth))
    labels[4:20, 4:20, 5:25] = 3
    labels[8:16, 8:16, 10:20] = 2
    labels[0:3] = 7
    lesions = labels.copy()
    lesions[10:13, 10:13, 12:16] = 10
    write_minc1(os.path.join(gt, "normal.mnc.gz"), labels)
    for sev in ("mild", "moderate", "severe"):
        write_minc1(os.path.join(gt, f"{sev}_lesions.mnc.gz"), lesions)
    for folder, tag in (("normal", "normal"),
                        (os.path.join("lesions", "severe"), "msles3")):
        os.makedirs(os.path.join(root, folder))
        for i in range(2):
            vol = rng.uniform(0, 0.2, (size, size, depth))
            vol[labels > 0] += 0.5
            if tag != "normal":
                vol[lesions == 10] = 1.0
            write_minc1(os.path.join(root, folder,
                                     f"t2_{tag}_p{i}_pn0_rf0.mnc.gz"), vol)


def phase_validate_data(base):
    """c. ``validate-data -d BRAINWEB --dir D --deep`` through the CLI on a
    BrainWeb-layout phantom tree (exit 0, 4 patients) and on an empty
    directory (a non-zero exit with the layout hint)."""
    import contextlib
    import io

    from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli

    root = tempfile.mkdtemp(dir=base)
    tree, empty = os.path.join(root, "bw"), os.path.join(root, "empty")
    os.makedirs(empty)
    brainweb_tree(tree)
    rcs, texts = [], []
    for d in (tree, empty):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rcs.append(cli.main(["validate-data", "-d", "BRAINWEB", "--dir",
                                 d, "--deep"]))
        texts.append(buf.getvalue())
    check(rcs[0] == 0 and "[OK] BRAINWEB" in texts[0]
          and "patients discovered: 4" in texts[0],
          f"validate-data on the tree: rc {rcs[0]}\n{texts[0]}")
    check(rcs[1] != 0 and "expected layout" in texts[1],
          f"validate-data on an empty directory: rc {rcs[1]}\n{texts[1]}")
    print(f"[validate-data] BrainWeb phantom tree: exit {rcs[0]}, "
          + texts[0].strip().replace("\n", " |") + f"; empty directory: "
          f"exit {rcs[1]}")


# ---------------------------------------------------------------------------
# phase 9k: the all-preset sweep (``run_all``) at the quality tables'
# recipe, checked against the port's H100 tables

SWEEP_RECIPE = ("--synthetic", "-E", "1", "-w", "32", "-g", "32", "-s", "0",
                "-e", "8", "-z", "16", "-b", "8", "-O", "0.5",
                "--precision", "float32")
JAX_TABLES = (("JAX CPU", "scoreboard_expected.json"),
              ("JAX TPU v5e (not a target)", "scoreboard_expected_tpu.json"))
JAX_FAST_TABLES = (("JAX TPU v5e fast (not a target)",
                    "scoreboard_expected_tpu_fast.json"),)


def sweep_launches(presets):
    """The median launches a sweep makes, counted from the recipe's lesion
    cohort as ``run_protocol`` does: with a threshold (``-O``) the CLI
    evaluates the TEST volumes once at it, otherwise 3 x TEST + VAL."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import (
        Dataset,
        Options,
        build_dataset,
        preset,
    )

    recipe = dict(zip(SWEEP_RECIPE[1::2], SWEEP_RECIPE[2::2]))
    options = Options(sliceStart=int(recipe["-s"]),
                      sliceEnd=int(recipe["-e"]))
    total = 0
    for name in presets:
        config = preset(name).replace(outputWidth=int(recipe["-w"]),
                                      outputHeight=int(recipe["-g"]))
        cohort = build_dataset(options, config, Dataset.SYNTH,
                               "pathological")
        n_test = len(cohort.patients_of("TEST"))
        total += n_test if "-O" in recipe else (
            3 * n_test + len(cohort.patients_of("VAL")))
    return total


def phase_sweep(base, fast):
    """k. ``run_all --device cuda`` over the 18 presets at the recipe with
    ``--check`` against ``expected_h100.json`` (``--tpu-fast``:
    ``expected_h100_fast.json``); a failed check raises.  The median is
    launched once per evaluated volume.  Prints each preset's wall time
    and four metrics, then each beside the port's CPU table and the JAX
    tables.  Returns (median launches, sweep wall in s)."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch import run_all
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
        EXPERIMENT_PRESETS,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import median

    presets = list(EXPERIMENT_PRESETS)
    label = "tpu-fast" if fast else "parity"
    table = os.path.join(run_all.SCOREBOARDS, "expected_h100_fast.json"
                         if fast else "expected_h100.json")
    root = tempfile.mkdtemp(dir=base)
    paths = os.path.join(root, "paths.json")
    with open(paths, "w") as f:
        json.dump({"SAMPLEDIR": os.path.join(root, "samples"),
                   "CHECKPOINTDIR": os.path.join(root, "checkpoints")}, f)
    board = os.path.join(root, "scoreboard.json")
    expected = sweep_launches(presets)
    median.LAUNCHES = 0
    t0 = time.perf_counter()
    rc = run_all.main(["--presets", ",".join(presets), "--scoreboard", board,
                       "--check", table, *SWEEP_RECIPE, "--device", DEVICE,
                       "-c", paths, *(["--tpu-fast"] if fast else [])])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = median.LAUNCHES
    check(rc == 0, f"run_all {label} sweep exited {rc} (quality check "
                   f"against {os.path.relpath(table, ROOT)} or a preset "
                   "failed)")
    check(launches == expected, f"{label} sweep: median launched {launches} "
                                f"times for {expected} evaluated volumes")
    with open(board) as f:
        sb = json.load(f)
    others = [("port CPU" + (" parity" if fast else ""),
               os.path.join(run_all.SCOREBOARDS, "expected_cpu.json"))]
    others += [(k, os.path.join(ROOT, "examples", v))
               for k, v in (JAX_FAST_TABLES if fast else JAX_TABLES)]
    tables = {}
    for k, path in others:
        with open(path) as f:
            tables[k] = json.load(f)["presets"]

    def fmt(row):
        return " / ".join("-" if row.get(k) is None else f"{row[k]:.4f}"
                          for k in run_all.METRIC_KEYS)

    print(f"[sweep {label}] {len(presets)} presets through run_all "
          f"--device {DEVICE}, checked against "
          f"{os.path.relpath(table, ROOT)}: {wall:.1f} s; median launches "
          f"{launches}; metrics AUROC / AUPRC / bestDice / finalTrainLoss")
    for name in presets:
        print(f"[sweep {label}] {name}: {sb['_wall_s'][name]:.1f} s; "
              f"{fmt(sb[name][0])}")
    for name in presets:
        print(f"[sweep {label}] {name}: H100 {fmt(sb[name][0])} | "
              + " | ".join(f"{k} {fmt(t[name])}" for k, t in tables.items()
                           if name in t))
    return launches, wall


def phase_profiles():
    """10. The queued profiles, after every timing: printed, kept in
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
    # phase 9k's sweep runs deterministic kernels (run_all.reproducible);
    # cuBLAS reads its workspace setting when the first handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if len(sys.argv) == 5 and sys.argv[1] in ("--rank-worker",
                                              "--tp-worker"):
        sys.path.insert(0, ROOT)
        worker = rank_worker if sys.argv[1] == "--rank-worker" \
            else tp_worker
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return

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
    kern = timed_phase("2 kernel", phase_kernel)
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
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        spatial_wd, spatial_launches, gm_sweep_s, gm_lam = timed_phase(
            "9a GMVAE_spatial", phase_gmvae_spatial, tmp, scans[0])
        launches += spatial_launches
        launches += timed_phase("9b GMVAE_You + AAE", phase_gmvae_you_and_aae,
                                tmp, scans[0])
        fam_fwd, aae_rel, gm_restore = timed_phase(
            "9d families card vs cpu", phase_families_card_vs_cpu)
        fam_sps, gm_eval_ms, gm_split = timed_phase(
            "9e families timings", phase_families_timings, *tf32, spatial_wd)
        last_launches, last_wds = timed_phase(
            "9f ResNet + image critics", phase_last_presets, tmp, scans[0])
        launches += last_launches
        last_fwd, last_rel = timed_phase(
            "9g ResNet + image critics card vs cpu", phase_last_card_vs_cpu)
        last_sps, last_rates, chen_eval_ms, chen_split = timed_phase(
            "9h ResNet + image critics timings", phase_last_timings, *tf32,
            last_wds["constrainedAAE_Chen"])
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        launches += timed_phase("9i-a mesh 1 through the CLI (NCCL)",
                                phase_mesh_cli, tmp)
        mesh_launches, mesh_times = timed_phase(
            "9i-b mesh 2 ranks on one card (gloo)", phase_mesh_ranks, tmp)
        launches += mesh_launches
        mesh1_ms = timed_phase("9i-c mesh 1 step timings",
                               phase_mesh_timings, *tf32)
        fast_launches, fast_err, fast_sps = timed_phase(
            "9j-a AE --tpu-fast through the CLI", phase_tpu_fast, tmp,
            scans[0], *tf32)
        launches += fast_launches
        tp_launches, tp_times = timed_phase(
            "9j-b tensor parallel, 2 ranks on one card (gloo)",
            phase_tp_ranks, tmp)
        launches += tp_launches
        timed_phase("9j-c validate-data", phase_validate_data, tmp)
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        sweep_walls = {}
        for fast in (False, True):
            sweep_l, sweep_walls["tpu-fast" if fast else "parity"] = \
                timed_phase(f"9k sweep ({'--tpu-fast' if fast else 'parity'})",
                            phase_sweep, tmp, fast)
            launches += sweep_l
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        busy = timed_phase("10 profiles", phase_profiles)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(os.path.join(base, "timing"), ignore_errors=True)
    check("jax" not in sys.modules, "jax was imported")
    print(f"[summary] build {build_s:.2f} s, median kernel {kern['ms']:.4f} "
          f"ms (served map {kern['served_ms']:.4f} ms) vs plain "
          f"{kern['plain_ms']:.4f} ms, warm detect {detect_ms:.3f} ms, "
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
    print(f"[summary] GMVAE and AAE families: warm train "
          + ", ".join(f"{k} {v:.1f} slices/s (device busy "
                      f"{100 * busy[k + ' train']:.1f} %)"
                      for k, v in fam_sps.items())
          + f"; GMVAE_spatial lambda {gm_lam}, sweep {gm_sweep_s:.2f} s cold;"
          f" warm GMVAE_spatial evaluate() {gm_eval_ms:.1f} ms for the TEST "
          f"cohort (" + ", ".join(f"{p} {v:.1f} ms"
                                  for p, v in gm_split.items())
          + f"; device busy {100 * busy['GMVAE_spatial evaluate']:.1f} %); "
          f"card vs CPU: forwards max|d| {fam_fwd:.3e}, AAE batch losses "
          f"max relative diff {aae_rel:.3e}, GMVAE 3-step restoration max|d| "
          f"{gm_restore:.3e}")
    print(f"[summary] ResNet and image-critic presets: warm train "
          + ", ".join(f"{k} {v:.1f} slices/s ({last_rates[k]:.1f} TFLOP/s, "
                      f"device busy {100 * busy[k + ' train']:.1f} %)"
                      for k, v in last_sps.items())
          + f"; warm constrainedAAE_Chen evaluate() {chen_eval_ms:.1f} ms for "
          f"the TEST cohort (" + ", ".join(f"{p} {v:.1f} ms"
                                           for p, v in chen_split.items())
          + f"; device busy {100 * busy['constrainedAAE_Chen evaluate']:.1f} "
          f"%); card vs CPU: forwards max|d| {last_fwd:.3e}, adversarial "
          f"batch losses max relative diff {last_rel:.3e}")
    print(f"[summary] parallel layer: AE step (float32, batch 128) one "
          f"process {mesh_times['one_step_ms']:.2f} ms, {MESH_WORLD} gloo "
          f"ranks on one card {mesh_times['step_ms']:.2f} ms (host round "
          f"trips, not data-parallel throughput); AE preset step (bf16) no "
          f"mesh {mesh1_ms['no mesh']:.3f} ms, --mesh-data 1 "
          f"{mesh1_ms['mesh 1']:.3f} ms; median of {SERVE_SHAPE} whole "
          f"{mesh_times['whole_median_ms']:.4f} ms, sharded per rank "
          f"{mesh_times['sharded_median_ms']:.3f} ms (slab kernel "
          f"{mesh_times['slab_kernel_ms']:.4f} ms); median launches "
          f"{launches} in all")
    print(f"[summary] last features: warm AE train "
          + ", ".join(f"{k} {v:.1f} slices/s (device busy "
                      f"{100 * busy[k + ' train']:.1f} %)"
                      for k, v in fast_sps.items())
          + f"; s2d/d2s forward card vs CPU max|d| {fast_err:.3e}; AE "
          f"float32 step one process {tp_times['one_step_ms']:.2f} ms, dp1 x "
          f"tp{TP_MODEL} on one card {tp_times['tp_step_ms']:.2f} ms")
    print(f"[summary] all-preset sweep at the quality tables' recipe: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in sweep_walls.items())
          + "; every preset within the port's H100 tables")
    print(json.dumps({"kernels": [{
        "name": "median5",
        "route": "cuda",
        "source": f"{PKG}/csrc/median5.cu",
        "replaces": "unsupervised_anomaly_detection_brain_mri_tpu/ops/"
                    "pallas_median.py:94",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": "bytes",
        "library_ms": kern["library_ms"],
        "served_ms": kern["served_ms"],
        "batched_ms": kern["batched_ms"],
        "served_batched_ms": kern["served_batched_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
