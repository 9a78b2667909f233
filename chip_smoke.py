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
     scores within 1e-4, masks equal except within 1e-4 of the threshold.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

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


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        raise SystemExit(f"chip_smoke.py: {PKG}/ not found next to this "
                         f"script; run it from a checkout of the repository")
    sys.path.insert(0, ROOT)

    build_s = phase_device()
    max_err, kernel_ms, plain_ms = phase_kernel()
    base = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(base, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=base)
    try:
        wd, scans = make_workdir(tmp)
        launches, detect_ms = phase_serve(wd, scans)
        phase_card_vs_cpu(wd, scans)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check("jax" not in sys.modules, "jax was imported")
    print(f"[summary] build {build_s:.2f} s, median kernel {kernel_ms:.4f} ms "
          f"vs plain {plain_ms:.4f} ms, warm detect {detect_ms:.3f} ms")
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
