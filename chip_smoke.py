#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It checks the port on the card.  The only times it takes are those of each
hand-written kernel alone, by CUDA events (phases 2, 2b, 2c and 9i-b), and
the device time of phase 2b's profiles; the end-to-end speed of training and
serving is the benchmark's (``BENCHMARK.json``).

Phases (any failed check raises, and the script exits non-zero without its
last line; a number that is gone went with a phase that only timed):
  1. device: the card's name and power limit, torch/CUDA versions, and the
     kernel build from ``csrc/`` (nvcc, sm_90a);
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
  2b. components: the kernel chain of ``ops/ccl.py`` (``csrc/ccl3d.cu``)
     must equal the plain propagation (run to its fixpoint) at CC_SHAPE
     (181, 128, 128), labels and size filter, on lesion blobs and on random
     masks at densities 0.1 and 0.5; warm times by CUDA events of the
     chain's size filter (one call a sample, and batched) and of the plain
     version's (its rounds' syncs included), with the plain version's
     rounds and the bytes bound; a profile of one call of each is queued
     for phase 10;
  2c. stem input gradient: ``stem_input_grad_cuda`` (``csrc/stem_dgrad.cu``)
     must match the plain version on NCHW bf16 grad_out as a restoration
     hands it, at STEM_SHAPES (the served 181 slices of 128x128, and an
     odd shape): within one bf16 ulp plus 2^-15 of the summed magnitudes
     of the products, and at least 99.9 % of the values equal; warm times
     by CUDA events of the kernel (one call a sample, and batched), of the
     plain version and of cuDNN's input gradient alone through
     ``aten.convolution_backward`` (the ``library_ms`` yardstick; the port
     no longer calls it for a restoration), and the bytes bound;
  3. serve: a full-width ``AE`` workdir (128x128 slices, zDim 128, seeded
     Glorot init, bf16 compute) with a fixed calibrated threshold serves 3
     lesioned 110-slice phantoms through ``infer --device cuda``, then one
     through ``detect``;
  4. card vs CPU: one request through the same workdir in float32 (TF32
     off) on the card and on the CPU (plain versions); anomaly map and
     scores within 1e-4, masks equal except within 1e-4 of the threshold;
  5. train + evaluate: the port's CLI ``--preset AE --synthetic --device
     cuda`` at full width (2 epochs, bf16, batch 128) trains, evaluates with
     and without the prior, fits and writes the threshold, evaluates at it,
     and writes ``--metrics-out``; losses finite and falling, checkpoints,
     ``calibration.json`` and finite AUROC/AUPRC/Dice in every
     ``evalPC.json``; the median must be launched exactly once per volume
     the protocol evaluates (3 x TEST + VAL, counted from the dataset);
     then ``infer --device cuda`` serves the trained workdir;
  6. train card vs CPU: 5 Adam steps at 128x128, batch 8, float32, TF32 off,
     dropout 0, from the same init: free-running losses within 1e-3
     relative (float32 trajectories drift apart at (Leaky)ReLU kinks), and
     step by step from the CPU's state losses within 1e-4 relative and
     each tensor and its update within the bounds of ``compare_training``;
     the gradients of step 1's differing elements are printed, and each
     is told apart as rounding or a kink against float64 gradients on the
     CPU with each device's kink pattern (``flipped_gradients``; one that
     is neither fails);
  8. the VAE family at full width (128x128, zDim 128, intermediate
     resolution 8, bf16):
     a. ``--preset VAE_You -E 1`` through the CLI: training, the lambda
        sweep on the card (``tv_lambda.json`` with lambda in [0, 1.9]), 3
        evaluations and the threshold fit with batched 150-step
        restoration, then ``infer``, whose restoration launches the stem's
        input-gradient kernel once a step (150); b. ``--preset VAE -n 4``: MC
        evaluation and a served MC request whose epistemic variance is
        finite, positive inside the eroded brainmask and 0 outside;
        c. ``--preset ceVAE`` (gradient restoration) and train steps of
        ``STEP_PRESETS`` with finite losses; in a, b and c the median is
        launched exactly once per evaluated or served volume; d. card vs
        CPU in float32 with the same weights and noise: VAE and ceVAE
        forwards within TOL; the first FLIP_STEPS restoration steps
        from one input on both, with the voxels where the gradients
        differ and the subgradient sign flips that explain them; one
        150-step ``VAE_You`` restoration of a 110-slice volume within
        RESTORE_FLIP_STEPS x restore_lr;
  9. the GMVAE family and the latent-critic AAE family at full width
     (a-d: ``GMVAE_spatial``, ``GMVAE_You`` and ``AAE`` through the CLI,
     card vs CPU), then the ResNet stack and the image critics:
     f. ``constrainedAAE_Chen``, ``fAnoGAN`` (one WGAN and one encoder
     epoch), ``fAnoGAN_schlegl`` and ``AnoVAEGAN`` through the protocol
     and ``infer``, with each batch's updates per group counted; g. their
     forwards card vs CPU within TOL, and one batch of each adversarial
     schedule at batch 2 with 1 critic update, losses within SPREAD_FACTOR
     x float32 rounding's spread; i. the parallel layer: a. ``--preset AE
     --synthetic --device cuda --mesh-data 1`` through the CLI on 16
     slices per volume (batch 32, 1 epoch) with torchrun's environment for
     one rank: an NCCL group of one, one median launch per evaluated
     volume; b. two ranks on this one card over gloo (``chip_smoke.py
     --rank-worker RANK 2 DIR``): which gloo collectives take CUDA tensors,
     the sharded median of (110, 128, 128) (each rank's (59, 128, 128)
     slab through the kernel) bit-equal to the whole-volume kernel, one
     float32 AE step (batch 128 as 64 + 64) within ``compare_training``'s
     bounds of one process, one AAE batch within phase 9d's bounds,
     ``reconstruct_device`` of 37 slices with MC dropout within TOL, and
     the slab kernel's time and the whole volume's by CUDA events; j. the
     last features: a. ``--preset AE --synthetic --device cuda --tpu-fast
     --tb-every-n 4`` through the CLI at the preset's width (1 epoch, 3
     evaluations, threshold fit, one median launch per evaluated volume,
     ``infer``), ``model_dir`` tagged ``_s2d_d2s``, the TensorBoard event
     files read back (tags, steps, CRCs, grids) without TensorBoard, the
     s2d/d2s forward card vs CPU within TOL; b. tensor parallelism, two
     gloo ranks on this card at dp1 x tp2 (``chip_smoke.py --tp-worker
     RANK 2 DIR``), AE at 128 x 128, batch 128, float32: ``evaluate()`` of
     one volume (one median launch per rank) and a reconstruction against
     one process, one step within ``compare_training``'s bounds, its
     checkpoint restored in one process bit-equal; c. ``validate-data`` on
     a BrainWeb-layout phantom tree (exit 0) and on an empty directory
     (non-zero, with the layout hint); k. the all-preset sweep, ``run_all
     --device cuda`` at the quality tables' recipe (``--synthetic -E 1 -w
     32 -g 32 -s 0 -e 8 -z 16 -b 8 -O 0.5 --precision float32``, PyTorch's
     default TF32 state): all 18 presets with ``--check`` against
     ``scoreboards/expected_h100.json``, then all 18 with ``--tpu-fast``
     against ``expected_h100_fast.json``; one median launch per evaluated
     volume (at the recipe's ``-O 0.5`` the CLI evaluates the TEST volumes
     once); each preset's metrics beside the port's CPU table and the JAX
     tables (the TPU's labelled as such, not targets); l. the paper's
     real-data protocol: a. a fake BrainWeb server, passed as the opener
     to the port's ``download_brainweb_dataset``, writes BrainWeb's
     geometry (181x217x181 int16 MINC1, per-slice renormalised, gzipped;
     normal and msles3 at pn0/pn3/pn5 x rf20 with their crisp
     groundtruths), and MSLUB (6 patients) and MSISBI2015 (6) are written
     as NIfTI at 181x217x181 (``tests/_torch_realdata.py``); ``--preset AE
     -c paths -E 2 --device cuda`` without ``--synthetic`` (128x128, zDim
     128, slices 20-130, bf16) trains on BRAINWEB healthy, evaluates
     BRAINWEB, MSLUB and MSISBI2015 without and with the prior, fits the
     threshold on BRAINWEB VAL and evaluates at it: every metric row
     present and finite, one median launch per evaluated volume (3 x TEST
     + VAL, counted from the splits); ``infer --device cuda`` and
     ``detect`` of one MSISBI2015 scan with the calibration (one launch
     each); b. the code cells of ``examples/quickstart_torch.ipynb`` on the
     card, one median launch per evaluated volume; m. the measurement layer
     at a small size, four processes at once: ``bench_torch.py``
     (``BENCH_SMALL``) exits 0 with the headline line, every number finite,
     the median section through the CUDA kernel and equal to the plain
     version; ``tools/hbm_roofline_torch.py`` and
     ``tools/parity_stage_roofline_torch.py`` (parity and ``--fast``,
     ``TOOL_SMALL``) exit 0 with finite rows and the H100's ceilings;
     n. the seed spread of ``AAE``, ``fAnoGAN`` and ``AnoVAEGAN``: each
     from 5 init seeds through the CLI at the quality tables' recipe,
     ``--tpu-fast`` and parity, under ``run_all``'s deterministic
     settings (30 runs); each run printed beside the JAX package's CPU
     spread of its profile, and every metric's range over the seeds must
     overlap that spread widened by the tables' tolerances; one median
     launch per evaluated volume;
 10. profiles, last (a ``torch.profiler`` session slows every later
     launch): a ``torch.profiler`` summary of phase 2b's queued calls (the
     device time and the count of kernels and copies, and the kernels with
     the most time), printed and kept in ``build/chip_smoke_profile.txt``.

The median's launches, the components' chain calls and the stem kernel's
launches are read from the port's trace counters ``median_kernel``,
``cc_kernel`` and ``stem_dgrad_kernel`` (``utils/trace.py``).  Every served
batch of requests (``infer`` and ``detect`` on the card) checks one median
launch and one call of the components' kernel chain a request.

The line before the last is ``{"kernels": [...]}`` (the median's
``launches`` on the main path; the components chain's ``calls`` on the
served requests, and its ``max_abs_err`` against the plain version; the
stem kernel's ``launches`` in the served ``VAE_You`` restoration); the
last is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import copy
import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "unsupervised_anomaly_detection_brain_mri_tpu_torch"
SEED = 0
SERVE_SHAPE = (110, 128, 128)
CC_SHAPE = (181, 128, 128)  # a served scan at the model's resolution
RAGGED_SHAPES = ((7, 37, 45), (2, 1, 5))
# the stem's (B, H, W) inputs: a served scan's slices, and an odd shape
STEM_SHAPES = ((181, 128, 128), (7, 37, 45))
N_REQUESTS = 3
THRESHOLD = 0.25
TOL = 1e-4
TRAIN_STEPS = 5
KINK_FRACTION = 3e-3
KINK_FLOOR = 3
UPDATE_TOL = 0.25
FREE_RUN_TOL = 1e-3
# a step's float32 gradients against float64 with the same kink pattern,
# per tensor, as a fraction of its largest float64 gradient (the AE at
# 128x128: up to 1.2e-4 on the CPU, 5.6e-4 on an H100; BatchNorm's
# backward cancels); a wrong gradient is off by its whole size
GRAD64_RTOL = 1e-2
KERNEL_BATCH = 10  # back-to-back kernel calls per pair of CUDA events
STEP_PRESETS = ("VAE_Zimmerer", "ceVAE_Zimmerer", "AE_spatial", "CE",
                "GMVAE", "constrainedAE", "constrainedAAE")
PRESET_STEPS = 3  # train steps of each of STEP_PRESETS
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
PROFILES = []  # (fn, title) queued for phase 10
SERVED_CC = []  # kernel-chain calls of each served batch of requests
SERVED_STEM = []  # stem kernel launches of the checked served restorations


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


@contextlib.contextmanager
def counted():
    """Records the port's trace counters over the block; yields a reader
    of one counter (``median_kernel`` unless named; 0 where it never
    advanced), which still reads after the block."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import (
        trace,
    )

    with trace.recording() as rec:
        yield lambda name="median_kernel": rec.counters().get(name, 0)


@contextlib.contextmanager
def served(requests, what, stem_steps=None):
    """``requests`` requests served in the block, each by one median
    launch and by one call of the components' kernel chain (and so by no
    propagation round), and, where ``stem_steps`` is given, by that many
    launches of the stem's input-gradient kernel (one a restoration
    step); keeps the counts for the ``kernels`` line.  Yields
    ``counted()``'s reader."""
    with counted() as n:
        yield n
    check(n() == requests, f"{what}: the median kernel launched {n()} "
          f"times for {requests} requests")
    check(n("cc_kernel") == requests, f"{what}: {n('cc_kernel')} "
          f"component-chain calls for {requests} requests")
    SERVED_CC.append(n("cc_kernel"))
    if stem_steps is not None:
        stem = n("stem_dgrad_kernel")
        check(stem == stem_steps * requests,
              f"{what}: the stem kernel launched {stem} times for "
              f"{requests} requests of {stem_steps} restoration steps")
        SERVED_STEM.append(stem)


def card_peaks():
    """(dense bf16 FLOP/s, HBM bytes/s) of the card, from the port's
    ``utils/misc.py::device_peaks`` (an H100 SXM: 989e12, 3.35e12)."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils.misc import (
        device_peaks,
    )

    return device_peaks(torch.cuda.get_device_name(0) if DEVICE == "cuda"
                        else "cpu")


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
    path, log = _build.build_library()
    _build.load_library()
    print(f"[device] kernel library {os.path.relpath(path, ROOT)} built and "
          f"loaded")
    for line in log.strip().splitlines():
        print(f"[device] nvcc: {line}")


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
    # at the card's HBM rate; a median does no floating-point products
    bound_ms = 2 * serve_vol.numel() * 4 / card_peaks()[1] * 1e3
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


def components_masks():
    """The components' masks at CC_SHAPE, on the card: lesion blobs (a
    Gaussian-smoothed normal field above 2.2 of its spread, ~1.4 % of the
    voxels in ~1,200 components, as a served residual's lesions) and
    random masks at densities 0.1 and 0.5 (above 26-connectivity's
    percolation point: one component snakes through the volume)."""
    import numpy as np
    import torch
    from scipy import ndimage as ndi

    rng = np.random.default_rng(SEED)
    field = ndi.gaussian_filter(rng.standard_normal(CC_SHAPE), 2.0)
    masks = {"blobs": field / field.std() > 2.2}
    for density in (0.1, 0.5):
        masks[f"density {density}"] = rng.uniform(size=CC_SHAPE) < density
    return {k: torch.from_numpy(v).to(DEVICE) for k, v in masks.items()}


def phase_components():
    """2b. The components' kernel chain against the plain propagation at
    CC_SHAPE, then both timed on the lesion blobs, with the bytes bound."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import ccl
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
        postprocess as P,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import (
        trace,
    )

    masks = components_masks()
    min_size = 7
    max_abs_err = 0.0  # over the labels and the filtered masks
    for name, m in masks.items():
        with trace.recording() as rec:
            ref, conv = P.connected_components_3d_plain(
                m, 10 ** 6, return_converged=True)
        got = ccl.connected_components_3d_cuda(m)
        check(conv and torch.equal(got, ref),
              f"components kernel labels != plain at {CC_SHAPE} ({name})")
        kept = ccl.filter_small_components_cuda(m, min_size)
        kept_ref = P.filter_small_components_plain(m, min_size, 10 ** 6)
        check(torch.equal(kept, kept_ref),
              f"components kernel filter != plain at {CC_SHAPE} ({name})")
        max_abs_err = max(max_abs_err,
                          float((got.long() - ref.long()).abs().max()),
                          float((kept - kept_ref).abs().max()))
        n = int(P.num_components(ref))
        print(f"[components] {CC_SHAPE} {name}: {100 * float(m.float().mean()):.2f}"
              f" % foreground, {n} components, {rec.counters()['cc_rounds']} "
              f"plain rounds: labels and filter equal")
    blobs = masks["blobs"]
    with trace.recording() as rec:
        P.filter_small_components_plain(blobs, min_size)
    rounds = rec.counters()["cc_rounds"]
    kernel_ms = cuda_ms(lambda: ccl.filter_small_components_cuda(blobs,
                                                                 min_size))
    batched_ms = cuda_ms(lambda: ccl.filter_small_components_cuda(
        blobs, min_size), batch=KERNEL_BATCH)
    plain_ms = cuda_ms(lambda: P.filter_small_components_plain(blobs,
                                                               min_size))
    dense = masks["density 0.5"]
    dense_ms = cuda_ms(lambda: ccl.filter_small_components_cuda(dense,
                                                                min_size))
    # least time: the bool mask read once, the float32 mask written once
    bound_ms = 5 * blobs.numel() / card_peaks()[1] * 1e3
    print(f"[components] size filter at {CC_SHAPE} on the blobs (CUDA "
          f"events, median of 20 samples of one call): kernel chain "
          f"{kernel_ms:.4f} ms ({batched_ms:.4f} ms a call batched "
          f"{KERNEL_BATCH} back to back), bound {bound_ms * 1e3:.2f} us "
          f"(bytes), {100 * bound_ms / batched_ms:.2f} % of it batched; plain "
          f"{plain_ms:.4f} ms ({rounds} rounds, one sync each); kernel chain "
          f"on density 0.5 {dense_ms:.4f} ms")
    # profiled in phase 10, after every time is taken
    PROFILES.append((lambda: ccl.filter_small_components_cuda(blobs,
                                                              min_size),
                     f"components: the kernel chain's size filter, one call "
                     f"at {CC_SHAPE} (blobs)"))
    PROFILES.append((lambda: P.filter_small_components_plain(blobs,
                                                             min_size),
                     f"components: the plain size filter, one call at "
                     f"{CC_SHAPE} (blobs)"))
    return dict(ms=kernel_ms, batched_ms=batched_ms, plain_ms=plain_ms,
                dense_ms=dense_ms, bound_ms=bound_ms, rounds=rounds,
                max_abs_err=max_abs_err)


def stem_case(shape, g):
    """bf16 grad_out (B, 32, OH, OW), NCHW as the encoder's backward hands
    it, and a bf16 weight (32, 1, 5, 5) of the stem over (B, H, W) inputs,
    with the stem's SAME pads."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
        _same_pads,
    )

    B, H, W = shape
    ph, pw = _same_pads(H, 5, 2), _same_pads(W, 5, 2)
    OH, OW = (H + sum(ph) - 5) // 2 + 1, (W + sum(pw) - 5) // 2 + 1
    grad_out = torch.randn((B, 32, OH, OW), generator=g,
                           device=DEVICE).to(torch.bfloat16)
    weight = (torch.randn((32, 1, 5, 5), generator=g, device=DEVICE)
              * 0.2).to(torch.bfloat16)
    return grad_out, weight, (H, W), ph, pw


def phase_stem_dgrad():
    """2c. The stem's input-gradient kernel against the plain version at
    STEM_SHAPES in bf16, then it, the plain version and cuDNN's input
    gradient timed at the served shape, with the bytes bound.  The kernel
    and cuDNN sum 800 fp32 products each in their own order and round once
    to bf16: they may differ by one bf16 ulp plus the fp32 sums' error
    bound, 2^-15 of S, the sum of the products' magnitudes."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops.stem_dgrad import (
        stem_input_grad_cuda,
        stem_input_grad_plain,
    )

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # S below in float32
    try:
        max_err, served = 0.0, None
        for shape in STEM_SHAPES:
            case = stem_case(shape, g)
            grad_out, weight, size, ph, pw = case
            with counted() as n:
                got = stem_input_grad_cuda(*case)
            want = stem_input_grad_plain(*case)
            S = stem_input_grad_plain(grad_out.float().abs(),
                                      weight.float().abs(), size, ph, pw)
            torch.cuda.synchronize()
            check(n("stem_dgrad_kernel") == 1,
                  f"stem kernel: {n('stem_dgrad_kernel')} launches for one "
                  f"call at {shape}")
            check(got.dtype == torch.float32 and got.shape == want.shape,
                  f"stem kernel: {got.dtype} {tuple(got.shape)} at {shape}")
            ulp = torch.exp2(torch.floor(torch.log2(
                want.abs().clamp_min(2.0 ** -126))) - 7)
            excess = float(((got - want).abs() - ulp - 2.0 ** -15 * S).max())
            equal = float((got == want).float().mean())
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            check(excess <= 0 and equal >= 0.999,
                  f"stem kernel != plain at {shape}: {100 * equal:.3f} % "
                  f"equal, {excess:.3e} beyond one ulp + 2^-15 S")
            print(f"[stem] {shape} bf16 NCHW: {100 * equal:.4f} % of values "
                  f"equal, max|diff| {err:.3e}, within one ulp + 2^-15 S")
            if served is None:
                served = case
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    grad_out, weight, (H, W), ph, pw = served
    padded = torch.empty((grad_out.shape[0], 1, H + sum(ph), W + sum(pw)),
                         dtype=grad_out.dtype, device=DEVICE)
    kernel_ms = cuda_ms(lambda: stem_input_grad_cuda(*served))
    batched_ms = cuda_ms(lambda: stem_input_grad_cuda(*served),
                         batch=KERNEL_BATCH)
    plain_ms = cuda_ms(lambda: stem_input_grad_plain(*served))
    library_ms = cuda_ms(lambda: torch.ops.aten.convolution_backward(
        grad_out, padded, weight, None, [2, 2], [0, 0], [1, 1], False,
        [0, 0], 1, [True, False, False]))
    # least time: grad_out read once, the float32 gradient written once
    # (the weights' 1.6 kB aside); the 0.59 G FMAs on the fp32 cores take
    # about as long
    bound_ms = ((grad_out.numel() * grad_out.element_size()
                 + grad_out.shape[0] * H * W * 4) / card_peaks()[1] * 1e3)
    print(f"[stem] input gradient at {tuple(grad_out.shape)} -> "
          f"({grad_out.shape[0]}, {H}, {W}) (CUDA events, median of 20 "
          f"samples): kernel {kernel_ms:.4f} ms a call, {batched_ms:.4f} ms "
          f"batched {KERNEL_BATCH} back to back; bound {bound_ms * 1e3:.2f} "
          f"us (bytes), {100 * bound_ms / batched_ms:.2f} % of it batched; "
          f"plain {plain_ms:.4f} ms; library (cuDNN's input gradient alone) "
          f"{library_ms:.4f} ms")
    return dict(max_abs_err=max_err, ms=kernel_ms, batched_ms=batched_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, library_ms=library_ms)


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

    from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import (
        open_volume,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.inference import (
        AnomalyDetector,
    )

    argv = ["infer", "--workdir", wd, "--device", "cuda"]
    for s in scans:
        argv += ["-i", s]
    with served(N_REQUESTS, "infer") as n:
        rc = cli.main(argv)
        check(rc == 0, f"infer exited {rc}")
    launches = n()
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
    print(f"[serve] infer CLI, {N_REQUESTS} requests; median kernel "
          f"launches: {launches}")

    det = AnomalyDetector.from_workdir(wd, device="cuda")
    vol = np.asarray(open_volume(scans[0]).data, np.float32)
    with served(1, "detect"):
        res = det.detect(vol)
    check(res["anomaly_map"].shape == SERVE_SHAPE
          and np.isfinite(res["anomaly_map"]).all(), "detect anomaly map")
    return launches


def phase_card_vs_cpu(wd, scans):
    import numpy as np
    import torch
    from scipy import ndimage as ndi

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
    H, W, _ = vol.shape
    # the model's geometry (the zoom only transposes) and the serving
    # geometry, 181x217 in plane, where detect zooms every slice
    volumes = {"model": vol,
               "serving": ndi.zoom(vol, (181 / H, 217 / W, 1), order=1)}
    dets = {dev: AnomalyDetector.from_workdir(wd, device=dev)
            for dev in ("cuda", "cpu")}
    map_err = 0.0
    for name, v in volumes.items():
        gpu, cpu = (dets[dev].detect(v) for dev in ("cuda", "cpu"))
        err = float(np.abs(gpu["anomaly_map"] - cpu["anomaly_map"]).max())
        rec_err = float(np.abs(gpu["reconstruction"]
                               - cpu["reconstruction"]).max())
        score_err = float(np.abs(gpu["scores"] - cpu["scores"]).max())
        differ = gpu["mask"] != cpu["mask"]
        near = np.abs(cpu["anomaly_map"] - THRESHOLD) <= TOL
        print(f"[card-vs-cpu] {name} geometry {v.shape}, float32, TF32 off: "
              f"max|d reconstruction| {rec_err:.3e}, max|d anomaly map| "
              f"{err:.3e}, max|d scores| {score_err:.3e}, mask voxels "
              f"differing {int(differ.sum())} (of which within {TOL} of "
              f"the threshold {int((differ & near).sum())}), anomalous "
              f"voxels card {gpu['anomalous_voxels']} cpu "
              f"{cpu['anomalous_voxels']}")
        check(err <= TOL, f"{name}: anomaly map differs by {err}")
        check(score_err <= TOL, f"{name}: scores differ by {score_err}")
        check(not (differ & ~near).any(),
              f"{name}: masks differ away from the threshold")
        map_err = max(map_err, err)
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

    from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli

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
    with counted() as n:
        rc = cli.main(["--preset", "AE", "--synthetic", "--device", DEVICE,
                       "--workdir", wd, "--metrics-out", metrics_path,
                       "-c", paths])
    launches = n()
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
    print(f"[train] CLI train + 3 evaluations + threshold fit: train loss "
          f"{train}, VAL loss {val}; median kernel launches "
          f"{launches} (3 x {n_test} TEST + {n_val} VAL); calibrated "
          f"threshold {calib['threshold']:.5f} (VAL Dice "
          f"{calib['bestDiceVAL']:.4f})")
    for row in rows:
        print(f"[train] {row['description']}: AUROC {row['AUROC']:.4f} "
              f"AUPRC {row['AUPRC']:.4f} bestDice {row['bestDice']:.4f} "
              f"Dice {row['DiceScore']:.4f}")

    out = os.path.join(base, "served")
    with served(1, "infer on the trained workdir"):
        rc = cli.main(["infer", "--workdir", wd, "-i", scan, "-o", out,
                       "--device", DEVICE])
        check(rc == 0, f"infer on the trained workdir: rc {rc}")
    stem = os.path.basename(scan)[:-len(".nii.gz")]
    with open(os.path.join(out, f"{stem}.report.json")) as f:
        report = json.load(f)
    check(report["threshold"] == calib["threshold"],
          "served threshold is not the calibrated one")
    print(f"[train] infer on the trained workdir: "
          f"{report['anomalous_voxels']} anomalous voxels at the calibrated "
          f"threshold; one median kernel launch")
    return launches + 1


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


RESIDUAL = "residual x - rec"


@contextlib.contextmanager
def kink_patterns(record=None, enforce=None):
    """The sides of every kink of a forward pass, in call order: each
    ReLU's and LeakyReLU's pre-activation (> 0) and the L1 loss's residual
    x - rec (> 0).  ``record`` (a list) gets each call's (kind, mask on
    the host); ``enforce`` (such a list, as another device recorded it)
    makes each call take that mask's side, in value and derivative,
    instead of its own: exact arithmetic with that device's kink
    pattern."""
    import torch
    import torch.nn.functional as F

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
        losses,
    )

    relu, leaky, l1 = F.relu, F.leaky_relu, losses.l1_elem
    given = iter(enforce or ())

    def side(v, kind):
        if record is not None:
            record.append((kind, (v > 0).detach().cpu()))
        if enforce is None:
            return None
        given_kind, mask = next(given)
        check(given_kind == kind, f"kink pattern: {kind} where the "
                                  f"recorded pass had {given_kind}")
        return mask.to(v.device)

    def relu_(x, inplace=False):
        mask = side(x, "ReLU")
        return relu(x) if mask is None else torch.where(mask, x, 0 * x)

    def leaky_relu(x, negative_slope=0.01, inplace=False):
        mask = side(x, "LeakyReLU")
        if mask is None:
            return leaky(x, negative_slope)
        return torch.where(mask, x, negative_slope * x)

    def l1_elem(x, x_hat):
        mask = side(x - x_hat, RESIDUAL)
        if mask is None:
            return l1(x, x_hat)
        return torch.where(mask, x - x_hat, x_hat - x)

    F.relu, F.leaky_relu, losses.l1_elem = relu_, leaky_relu, l1_elem
    try:
        yield
    finally:
        F.relu, F.leaky_relu, losses.l1_elem = relu, leaky, l1


@contextlib.contextmanager
def float64_compute():
    """Every cast to float32 inside the block keeps a float64 tensor in
    float64 (the layers' compute-dtype casts, ``Norm``'s statistics, the
    decoder's output): a float64 model computes in float64 end to end."""
    import torch

    to = torch.Tensor.to

    def to64(self, *args, **kwargs):
        if self.dtype == torch.float64:
            args = tuple(torch.float64 if a is torch.float32 else a
                         for a in args)
            if kwargs.get("dtype") is torch.float32:
                kwargs["dtype"] = torch.float64
        return to(self, *args, **kwargs)

    torch.Tensor.to = to64
    try:
        yield
    finally:
        torch.Tensor.to = to


def float64_gradients(trainer, start, x, enforce=None):
    """d loss / d parameters in float64 on the CPU at ``start`` for the
    batch ``x`` (train mode, as the step's forward), with the kink pattern
    ``enforce`` or float64's own."""
    import torch

    model = copy.deepcopy(trainer.model).cpu()
    model.load_state_dict(start)
    model.double().train()
    x64 = x.double()
    with float64_compute(), kink_patterns(enforce=enforce):
        outputs = model(x64, None)
        loss = trainer.compute_losses(outputs, {"x": x64})["loss"]
    check(loss.dtype == torch.float64, f"float64 loss is {loss.dtype}")
    names, params = zip(*model.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params)))


def flipped_gradients(card, cpu, start, x, kinks):
    """Why step 1's parameters differ by more than 1e-5 between the card
    and the CPU (outside the BN-fed conv biases).  ``kinks`` are the two
    devices' kink patterns of the step's forward (``kink_patterns``).
    Prints, for those elements, their |grad| and how many took opposite
    gradient signs, and for their tensors the card-vs-CPU gradient
    difference (median, max) beside float32 rounding (2^-23 of the
    tensor's largest |grad|); the kinks that take the other side on the
    card, per layer; and tells each element apart, from the CPU's float64
    gradients at the same start (``float64_gradients``) with float64's
    own kink pattern (g64), the card's (g64_card) and the CPU's (g64_cpu).
    A tensor's float32 error is the larger of max |g_card - g64_card| and
    max |g_cpu - g64_cpu| over its elements: what float32's summation
    order leaves once each device's own kinks are given; it must stay
    within GRAD64_RTOL of the tensor's largest |g64|, or the device's
    gradient is wrong.  Each element is then

      * a kink: the two devices' kink patterns move its exact gradient
        by more than the float32 error (|g64_card - g64_cpu| beyond it),
        so a kink on its path takes the other side on the card;
      * rounding: otherwise, where its float64 gradient (with float64's,
        the card's or the CPU's kink pattern) is no larger than the
        float32 error, so float32 does not define its sign.

    An element that is neither, or a float32 error beyond GRAD64_RTOL, is
    a fault.  Returns (elements, rounding, kink, neither)."""
    import torch

    eps32 = float(torch.finfo(torch.float32).eps)
    card_kinks, cpu_kinks = kinks
    g64 = float64_gradients(cpu, start, x)
    g64_card = float64_gradients(cpu, start, x, card_kinks)
    g64_cpu = float64_gradients(cpu, start, x, cpu_kinks)
    n, n_sign, g_max, rel_max, ulp_max, dg_med, dg_max = (
        0, 0, 0.0, 0.0, 0.0, 0.0, 0.0)
    n_round, n_kink, neither, err_max = 0, 0, [], 0.0
    tensors = []
    card_params = dict(card.model.named_parameters())
    for k, p in cpu.model.named_parameters():
        q = card_params[k]
        if free_bias(k) or p.grad is None:
            continue
        g, gc = p.grad, q.grad.cpu()
        err32 = max(float((gc.double() - g64_card[k]).abs().max()),
                    float((g.double() - g64_cpu[k]).abs().max()))
        scale = float(g64[k].abs().max())
        if err32 > GRAD64_RTOL * scale:
            neither.append(f"{k}: float32 error {err32:.3e} against its "
                           f"largest |g64| {scale:.3e}")
        err_max = max(err_max, err32 / scale)
        mask = (q.detach().cpu() - p.detach()).abs() > 1e-5
        if not mask.any():
            continue
        dg = (gc - g).abs()
        top = float(g.abs().max())
        n += int(mask.sum())
        n_sign += int((torch.sign(g[mask]) != torch.sign(gc[mask])).sum())
        g_max = max(g_max, float(g[mask].abs().max()))
        rel_max = max(rel_max, float(g[mask].abs().max()) / top)
        ulp_max = max(ulp_max, eps32 * top)
        dg_med = max(dg_med, float(dg.median()))
        dg_max = max(dg_max, float(dg.max()))
        kink = mask & ((g64_card[k] - g64_cpu[k]).abs() > err32)
        small = torch.minimum(torch.minimum(g64[k].abs(), g64_card[k].abs()),
                              g64_cpu[k].abs())
        rounding = mask & ~kink & (small <= err32)
        n_round += int(rounding.sum())
        n_kink += int(kink.sum())
        left = mask & ~rounding & ~kink
        if left.any():
            neither.append(f"{k}: {int(left.sum())} elements, |g64| up to "
                           f"{float(g64[k][left].abs().max()):.3e} against "
                           f"the float32 error {err32:.3e}")
        tensors.append(f"{k} {int(mask.sum())}/{p.numel()}: max|g| there "
                       f"{float(g[mask].abs().max()):.2e}; |dg| median "
                       f"{float(dg.median()):.2e}, max {float(dg.max()):.2e};"
                       f" float32 rounding {eps32 * top:.2e}; float32 "
                       f"error {err32:.2e}; rounding "
                       f"{int(rounding.sum())}, kink {int(kink.sum())}")
    layers, flips, pixels = [], 0, 0
    for i, ((kind, a), (_, b)) in enumerate(zip(card_kinks, cpu_kinks)):
        layers.append(f"{kind} {i} {tuple(a.shape)}: {int((a != b).sum())}")
        if kind == RESIDUAL:
            flips += int((a != b).sum())
            pixels += a.numel()
    print(f"[train-card-vs-cpu] step 1: {n} elements beyond 1e-5 in "
          f"{len(tensors)} tensors, {n_sign} with opposite gradient signs; "
          f"their |grad| up to {g_max:.3e} ({rel_max:.2e} of their tensor's "
          f"largest); card-vs-CPU gradient difference in those tensors: "
          f"median up to {dg_med:.3e}, max {dg_max:.3e}; float32 rounding "
          f"up to {ulp_max:.3e}; residual signs differing at {flips} of "
          f"{pixels} pixels")
    print(f"[train-card-vs-cpu] step 1 split against float64 gradients: "
          f"{n_round} rounding, {n_kink} kink, {n - n_round - n_kink} "
          f"neither, of {n} elements; float32 error against float64 up to "
          f"{err_max:.2e} of a tensor's largest gradient (bound "
          f"{GRAD64_RTOL}); kinks on the other side on the card "
          f"(card vs CPU): " + "; ".join(layers))
    for line in tensors:
        print(f"[train-card-vs-cpu]   {line}")
    check(not neither, "step 1: elements neither rounding nor kink: "
          + "; ".join(neither))
    return n, n_round, n_kink, n - n_round - n_kink


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
        kinks = ([], [])  # recorded at step 1
        with kink_patterns(record=kinks[0] if t == 1 else None):
            a = step(card, rows)
        with kink_patterns(record=kinks[1] if t == 1 else None):
            b = step(cpu, rows)
        forced.append((a, b))
        check(abs(a - b) <= TOL * abs(b), f"step {t}: loss card {a} vs cpu "
              f"{b}")
        if t == 1:
            split = flipped_gradients(card, cpu, start,
                                      torch.from_numpy(pool[rows]), kinks)
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
    return rel, split


def _device_time_us(event):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def profile_summary(fn, title):
    """Run ``fn`` once under ``torch.profiler``: the device time of its
    kernels and copies, their count, and those with the most time.  Only
    device activity is traced: tracing host operators too doubles a
    launch-bound span, and its ``record_function`` ranges appear as device
    events that overlap the kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    # kernel-level events only: an operator's device time is its kernels'
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    device_ms = sum(_device_time_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_device_time_us, reverse=True)[:12]
    launches = sum(e.count for e in kernels)
    lines = [f"== {title}: device time {device_ms:.3f} ms in {launches} "
             f"kernels and copies"]
    lines += [f"  {_device_time_us(e) / 1e3:10.3f} ms  {e.count:6d}x  "
              f"{e.key[:100]}" for e in top]
    return "\n".join(lines)


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

    from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli

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
    with counted() as n:
        rc = cli.main(["--preset", name, "--synthetic", "--device", DEVICE,
                       "-E", "1", "--workdir", wd, "--metrics-out",
                       metrics_path, "-c", paths, *extra])
    launches = n()
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
          f"losses {[round(v, 3) for v in losses]}; median kernel launches "
          f"{launches} (3 x {n_test} TEST + {n_val} VAL); calibrated "
          f"threshold {calib['threshold']:.5f} (VAL Dice "
          f"{calib['bestDiceVAL']:.4f})")
    for row in rows:
        print(f"[{name}] {row['description']}: AUROC {row['AUROC']:.4f} "
              f"AUPRC {row['AUPRC']:.4f} bestDice {row['bestDice']:.4f} "
              f"Dice {row['DiceScore']:.4f}")
    return wd, launches, calib


def serve_once(wd, scan, out, stem_steps=None):
    """``infer --device cuda`` of one scan on a trained workdir: one median
    launch (and ``stem_steps`` stem kernel launches, where given), the
    calibrated threshold."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli

    with served(1, f"infer on {wd}", stem_steps):
        rc = cli.main(["infer", "--workdir", wd, "-i", scan, "-o", out,
                       "--device", DEVICE])
        check(rc == 0, f"infer on {wd}: rc {rc}")
    with open(os.path.join(wd, "calibration.json")) as f:
        calib = json.load(f)
    stem = os.path.basename(scan)[:-len(".nii.gz")]
    with open(os.path.join(out, f"{stem}.report.json")) as f:
        report = json.load(f)
    check(report["threshold"] == calib["threshold"],
          "served threshold is not the calibrated one")
    return 1


def phase_lambda_protocol(base, scan, name):
    """a. ``--preset <name>`` (phase 8a ``VAE_You``, 9a ``GMVAE_spatial``)
    through the protocol: training, the lambda sweep on the card, 3
    evaluations and the threshold fit with batched 150-step restoration
    (one restoration per group of up to ``restorationVolumeBatch``
    volumes), then ``infer``.  Returns (median launches, lambda)."""
    E = importlib.import_module(
        "unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate")
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import preset
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    cls = get_trainer(preset(name).trainer)
    sweep, groups = {}, []
    real_sweep = cls.determine_best_lambda
    real_group = E._reconstruct_volume_group

    def kept_sweep(self, dataset):
        sweep["lambda"] = real_sweep(self, dataset)
        return sweep["lambda"]

    def counted_group(trainer, xs, *args, **kwargs):
        groups.append(len(xs))
        return real_group(trainer, xs, *args, **kwargs)

    cls.determine_best_lambda = kept_sweep
    E._reconstruct_volume_group = counted_group
    try:
        wd, launches, _ = run_protocol(base, name)
    finally:
        cls.determine_best_lambda = real_sweep
        E._reconstruct_volume_group = real_group
    with open(os.path.join(wd, "tv_lambda.json")) as f:
        lam = json.load(f)["tv_lambda_value"]
    check("lambda" in sweep and lam == sweep["lambda"]
          and 0.0 <= lam <= 1.9, f"tv_lambda.json {lam}, sweep {sweep}")
    _, _, _, cohort = lesion_cohort(name)
    n_test = len(cohort.patients_of("TEST"))
    n_val = len(cohort.patients_of("VAL"))
    check(sum(groups) == 3 * n_test + n_val and max(groups) > 1,
          f"restoration groups {groups}")
    # the served VAE_You restoration takes the stem's input gradient from
    # the kernel at each of its steps
    stem_steps = preset(name).restore_steps if name == "VAE_You" else None
    launches += serve_once(wd, scan, os.path.join(base, f"served_{name}"),
                           stem_steps)
    print(f"[{name}] lambda sweep on the card: lambda {lam}; restoration "
          f"groups {groups} volumes; infer: one median launch"
          + ("" if stem_steps is None else
             f", {stem_steps} stem kernel launches"))
    return launches, lam


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

    wd, launches, calib = run_protocol(base, "VAE", ("-n", "4"))
    check(calib["options"]["numMonteCarloSamples"] == 4,
          f"calibration options {calib['options']}")
    launches += serve_once(wd, scan, os.path.join(base, "served_VAE"))
    det = AnomalyDetector.from_workdir(wd, device=DEVICE)
    o, c = det.options, det.config
    vol = np.asarray(open_volume(scan).data, np.float32)
    with served(1, "MC detect"):
        res = det.detect(vol)
    launches += 1
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
    protocol, then PRESET_STEPS train steps at full width of each preset
    that no other phase trains: finite losses."""
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
        pool = {"x": healthy.slices("TRAIN")}
        if trainer.needs_brainmask:
            pool["mask"] = healthy.brainmasks("TRAIN")
        pool = {k: torch.from_numpy(np.asarray(v, np.float32)).to(DEVICE)
                for k, v in pool.items()}
        idxs = epoch_indices(np.random.default_rng(SEED),
                             int(pool["x"].shape[0]), config.batchsize)
        metrics = {k: float(v) for k, v in trainer._run_epoch(
            "TRAIN", pool, idxs[:PRESET_STEPS]).items()}
        check(np.isfinite(list(metrics.values())).all(),
              f"{name}: losses {metrics}")
        print(f"[steps] {name} ({config.model}, {count_params(trainer.model):,}"
              f" parameters, batch {config.batchsize}): {PRESET_STEPS} steps, "
              f"mean " + ", ".join(f"{k} {v:.3f}"
                                   for k, v in sorted(metrics.items())))
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
    out = {dev: t.reconstruct_device(xv.to(dev), generator=noise.to(dev))[
        "reconstruction"].cpu() for dev, t in trainers.items()}
    d = (out[DEVICE] - out["cpu"]).abs()
    moved = float((out["cpu"] - xv).abs().max())
    steps = float(d.max()) / config.restore_lr
    print(f"[vae-card-vs-cpu] VAE_You restoration of {tuple(xv.shape)}, "
          f"{config.restore_steps} steps, float32, same noise: max|d| "
          f"{float(d.max()):.3e} = {steps:.3f} x restore_lr, mean|d| "
          f"{float(d.mean()):.3e}, voxels beyond 1e-4 {int((d > 1e-4).sum())}"
          f" of {d.numel()} (bound {RESTORE_FLIP_STEPS} x restore_lr); the "
          f"restoration moved the input by up to {moved:.3e}")
    check(steps <= RESTORE_FLIP_STEPS,
          f"restoration differs by {float(d.max())}")
    return float(d.max())


# ---------------------------------------------------------------------------
# phase 9: the GMVAE family and the latent-critic AAE family at full width
# (128x128, the presets' batch, zDim, dims and intermediate resolution,
# bf16)


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


# ---------------------------------------------------------------------------
# phase 9f-9g: the ResNet stack (Chen's constrained AAE, Schlegl's fAnoGAN)
# and the image critics (fAnoGAN, AnoVAEGAN) at full width (128x128, batch
# 8, the presets' zDim, ResNet dim 64, bf16)


LAST_PRESETS = ("constrainedAAE_Chen", "fAnoGAN", "fAnoGAN_schlegl",
                "AnoVAEGAN")
# the protocols of phase 9f train and evaluate on 16 slices per volume
# (the CLI's slice range; width and batch are the presets'): an epoch of
# the full 110 takes Chen ~80 s on an H100
GAN_SLICES = ("-s", "20", "-e", "36")


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
    launches."""
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
    launches = 0
    for name in LAST_PRESETS:
        cls, phases, want = expected[name]
        counts, undo = schedule_counts(cls)
        try:
            wd, n, _ = run_protocol(base, name, GAN_SLICES)
        finally:
            undo()
        launches += n
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
    return launches


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


# ---------------------------------------------------------------------------
# phase 9i: the parallel layer (``--mesh-data``): NCCL at world 1 through
# the CLI, and two ranks on this one card over gloo


MESH_WORLD = 2
MESH_BATCH = 128  # the AE preset's batch, 64 rows per rank
MESH_CLI_BATCH = ("-b", "32")  # GAN_SLICES leave 80-96 TRAIN slices
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


def rank_worker(rank, world, workdir):
    """One of the ranks of phase 9i b, on this card over gloo (run as
    ``chip_smoke.py --rank-worker RANK WORLD DIR``): gloo's acceptance of
    CUDA tensors; the sharded median of SERVE_SHAPE (its launches counted);
    ``reconstruct_device`` of MESH_RECON_SLICES slices with MC dropout from
    the seeded init; one float32 AE step of its 64 rows and the AAE batch,
    each from the start state in DIR; then its slab's time through the
    kernel alone.  Writes DIR/rank_RANK.pt."""
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
    with counted() as n:
        shard = sharded_median_filter_3d(ctx, local)
        torch.cuda.synchronize()
    out["median_launches"] = n()
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
    """b. MESH_WORLD ranks on this one card over gloo (which moves the
    collectives' tensors through the host), against one process on the
    card:
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
    and the slab kernel's time per rank beside the whole volume's.
    Returns (median launches of the ranks' sharded calls, kernel times)."""
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
    vol = mesh_volume()
    whole_ms = cuda_ms(lambda: median.median_filter_3d_cuda(vol))
    torch.cuda.synchronize()

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
    for rank, code in enumerate(codes):
        with open(os.path.join(workdir, f"log_{rank}.txt")) as f:
            text = f.read()
        check(code == 0, f"rank {rank} exited {code}: {text[-3000:]}")
    outs = [torch.load(os.path.join(workdir, f"rank_{r}.pt"),
                       weights_only=False) for r in range(MESH_WORLD)]
    print(f"[mesh] {MESH_WORLD} ranks on {DEVICE} over gloo; gloo with CUDA "
          f"tensors as they are: " + ", ".join(
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

    times = {"whole_median_ms": whole_ms,
             "slab_kernel_ms": max(o["slab_kernel_ms"] for o in outs)}
    print(f"[mesh] median kernel alone (CUDA events): whole {SERVE_SHAPE} "
          f"{whole_ms:.4f} ms, a rank's "
          f"{(SERVE_SHAPE[0] // MESH_WORLD + 4,) + SERVE_SHAPE[1:]} slab "
          f"{times['slab_kernel_ms']:.4f} ms (slowest rank)")
    return launches, times


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


def phase_tpu_fast(base, scan):
    """a. ``--preset AE --synthetic --device cuda --tpu-fast --tb-every-n
    TB_EVERY`` through the CLI at the preset's width (128 x 128, batch 128,
    zDim 128, bf16; 1 epoch): the protocol's evaluations and threshold fit
    with one median launch per evaluated volume, ``model_dir`` tagged
    ``_s2d_d2s``, finite metrics, the event files' tags and steps
    (``check_events``), then ``infer``; the s2d/d2s AE forward card vs CPU
    in float32 (TF32 off) within TOL.  Returns (median launches, forward
    max|d|)."""
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
    return launches, err


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
    checkpoint of it (whole tensors, written by rank 0).  Writes
    DIR/tp_RANK.pt."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
        MeshConfig,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate import (
        evaluate,
    )
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
    with counted() as n:
        res = evaluate(one_volume_cohort(), ae, eval_options(workdir), config)
    out["eval_launches"] = n()
    out["eval"] = {k: float(res[k]) for k in EVAL_KEYS}
    x, rec_x = mesh_inputs()
    out["recon"] = ae.reconstruct_device(torch.from_numpy(rec_x))[
        "reconstruction"].cpu()
    batch = {"x": torch.from_numpy(x).to(DEVICE)}
    out["loss"] = float(ae.train_step(batch)["loss"])
    out["state"] = {k: v.to("cpu", copy=True)
                    for k, v in ae._whole_model_state().items()}
    ae.save_checkpoint(1)
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
        gathered state.
    Returns the median launches."""
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate import (
        evaluate,
    )
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
    res = evaluate(one_volume_cohort(), ae, eval_options(workdir), config)
    eval_ref = {k: float(res[k]) for k in EVAL_KEYS}
    rec_ref = ae.reconstruct_device(torch.from_numpy(rec_x))[
        "reconstruction"].cpu()
    batch = {"x": torch.from_numpy(x).to(DEVICE)}
    loss_ref = float(ae.train_step(batch)["loss"])
    ref = {k: v.to("cpu", copy=True) for k, v in ae.model.state_dict().items()}
    torch.cuda.synchronize()

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
    for rank, code in enumerate(codes):
        with open(os.path.join(workdir, f"tp_log_{rank}.txt")) as f:
            text = f.read()
        check(code == 0, f"tp rank {rank} exited {code}: {text[-3000:]}")
    outs = [torch.load(os.path.join(workdir, f"tp_{r}.pt"),
                       weights_only=False) for r in range(MESH_WORLD)]
    check([o["layout"] for o in outs] == [(0, m) for m in range(TP_MODEL)],
          f"mesh layout {[o['layout'] for o in outs]}")
    print(f"[tp] {MESH_WORLD} ranks on {DEVICE} over gloo as data 1 x model "
          f"{TP_MODEL}: {outs[0]['sharded']} of "
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
    print("[tp] checkpoint of the ranks restored in one process bit-equal")
    return launches


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
    launched once per evaluated volume.  Prints each preset's four
    metrics beside the port's CPU table and the JAX tables.  Returns the
    median launches."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch import run_all
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
        EXPERIMENT_PRESETS,
    )

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
    with counted() as n:
        rc = run_all.main(["--presets", ",".join(presets), "--scoreboard",
                           board, "--check", table, *SWEEP_RECIPE,
                           "--device", DEVICE, "-c", paths,
                           *(["--tpu-fast"] if fast else [])])
    launches = n()
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
          f"{os.path.relpath(table, ROOT)}: median launches {launches}; "
          f"metrics AUROC / AUPRC / bestDice / finalTrainLoss")
    for name in presets:
        print(f"[sweep {label}] {name}: H100 {fmt(sb[name][0])} | "
              + " | ".join(f"{k} {fmt(t[name])}" for k, t in tables.items()
                           if name in t))
    return launches


# ---------------------------------------------------------------------------
# phase 9l: the paper's real-data protocol (no ``--synthetic``) on
# real-format cohorts at their real geometry, and the quickstart notebook

# The cohorts are cut in depth to keep the script inside its time limit (a
# cold build of a real-geometry volume takes 5-7 s on the host, and every
# evaluation reloads its TEST volumes). BrainWeb: 3 volumes of each phantom
# (real: 4 noise x 3 INU levels), so healthy TRAIN 2 (220 slices, one batch
# of 128), VAL 1 and severe VAL 1, TEST 2.
REAL_PHANTOMS = dict(phantoms=["normal", "msles3"],
                     noise_levels=("pn0", "pn3", "pn5"), inu_levels=("rf20",))
REAL_MSLUB = 6  # VAL 5, TEST 1 by DATASET_PARTITIONS' counts (real: 30)
REAL_MSISBI2015 = 6  # VAL 5, TEST 1 (real: 21 time points)
REAL_EPOCHS = ("-E", "2")
REAL_COHORTS = ("Brainweb", "MSLUB", "MSISBI2015")


def realdata_module():
    """``tests/_torch_realdata.py``: the fake BrainWeb server and the MS
    trees (numpy and scipy only), shared with the CPU tests."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_torch_realdata", os.path.join(ROOT, "tests", "_torch_realdata.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def real_tree(root):
    """BrainWeb through the port's downloader from the fake server (MINC1,
    181x217x181 int16, per-slice renormalised, gzipped: normal and msles3
    at pn0/pn3/pn5 x rf20 with their crisp groundtruths), MSLUB and
    MSISBI2015 as NIfTI at 181x217x181 (axial axis first), the three in
    parallel threads; returns the paths file and the fake server."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.download import (
        download_brainweb_dataset,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.formats import (
        write_nifti,
    )

    from concurrent.futures import ThreadPoolExecutor

    R = realdata_module()
    dirs = {k: os.path.join(root, k.lower()) for k in ("BRAINWEBDIR",
                                                      "MSLUBDIR",
                                                      "MSISBI2015DIR")}
    server = R.FakeBrainWeb(R.BRAINWEB_SHAPE)
    parts = (lambda: download_brainweb_dataset(
                 dirs["BRAINWEBDIR"], opener=server, **REAL_PHANTOMS),
             lambda: R.mslub_tree(dirs["MSLUBDIR"], write_nifti, REAL_MSLUB),
             lambda: R.msisbi2015_tree(dirs["MSISBI2015DIR"], write_nifti,
                                       REAL_MSISBI2015))
    # numpy, zlib and file writes release the GIL: one thread per cohort
    with ThreadPoolExecutor(len(parts)) as pool:
        for future in [pool.submit(fn) for fn in parts]:
            future.result()
    paths = os.path.join(root, "paths.json")
    with open(paths, "w") as f:
        json.dump(dict(dirs, SAMPLEDIR=os.path.join(root, "samples"),
                       CHECKPOINTDIR=os.path.join(root, "checkpoints")), f)
    return paths, server


def phase_real_data(base):
    """l. The paper's protocol through the CLI without ``--synthetic``
    (``--preset AE -c paths -E 2 --device cuda`` at 128x128, zDim 128,
    slices 20-130, bf16) on the real-format tree of ``real_tree``: train on
    BRAINWEB healthy, the best-Dice upper bound without and with the prior
    on BRAINWEB, MSLUB and MSISBI2015, the threshold fitted on BRAINWEB
    VAL into ``calibration.json``, the three evaluations at it; every metric
    row finite and present, one median launch per evaluated volume
    (3 x the three TEST cohorts + BRAINWEB VAL, counted from the splits);
    then ``infer --device cuda`` of one MSISBI2015 scan with that
    calibration and a ``detect`` of it (one launch each).  Returns the
    median launches."""
    import numpy as np

    from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import (
        native,
        open_volume,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.inference import (
        AnomalyDetector,
    )

    root = tempfile.mkdtemp(dir=base)
    paths, server = real_tree(root)
    print(f"[real] fixture: {len(server.requests)} BrainWeb requests; the "
          f"native host helpers (resize, cache) "
          f"{'built' if native.available() else 'not available'}")
    wd = os.path.join(root, "trained")
    metrics_path = os.path.join(root, "metrics.jsonl")
    with counted() as n:
        rc = cli.main(["--preset", "AE", "-c", paths, *REAL_EPOCHS,
                       "--device", DEVICE, "--workdir", wd, "--metrics-out",
                       metrics_path])
    launches = n()
    check(rc == 0, f"real-data protocol: CLI exited {rc}")

    config = cli.preset("AE")
    options = cli.Options(paths=cli.PathConfig.from_json(paths))
    cohorts = {k: cli.build_dataset(options, config, cli.Dataset(k),
                                    "pathological") for k in REAL_COHORTS}
    tests = {k: len(c.patients_of("TEST")) for k, c in cohorts.items()}
    n_val = len(cohorts["Brainweb"].patients_of("VAL"))
    expected = 3 * sum(tests.values()) + n_val
    check(launches == expected,
          f"real-data protocol: median launched {launches} times for "
          f"{expected} evaluated volumes (3 x TEST {tests} + BRAINWEB VAL "
          f"{n_val})")
    with open(metrics_path) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(wd, "calibration.json")) as f:
        calib = json.load(f)
    want = [f"{d}{s}" for s in ("_upperbound", "_upperbound_wPrior")
            for d in REAL_COHORTS]
    want += [f"{d}-VALthresh_{calib['threshold']:.5f}" for d in REAL_COHORTS]
    check([r["description"] for r in rows] == want,
          f"real-data protocol rows {[r['description'] for r in rows]}, "
          f"expected {want}")
    for r in rows:
        for k in ("AUROC", "AUPRC", "bestDice", "DiceScore",
                  "finalTrainLoss"):
            check(r[k] is not None and np.isfinite(r[k]),
                  f"{r['description']}: {k} = {r[k]}")
    healthy = cli.build_dataset(options, config, cli.Dataset.BRAINWEB,
                                "healthy")
    print(f"[real] CLI --preset AE {' '.join(REAL_EPOCHS)} (BRAINWEB "
          f"healthy: {len(healthy.patients_of('TRAIN'))} TRAIN volumes, "
          f"{len(healthy.slices('TRAIN'))} slices) + 9 evaluations + "
          f"threshold fit: median launches {launches} (3 x "
          f"TEST {tests} + BRAINWEB VAL {n_val}); calibrated threshold "
          f"{calib['threshold']:.5f} (VAL Dice {calib['bestDiceVAL']:.4f})")
    for r in rows:
        print(f"[real] {r['description']}: AUROC {r['AUROC']:.4f} AUPRC "
              f"{r['AUPRC']:.4f} bestDice {r['bestDice']:.4f} Dice "
              f"{r['DiceScore']:.4f}")

    isbi = cohorts["MSISBI2015"].patients_of("TEST")[0]
    scan = isbi["filtered_files"][0]
    out = os.path.join(root, "served")
    with served(1, "real-data infer"):
        rc = cli.main(["infer", "--workdir", wd, "-i", scan, "-o", out,
                       "--device", DEVICE])
        check(rc == 0, f"real-data infer: rc {rc}")
    stem = os.path.basename(scan)[:-len(".nii")]
    with open(os.path.join(out, f"{stem}.report.json")) as f:
        report = json.load(f)
    check(report["threshold"] == calib["threshold"],
          "served threshold is not the calibrated one")
    check(np.isfinite(report["slice_scores"]).all(),
          "served slice scores not finite")
    det = AnomalyDetector.from_workdir(wd, device=DEVICE)
    nii = open_volume(scan)
    vol = np.moveaxis(np.asarray(nii.data, np.float32),
                      nii.view_mapping["axial"], 2)
    with served(1, "real-data detect"):
        det.detect(vol)
    print(f"[real] infer --device cuda and detect of "
          f"{os.path.basename(scan)} ({vol.shape[2]} slices of "
          f"{vol.shape[0]}x{vol.shape[1]}): {report.get('anomalous_voxels')}"
          f" anomalous voxels at the calibrated threshold")
    return launches + 2


def phase_notebook(base):
    """l-b. The code cells of ``examples/quickstart_torch.ipynb``, in order
    in one namespace, as the notebook has them (its first cell picks
    ``cuda``): one median launch per evaluated volume (2 x TEST + VAL of
    the notebook's lesioned cohort), finite metrics.  Returns the
    launches."""
    import numpy as np

    with open(os.path.join(ROOT, "examples", "quickstart_torch.ipynb")) as f:
        cells = ["".join(c["source"]) for c in json.load(f)["cells"]
                 if c["cell_type"] == "code"]
    ns = {}
    try:
        with counted() as n:
            for src in cells:
                exec(compile(src, "quickstart_torch.ipynb", "exec"), ns)
    finally:
        if "options" in ns:
            shutil.rmtree(ns["options"].paths.sample_dir, ignore_errors=True)
    launches = n()
    cohort = ns["lesioned"]
    expected = (2 * len(cohort.patients_of("TEST"))
                + len(cohort.patients_of("VAL")))
    check(ns["DEVICE"] == "cuda" and ns["trainer"].device.type == "cuda",
          "the notebook did not run on the card")
    check(launches == expected, f"notebook: median launched {launches} times "
                                f"for {expected} evaluated volumes")
    for k in ("diff_AUC", "diff_AUPRC", "bestDiceScore"):
        check(np.isfinite(ns["results"][k]), f"notebook: {k} not finite")
    print(f"[notebook] {len(cells)} code cells on {ns['DEVICE']}: AUROC "
          f"{ns['results']['diff_AUC']:.4f}, VAL threshold "
          f"{ns['thresh']:.4f} -> TEST Dice "
          f"{ns['fixed']['DiceScore']:.4f}; median launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 9m: the measurement layer (``bench_torch.py``, the roofline tools)
# at a small size; their full-size runs are commands of their own
BENCH_SMALL = ("--batch", "8", "--image", "64", "--slices", "16",
               "--depth", "16", "--restore-steps", "10")
TOOL_SMALL = ("--batch", "8", "--image", "64")
MEASURE_TIMEOUT_S = 300


def run_json_all(commands):
    """Run each ``(script, *args)`` as ``python3 script args --device
    DEVICE`` from the checkout's root, all at once (each its own process,
    as a user runs it; at this size their times are not read); rc 0 and
    the last line of each one's output as JSON, or raise."""
    procs = [subprocess.Popen([sys.executable, *cmd, "--device", DEVICE],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in commands]
    outs = []
    try:
        for cmd, proc in zip(commands, procs):
            out, err = proc.communicate(timeout=MEASURE_TIMEOUT_S)
            check(proc.returncode == 0, f"{' '.join(cmd)}: rc "
                  f"{proc.returncode}\n{out[-3000:]}\n{err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def _finite_numbers(obj):
    """Every int and float in ``obj`` (bools left out) is finite."""
    import math

    if isinstance(obj, dict):
        return all(_finite_numbers(v) for v in obj.values())
    if isinstance(obj, list):
        return all(_finite_numbers(v) for v in obj)
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        return math.isfinite(obj)
    return True


def phase_measurement():
    """9m. ``bench_torch.py`` and both roofline tools at a small size: each
    runs on the card and prints finite numbers; their contracts (the
    headline's keys, sections and rows) are held on the CPU by
    ``tests/test_torch_bench.py``."""
    import torch

    peaks = card_peaks()
    kind = torch.cuda.get_device_name(0) if DEVICE == "cuda" else "cpu"
    stage_tool = os.path.join("tools", "parity_stage_roofline_torch.py")
    out, hbm, *stage_runs = run_json_all([
        ("bench_torch.py", *BENCH_SMALL),
        (os.path.join("tools", "hbm_roofline_torch.py"), *TOOL_SMALL,
         "--slices", "32"),
        (stage_tool, *TOOL_SMALL), (stage_tool, *TOOL_SMALL, "--fast")])
    check(set(out) == {"metric", "value", "unit", "vs_baseline", "detail"},
          f"bench line {out}")
    d = out["detail"]
    check("error" not in d, f"bench error: {d.get('error')}")
    check(_finite_numbers(out), f"bench: non-finite values in {out}")
    check(out["value"] > 0 and out["vs_baseline"] > 0, f"bench {out}")
    check(d["device_kind"] == kind, f"bench ran on {d['device_kind']}")
    check(d["median5_equals_plain"] is True and d["median5_launches"] >= 1,
          f"bench median: equal {d['median5_equals_plain']}, launches "
          f"{d['median5_launches']}")
    print(f"[measure] bench_torch.py {' '.join(BENCH_SMALL)}: exit 0, "
          f"sections {list(d['section_secs'])}, {d['median5_launches']} "
          f"median kernel launches in its own process")
    check(_finite_numbers(hbm) and hbm["device"] == kind
          and hbm["ae"].get("achieved_GBps") is not None
          and hbm["peak_datasheet_GBps"] == peaks[1] / 1e9,
          f"hbm roofline {hbm}")
    for fast, st in zip(((), ("--fast",)), stage_runs):
        check(_finite_numbers(st) and st["device"] == kind
              and (st["peak_flops"], st["peak_bytes_per_sec"]) == peaks
              and len(st["stages"]) == 4
              and all("measured_ms" in r for r in st["stages"]),
              f"stage roofline {fast}: {st}")
    print("[measure] hbm_roofline_torch.py and parity_stage_roofline_torch.py"
          " (parity and --fast): exit 0, finite rows, the card's ceilings")
    return out


# ---------------------------------------------------------------------------
# phase 9n: the seed spread of the presets whose --tpu-fast and parity H100
# rows lie apart, against the JAX package's CPU spreads

SPREAD_PRESETS = ("AAE", "fAnoGAN", "AnoVAEGAN")
SPREAD_SEEDS = (42, 1, 2, 3, 4)


def phase_seed_spread(base):
    """n. ``AAE``, ``fAnoGAN`` and ``AnoVAEGAN`` from each of
    SPREAD_SEEDS (``Config.seed``: init and shuffling) through
    ``tools/seed_spread.py`` on the card (the CLI at the quality tables'
    recipe under ``run_all``'s deterministic settings, PyTorch's default
    TF32 state), with ``--tpu-fast`` and in parity: 30 runs, each printed
    beside the JAX package's CPU spread of its profile
    (``scoreboards/jax_cpu_seeds_fast.json``, ``jax_cpu_seeds.json``).
    Every metric's range over the seeds must overlap that spread widened
    by the tables' tolerances (``run_all.tolerance_band``); one median
    launch per evaluated volume.  Returns the median launches."""
    import importlib.util

    from unsupervised_anomaly_detection_brain_mri_tpu_torch import run_all

    spec = importlib.util.spec_from_file_location(
        "seed_spread", os.path.join(ROOT, "tools", "seed_spread.py"))
    seed_spread = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(seed_spread)
    jax_spread = {}
    for fast, file in ((True, "jax_cpu_seeds_fast.json"),
                       (False, "jax_cpu_seeds.json")):
        with open(os.path.join(run_all.SCOREBOARDS, file)) as f:
            jax_spread[fast] = json.load(f)["presets"]
    with open(os.path.join(run_all.SCOREBOARDS,
                           "expected_h100_fast.json")) as f:
        tolerances = json.load(f)["tolerances"]
    expected = 2 * len(SPREAD_SEEDS) * sweep_launches(SPREAD_PRESETS)
    root = tempfile.mkdtemp(dir=base)
    runs = {}
    with counted() as n:
        for fast in (True, False):
            runs[fast] = seed_spread.run(
                "torch", SPREAD_PRESETS, SPREAD_SEEDS,
                ["--tpu-fast"] if fast else [], device=DEVICE,
                root=root)["presets"]
    launches = n()
    check(launches == expected, f"seed spread: median launched {launches} "
                                f"times for {expected} evaluated volumes")
    faults = []
    for fast in (True, False):
        label = "tpu-fast" if fast else "parity"
        for name in SPREAD_PRESETS:
            spread = jax_spread[fast][name]
            rows = [runs[fast][name][str(s)] for s in SPREAD_SEEDS]
            for seed, row in zip(SPREAD_SEEDS, rows):
                check(row["rc"] == 0, f"{label} {name} seed {seed}: CLI "
                                      f"exited {row['rc']}")
                print(f"[spread {label}] {name} seed {seed}: " + "; ".join(
                          f"{k} " + ("-" if row[k] is None
                                     else f"{row[k]:.4f}")
                          + ("" if spread[k] is None
                             else " (JAX CPU {:.4f}-{:.4f})".format(
                                 spread[k]["min"], spread[k]["max"]))
                          for k in run_all.METRIC_KEYS))
            ranges = []
            for key in run_all.METRIC_KEYS:
                vals = [row[key] for row in rows]
                if spread[key] is None:
                    check(all(v is None for v in vals),
                          f"{label} {name}: {key} {vals}")
                    continue
                lo, hi = run_all.tolerance_band(
                    spread[key]["min"], spread[key]["max"], key, tolerances)
                if not (max(vals) >= lo and min(vals) <= hi):
                    faults.append(f"{label} {name} {key}: card "
                                  f"{min(vals):.4f}-{max(vals):.4f} outside "
                                  f"the JAX band {lo:.4f}-{hi:.4f}")
                ranges.append(f"{key} {min(vals):.4f}-{max(vals):.4f} "
                              f"(JAX band {lo:.4f}-{hi:.4f})")
            print(f"[spread {label}] {name} over seeds {SPREAD_SEEDS}: "
                  + "; ".join(ranges))
    check(not faults, "seed spread: " + "; ".join(faults))
    print(f"[spread] {2 * len(SPREAD_PRESETS) * len(SPREAD_SEEDS)} runs; "
          f"median launches {launches}")
    return launches


def phase_profiles():
    """10. The queued profiles, after every kernel time: printed and kept
    in PROFILE_OUT."""
    texts = [profile_summary(fn, title) for fn, title in PROFILES]
    print("\n".join(texts))
    os.makedirs(os.path.dirname(PROFILE_OUT), exist_ok=True)
    with open(PROFILE_OUT, "w") as f:
        f.write("\n\n".join(texts) + "\n")


def phase(name, fn, *args):
    print(f"[phase] {name}", flush=True)
    return fn(*args)


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

    phase("1 device", phase_device)
    kern = phase("2 kernel", phase_kernel)
    comps = phase("2b components", phase_components)
    stem = phase("2c stem input gradient", phase_stem_dgrad)
    base = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(base, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=base)
    try:
        wd, scans = make_workdir(tmp)
        launches = phase("3 serve", phase_serve, wd, scans)
        phase("4 card vs cpu", phase_card_vs_cpu, wd, scans)
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        launches += phase("5 train + evaluate", phase_train_evaluate, tmp,
                          scans[0])
        train_rel, train_split = phase("6 train card vs cpu",
                                       phase_train_card_vs_cpu)
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        you_launches, lam = phase("8a VAE_You", phase_lambda_protocol, tmp,
                                  scans[0], "VAE_You")
        launches += you_launches
        launches += phase("8b VAE -n 4", phase_vae_mc, tmp, scans[0])
        launches += phase("8c ceVAE + steps", phase_cevae_and_steps, tmp)
        restore_err = phase("8d VAE card vs cpu", phase_vae_card_vs_cpu)
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        spatial_launches, gm_lam = phase(
            "9a GMVAE_spatial", phase_lambda_protocol, tmp, scans[0],
            "GMVAE_spatial")
        launches += spatial_launches
        launches += phase("9b GMVAE_You + AAE", phase_gmvae_you_and_aae, tmp,
                          scans[0])
        fam_fwd, aae_rel, gm_restore = phase("9d families card vs cpu",
                                             phase_families_card_vs_cpu)
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        launches += phase("9f ResNet + image critics", phase_last_presets,
                          tmp, scans[0])
        last_fwd, last_rel = phase("9g ResNet + image critics card vs cpu",
                                   phase_last_card_vs_cpu)
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        launches += phase("9i-a mesh 1 through the CLI (NCCL)",
                          phase_mesh_cli, tmp)
        mesh_launches, mesh_times = phase(
            "9i-b mesh 2 ranks on one card (gloo)", phase_mesh_ranks, tmp)
        launches += mesh_launches
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        fast_launches, fast_err = phase("9j-a AE --tpu-fast through the CLI",
                                        phase_tpu_fast, tmp, scans[0])
        launches += fast_launches
        launches += phase("9j-b tensor parallel, 2 ranks on one card (gloo)",
                          phase_tp_ranks, tmp)
        phase("9j-c validate-data", phase_validate_data, tmp)
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        for fast in (False, True):
            launches += phase(
                f"9k sweep ({'--tpu-fast' if fast else 'parity'})",
                phase_sweep, tmp, fast)
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        launches += phase("9l-a real-data protocol", phase_real_data, tmp)
        launches += phase("9l-b quickstart notebook", phase_notebook, tmp)
        bench = phase("9m measurement layer", phase_measurement)
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        launches += phase("9n seed spread (AAE, fAnoGAN, AnoVAEGAN)",
                          phase_seed_spread, tmp)
        phase("10 profiles", phase_profiles)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check("jax" not in sys.modules, "jax was imported")
    print(f"[summary] median kernel {kern['ms']:.4f} ms (served map "
          f"{kern['served_ms']:.4f} ms) vs plain {kern['plain_ms']:.4f} ms "
          f"(CUDA events); train card vs CPU max relative loss diff "
          f"{train_rel:.3e}; step 1's {train_split[0]} elements beyond 1e-5: "
          f"{train_split[1]} rounding, {train_split[2]} kink")
    print(f"[summary] VAE family: VAE_You lambda {lam}; 150-step restoration "
          f"card vs CPU max|d| {restore_err:.3e}")
    print(f"[summary] GMVAE and AAE families: GMVAE_spatial lambda {gm_lam}; "
          f"card vs CPU: forwards max|d| {fam_fwd:.3e}, AAE batch losses max "
          f"relative diff {aae_rel:.3e}, GMVAE 3-step restoration max|d| "
          f"{gm_restore:.3e}")
    print(f"[summary] ResNet and image-critic presets: card vs CPU forwards "
          f"max|d| {last_fwd:.3e}, adversarial batch losses max relative "
          f"diff {last_rel:.3e}")
    print(f"[summary] parallel layer: median kernel of {SERVE_SHAPE} whole "
          f"{mesh_times['whole_median_ms']:.4f} ms, a rank's slab "
          f"{mesh_times['slab_kernel_ms']:.4f} ms (CUDA events); median "
          f"launches {launches} in all")
    print(f"[summary] last features: s2d/d2s forward card vs CPU max|d| "
          f"{fast_err:.3e}; dp1 x tp{TP_MODEL} on one card checked against "
          f"one process")
    print("[summary] all-preset sweep at the quality tables' recipe: every "
          "preset within the port's H100 tables, parity and --tpu-fast")
    print("[summary] real-data protocol (BrainWeb MINC1, MSLUB and MSISBI2015 "
          "NIfTI at 181x217x181) and the quickstart notebook ran on the card")
    print(f"[summary] seed spread of {', '.join(SPREAD_PRESETS)} over "
          f"{len(SPREAD_SEEDS)} seeds, --tpu-fast and parity: every metric's "
          f"range overlapping the JAX CPU spread widened by the tolerances")
    print(f"[summary] measurement layer at a small size: bench_torch.py "
          f"{bench['detail']['median5_launches']} median kernel launches in "
          f"its own process; both roofline tools ran")
    print(f"[summary] components at {CC_SHAPE}: kernel chain "
          f"{comps['ms']:.4f} ms ({comps['batched_ms']:.4f} batched) vs plain "
          f"{comps['plain_ms']:.4f} ms (CUDA events); {sum(SERVED_CC)} chain "
          f"calls on the served paths ({len(SERVED_CC)} batches of requests, "
          f"one call a request)")
    print(f"[summary] stem input gradient at {STEM_SHAPES[0]}: kernel "
          f"{stem['ms']:.4f} ms ({stem['batched_ms']:.4f} batched) vs plain "
          f"{stem['plain_ms']:.4f} ms and cuDNN's {stem['library_ms']:.4f} ms "
          f"(CUDA events); {sum(SERVED_STEM)} launches in the served VAE_You "
          f"restoration")
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
    }, {
        "name": "ccl3d",
        "route": "cuda",
        "source": f"{PKG}/csrc/ccl3d.cu",
        "replaces": None,
        "calls": sum(SERVED_CC),
        "max_abs_err": comps["max_abs_err"],
        "ms": comps["ms"],
        "plain_ms": comps["plain_ms"],
        "bound_ms": comps["bound_ms"],
        "bound_by": "bytes",
        "batched_ms": comps["batched_ms"],
    }, {
        "name": "stem_dgrad",
        "route": "cuda",
        "source": f"{PKG}/csrc/stem_dgrad.cu",
        "replaces": None,
        "launches": sum(SERVED_STEM),
        "max_abs_err": stem["max_abs_err"],
        "ms": stem["ms"],
        "plain_ms": stem["plain_ms"],
        "bound_ms": stem["bound_ms"],
        "bound_by": "bytes",
        "library_ms": stem["library_ms"],
        "batched_ms": stem["batched_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
