#!/usr/bin/env python
"""Benchmark of the PyTorch port on one NVIDIA GPU: AE training throughput
(slices/sec/chip) on BrainWeb-shaped data, and the other rows of
``bench.py`` (the JAX package's benchmark), measured on the port.

Prints as its last line ONE JSON object with ``bench.py``'s contract:
  {"metric": "brainweb_ae_train_throughput", "value": N,
   "unit": "slices/sec/chip", "vs_baseline": N, "detail": {...}}

The measured configuration is the reference's flagship experiment
(`mains/main_AE.py`: dense AE, 128x128 slices, batch 128, Adam 1e-4) over
a seeded uniform pool of 1024 slices held in device memory.
``vs_baseline`` sets the port's epoch path (`train/base.py::_run_epoch`:
device-resident pool, bf16 compute, one host sync per epoch) against a
TF1-shaped loop of the same model on the same card: float32, each batch
copied from host numpy, one ``.item()`` of the loss per step
(`trainers/AE.py:63-90` crossed the host boundary twice per step).  Both
run in the same call: the host's speed varies between calls.

Sections run in ``bench.py``'s record-criticality order: ae_headline,
tf1_baseline, mfu, fastmode, gmvae_restoration, vae_you_restoration,
median, eval_pipeline, aae, vae, fanogan.  ``bench.py``'s convt_ablation
has no counterpart: ``ops/convt.py`` works around XLA's transposed-conv
kernel gradient, which materialises a reversed copy of the cotangent;
the port's transposed convolutions are cuDNN's, and the module is not
ported.

Timing: CUDA events around warm runs, best of ``TRIALS``; the marginal
rows take the slope between a short and a long run.  ``--device cpu``
exists for the tests: it times by the host clock, and its numbers are no
device metric.  FLOPs come from ``count_flops`` (``torch.utils.
flop_counter``'s formulas for convolutions and matrix products, forward
and backward, applied by a dispatch mode; ``FlopCounterMode`` itself
cannot count a step, since its module hooks refuse the penalties'
``autograd.grad``).  ``count_bytes`` adds up the bytes of every
dispatched operator's inputs and outputs, views left out: the traffic of
eager execution, which fuses nothing.  Peaks come from
``utils/misc.py::device_peaks``.

Failures are not hidden.  When a section raises, the script prints the
headline line with what it measured so far and ``detail["error"]``
naming the section, and exits 1; the watchdog
(``UADMRI_BENCH_WATCHDOG_SECS``, default 540 s) does the same when the
run overruns that budget.

Usage:  python3 bench_torch.py [--batch 128] [--image 128] [--slices 1024]
                               [--depth 112] [--restore-steps 150]
                               [--device cuda]
The size flags exist so that the tests and ``chip_smoke.py`` can run
small; their defaults are ``bench.py``'s sizes.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (  # noqa: E402
    Config,
    Options,
    preset,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (  # noqa: E402
    median as MED,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (  # noqa: E402
    metrics as M,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (  # noqa: E402
    postprocess as P,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.engine import (  # noqa: E402
    epoch_indices,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (  # noqa: E402
    get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils.misc import (  # noqa: E402
    device_peaks,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import (  # noqa: E402
    trace,
)

METRIC = "brainweb_ae_train_throughput"
UNIT = "slices/sec/chip"
TRIALS = 2  # best of 2, as bench.py
N_GAN = 256  # bench.py's pool of the batch-8 adversarial presets


# ---------------------------------------------------------------------------
# counters


class _FlopCounter(TorchDispatchMode):
    """Adds up ``torch.utils.flop_counter``'s formula of every dispatched
    operator that has one."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = self.registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


# operators that allocate without moving data
_NO_TRAFFIC = {"aten::empty", "aten::empty_strided", "aten::empty_like",
               "aten::lift_fresh"}


class _ByteCounter(TorchDispatchMode):
    """Adds up the bytes of every dispatched operator's tensor inputs and
    outputs (each read or written once), views and allocations left out."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and func._schema.name not in _NO_TRAFFIC:
            self.total += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def count_flops(fn: Callable, *args: Any, **kwargs: Any) -> int:
    """The FLOPs of ``fn(*args, **kwargs)``: convolutions and matrix
    products, forward and backward (double backwards included)."""
    with _FlopCounter() as counter:
        fn(*args, **kwargs)
    return int(counter.total)


def count_bytes(fn: Callable, *args: Any, **kwargs: Any) -> int:
    """The bytes ``fn(*args, **kwargs)`` moves when run eagerly: every
    operator's inputs read and outputs written once, nothing fused."""
    with _ByteCounter() as counter:
        fn(*args, **kwargs)
    return int(counter.total)


# ---------------------------------------------------------------------------
# device, clock


def resolve_device(name: str) -> torch.device:
    """The device to measure on; a CUDA device without CUDA raises (a
    measurement never falls back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but "
                           f"torch.cuda.is_available() is false")
    return device


def card_info(device: torch.device) -> Dict[str, Any]:
    """The device's name, and on a card its ``nvidia-smi`` name and power
    limit, torch and CUDA versions and the TF32 settings in force."""
    info = {"torch": torch.__version__, "cuda": torch.version.cuda,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    if device.type != "cuda":
        return {"device_kind": "cpu", "nvidia_smi": None,
                "timing": "host clock (CPU test run: no device metric)",
                **info}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return {"device_kind": torch.cuda.get_device_name(device),
            "nvidia_smi": smi.strip().splitlines()[0],
            "timing": "CUDA events", **info}


class Clock:
    """Time of device work: CUDA events on a card (no host sync before
    the start event; the end event is waited for), the host clock on the
    CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def seconds(self, fn: Callable[[], Any]) -> float:
        if not self.cuda:
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    def best_rate(self, fn: Callable[[int], Any], units_per_call: float,
                  n_calls: int) -> float:
        """Best of ``TRIALS`` of ``units_per_call * n_calls`` over the time
        of ``fn(n_calls)``."""
        return max(units_per_call * n_calls
                   / self.seconds(lambda: fn(n_calls))
                   for _ in range(TRIALS))

    def marginal_rate(self, fn: Callable[[int], Any], units_per_call: float,
                      lo: int, hi: int) -> Optional[float]:
        """``units_per_call`` per call from the slope between ``fn(lo)`` and
        ``fn(hi)`` (fixed costs cancel); None when the long run was not
        the slower."""
        t_lo = self.seconds(lambda: fn(lo))
        t_hi = self.seconds(lambda: fn(hi))
        if t_hi <= t_lo:
            return None
        return units_per_call * (hi - lo) / (t_hi - t_lo)


def _epoch_slices(n: int, bs: int) -> int:
    """Slices an epoch trains on: ``epoch_indices`` drops the remainder."""
    return (n // bs) * bs


def _round(v: Optional[float], digits: int = 1) -> Optional[float]:
    return None if v is None else round(float(v), digits)


def check_finite(label: str, values) -> None:
    bad = {k: float(v) for k, v in values.items()
           if not math.isfinite(float(v))}
    if bad:
        raise FloatingPointError(f"{label}: non-finite values {bad}")


# ---------------------------------------------------------------------------
# the run


class Run:
    """One benchmark run: its arguments, device, clock, the shared pool and
    headline trainer, and the result so far (written under a lock, since
    the watchdog thread may print it)."""

    def __init__(self, args: argparse.Namespace, device: torch.device):
        self.args = args
        self.device = device
        self.clock = Clock(device)
        self.rng = np.random.default_rng(0)
        self.lock = threading.Lock()
        self.reported = False
        self.value: Optional[float] = None
        self.vs_baseline: Optional[float] = None
        self.section = "startup"
        self.section_t0 = time.perf_counter()
        self.section_secs: Dict[str, float] = {}
        self.detail: Dict[str, Any] = {
            "batch": args.batch, "image": args.image, "slices": args.slices,
            "depth": args.depth, "restore_steps": args.restore_steps,
            "section_secs": self.section_secs}
        # set by ae_headline, read by later sections
        self.pool_np: Optional[np.ndarray] = None
        self.pool: Optional[Dict[str, torch.Tensor]] = None
        self.ae_config: Optional[Config] = None
        self.ae_trainer = None
        self.native_sps: Optional[float] = None

    # -- result -----------------------------------------------------------

    def record(self, **kw: Any) -> None:
        with self.lock:
            self.detail.update(kw)

    def begin(self, name: str) -> None:
        """Close the wall-clock bucket of the section in flight and open
        ``name``'s."""
        now = time.perf_counter()
        with self.lock:
            self.section_secs[self.section] = round(now - self.section_t0, 1)
            self.section_t0 = now
            self.section = name

    def emit(self, error: Optional[str] = None) -> bool:
        """Print the headline line once (with ``error`` in its detail);
        False when it was already printed."""
        with self.lock:
            if self.reported:
                return False
            self.reported = True
            detail = dict(self.detail)
            if error is not None:
                detail["error"] = error
            print(json.dumps({"metric": METRIC, "value": self.value,
                              "unit": UNIT, "vs_baseline": self.vs_baseline,
                              "detail": detail}), flush=True)
            return True

    def watchdog(self, secs: float) -> None:  # pragma: no cover - on hangs
        if self.emit(f"watchdog: the {secs:g} s budget ran out during "
                     f"[{self.section}]"):
            os._exit(1)

    # -- helpers ----------------------------------------------------------

    def trainer(self, config: Config):
        t = get_trainer(config.trainer)(config, Options(), device=self.device)
        t.init_state()
        return t

    def uniform(self, *shape: int) -> torch.Tensor:
        return torch.from_numpy(self.rng.uniform(0, 1, shape).astype(
            np.float32)).to(self.device)

    def epoch_runner(self, trainer, pool: Dict[str, torch.Tensor]
                     ) -> Callable[[int], Dict[str, torch.Tensor]]:
        """``run(n)``: ``n`` TRAIN epochs through the trainer's own epoch
        path, each over a fresh permutation; returns the last epoch's
        metrics (device tensors, no host sync)."""
        n = int(pool["x"].shape[0])
        bs = trainer.config.batchsize

        def run(n_epochs: int) -> Dict[str, torch.Tensor]:
            metrics = {}
            for _ in range(n_epochs):
                metrics = trainer._run_epoch(
                    "TRAIN", pool, epoch_indices(self.rng, n, bs))
            return metrics

        return run

    def step_flops(self, trainer) -> int:
        """The FLOPs of one training step of ``trainer`` on the pool's first
        batch (the step is taken)."""
        bs = trainer.config.batchsize
        return count_flops(trainer.train_step, {"x": self.pool["x"][:bs]})

    def mfu(self, trainer, sps: float, prefix: str) -> float:
        flops = self.step_flops(trainer)
        peak, _ = device_peaks(self.detail["device_kind"])
        self.record(**{
            f"{prefix}_train_step_gflops": round(flops / 1e9, 3),
            f"{prefix}_mfu_pct": round(
                100.0 * flops * sps / trainer.config.batchsize / peak, 3)})
        return peak


# ---------------------------------------------------------------------------
# sections, in bench.py's order


def ae_headline(run: Run) -> None:
    """Warm AE slices/s over the device-resident pool, best of TRIALS runs
    of 12 epochs, and the 4-vs-16-epoch marginal slope."""
    a = run.args
    run.pool_np = run.rng.uniform(
        0, 1, (a.slices, a.image, a.image, 1)).astype(np.float32)
    run.pool = {"x": torch.from_numpy(run.pool_np).to(run.device)}
    run.ae_config = Config(trainer="AE", model="autoencoder",
                           batchsize=a.batch, outputWidth=a.image,
                           outputHeight=a.image, zDim=128, numEpochs=1)
    tr = run.ae_trainer = run.trainer(run.ae_config)
    epoch = run.epoch_runner(tr, run.pool)
    check_finite("AE warm-up", epoch(1))
    units = _epoch_slices(a.slices, a.batch)
    sps = run.clock.best_rate(epoch, units, 12)
    run.native_sps = sps
    with run.lock:
        run.value = round(sps, 1)
    run.record(native_ae_slices_per_sec=round(sps, 1),
               native_ae_slices_per_sec_marginal=_round(
                   run.clock.marginal_rate(epoch, units, 4, 16)))
    check_finite("AE", epoch(1))


def tf1_baseline(run: Run) -> None:
    """The same model in float32, TF1-shaped: per batch a host-to-device
    copy from numpy and one ``.item()`` of the loss."""
    a = run.args
    tr = run.trainer(run.ae_config.replace(compute_dtype="float32"))

    def steps(n_steps: int) -> None:
        idxs = epoch_indices(run.rng, a.slices, a.batch)
        for i in range(n_steps):
            row = idxs[i % len(idxs)]
            batch = {"x": torch.from_numpy(run.pool_np[row]).to(run.device)}
            loss = tr.train_step(batch)["loss"].item()
        if not math.isfinite(loss):
            raise FloatingPointError(f"TF1-shaped baseline: loss {loss}")

    steps(2)  # warm-up
    baseline = run.clock.best_rate(steps, a.batch, 8)
    with run.lock:
        run.vs_baseline = round(run.native_sps / baseline, 2)
    run.record(tf1_shaped_baseline_slices_per_sec=round(baseline, 1))


def mfu(run: Run) -> None:
    """FLOPs of one parity AE train step x measured steps/s over the peak
    of ``device_peaks``."""
    peak = run.mfu(run.ae_trainer, run.native_sps, "ae")
    run.record(mfu_flop_model=(
        "torch.utils.flop_counter formulas (convolutions and matrix "
        "products, forward and backward) summed over the operators of one "
        "train_step by a dispatch mode, * measured steps/sec; "
        f"peak={peak / 1e12:.0f}e12 ({run.detail['device_kind']})"))


def fastmode(run: Run) -> None:
    """The non-parity profile (s2d stem + d2s head): slices/s, speedup,
    marginal slope and MFU."""
    a = run.args
    tr = run.trainer(run.ae_config.replace(spaceToDepthStem=True,
                                           depthToSpaceHead=True))
    epoch = run.epoch_runner(tr, run.pool)
    check_finite("fast-profile AE warm-up", epoch(1))
    units = _epoch_slices(a.slices, a.batch)
    sps = run.clock.best_rate(epoch, units, 4)
    marginal = run.clock.marginal_rate(epoch, units, 4, 16)
    native_marginal = run.detail.get("native_ae_slices_per_sec_marginal")
    run.record(
        fastmode_ae_slices_per_sec=round(sps, 1),
        fastmode_speedup=round(sps / run.native_sps, 3),
        fastmode_ae_slices_per_sec_marginal=_round(marginal),
        fastmode_speedup_marginal=(
            round(marginal / native_marginal, 3)
            if marginal and native_marginal else None))
    run.mfu(tr, sps, "fastmode_ae")


def _restoration(run: Run, config: Config, prefix: str,
                 speedup_key: str) -> None:
    """Restoration of one ``depth``-slice volume (reconstruct_device), and
    of ``Options.restorationVolumeBatch`` volumes in one restoration
    (reconstruct_volumes_device, the evaluator's path): volumes/s and the
    batched speedup."""
    a = run.args
    tr = run.trainer(config)
    vol = run.uniform(a.depth, a.image, a.image, 1)
    k = Options().restorationVolumeBatch
    vols = run.uniform(k, a.depth, a.image, a.image, 1)
    gens = [torch.Generator(device=run.device).manual_seed(i)
            for i in range(k)]

    def single(n: int) -> torch.Tensor:
        for _ in range(n):
            out = tr.reconstruct_device(vol)["reconstruction"]
        return out

    def batched(n: int) -> torch.Tensor:
        for _ in range(n):
            out = tr.reconstruct_volumes_device(
                vols, generators=gens)["reconstruction"]
        return out

    check_finite(prefix, {"single": single(1).sum(),
                          "batched": batched(1).sum()})
    single_vps = run.clock.best_rate(single, 1, 2)
    batched_vps = run.clock.best_rate(batched, k, 2)
    run.record(**{f"{prefix}_volumes_per_sec": round(single_vps, 3),
                  f"{prefix}_batched_volumes_per_sec": round(batched_vps, 3),
                  speedup_key: round(batched_vps / single_vps, 2)})


def gmvae_restoration(run: Run) -> None:
    a = run.args
    _restoration(run, preset("GMVAE_spatial", numEpochs=1,
                             outputWidth=a.image, outputHeight=a.image,
                             restore_steps=a.restore_steps),
                 "gmvae_restoration", "gmvae_restoration_batched_speedup")


def vae_you_restoration(run: Run) -> None:
    a = run.args
    _restoration(run, Config(trainer="VAE_You",
                             model="variational_autoencoder",
                             batchsize=a.batch, outputWidth=a.image,
                             outputHeight=a.image, zDim=128,
                             restore_steps=a.restore_steps, tv_lambda=1.0),
                 "vae_you_restoration", "restoration_batched_speedup")


def median(run: Run) -> None:
    """The 5^3 median of a uniform ``depth``-slice volume: the kernel's
    output must equal the plain version's and the trace counter
    ``median_kernel`` must rise by one per kernel call; then volumes/s of
    both."""
    a = run.args
    vol = run.uniform(a.depth, a.image, a.image)
    per_call = 1 if run.device.type == "cuda" else 0  # the CPU: plain

    def launches() -> int:
        return rec.counters().get("median_kernel", 0)

    def calls(f):
        def run_n(n: int) -> torch.Tensor:
            for _ in range(n):
                out = f(vol)
            return out
        return run_n

    with trace.recording() as rec:
        got = MED.median_filter_3d_auto(vol)
        if not torch.equal(got, MED.median_filter_3d(vol)):
            raise AssertionError("the median kernel's output differs from "
                                 "the plain version's")
        if launches() != per_call:
            raise AssertionError(f"{launches()} median kernel launches for "
                                 f"one call, expected {per_call}")
        vps = run.clock.best_rate(calls(MED.median_filter_3d_auto), 1, 5)
        if launches() != per_call * (1 + 5 * TRIALS):
            raise AssertionError(f"{launches()} median kernel launches, "
                                 f"expected {per_call * (1 + 5 * TRIALS)}")
    plain_vps = run.clock.best_rate(calls(MED.median_filter_3d), 1, 5)
    run.record(median5_equals_plain=True, median5_launches=launches(),
               median5_volumes_per_sec=round(vps, 2),
               median5_plain_volumes_per_sec=round(plain_vps, 2),
               kernel_vs_plain_median_speedup=round(vps / plain_vps, 2))


def eval_pipeline(run: Run) -> None:
    """The on-device postprocess of 4 x ``depth`` slices: erosion 12,
    positive residual, median, metric sweep, components > 7 voxels; and the
    metric sweep alone (marginal slope of 2 vs 12 calls)."""
    a = run.args
    H = a.image
    S = 4 * a.depth
    xs = run.uniform(S, H, H)
    recs = xs * 0.9
    yy, xx = np.mgrid[:H, :H]
    disc = (((yy - H / 2) ** 2 + (xx - H / 2) ** 2)
            < (0.4 * H) ** 2).astype(np.float32)
    skm = torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(disc, (S, H, H)))).to(run.device)
    labels = xs > 0.97

    def pipeline():
        eroded = P.binary_erosion_2d(skm, 12)
        diff = torch.clamp_min(xs - recs, 0.0) * eroded.to(xs.dtype)
        diff = MED.median_filter_3d_auto(diff.contiguous())
        summary = M.anomaly_curve_summary(diff.reshape(-1),
                                          labels.reshape(-1))
        kept = P.filter_small_components(diff > summary["best_threshold"], 7)
        return {"auc": summary["auc"], "best_dice": summary["best_dice"],
                "kept": kept.sum()}

    check_finite("eval pipeline", pipeline())  # warm-up
    seconds = run.clock.seconds(pipeline)
    dflat = torch.abs(xs - recs).reshape(-1)
    lflat = labels.reshape(-1)

    def sweeps(n: int) -> torch.Tensor:
        for _ in range(n):
            auc = M.anomaly_curve_summary(dflat, lflat)["auc"]
        return auc

    check_finite("metric sweep", {"auc": sweeps(1)})
    per_sec = run.clock.marginal_rate(sweeps, 1, 2, 12)
    run.record(eval_pipeline_sec_4x112=round(seconds, 4),
               metrics_sweep_ms_7m3voxels=(
                   round(1e3 / per_sec, 3) if per_sec else None))


def aae(run: Run) -> None:
    """AAE at the parity schedule's first epochs (``ae_iters`` AE updates,
    ``d_iters`` critic updates and one generator update a batch) and at its
    steady state; the per-update costs against AE, and the marginal cost of
    one AE substep (null with a note when the difference is <= 0)."""
    a = run.args
    tr = run.trainer(Config(trainer="AAE", model="adversarial_autoencoder",
                            batchsize=a.batch, outputWidth=a.image,
                            outputHeight=a.image, zDim=128,
                            intermediateResolutions=(16, 16)))
    units = _epoch_slices(a.slices, a.batch)
    epoch = run.epoch_runner(tr, run.pool)
    rates, iters = {}, {}
    for label, at_epoch in (("first", 0), ("steady", 9)):
        tr.init_state()
        tr.epoch = at_epoch
        iters[label] = tr.ae_iters()
        check_finite(f"AAE epoch {at_epoch} warm-up", epoch(1))
        rates[label] = run.clock.best_rate(epoch, units, 2)
    ai0, ai1 = iters["first"], iters["steady"]
    updates = ai0 + tr.d_iters + 1  # AE x ai0 + critic x d_iters + generator
    ae_ms = 1e3 * a.batch / run.native_sps
    out = {"aae_train_slices_per_sec": round(rates["first"], 1),
           "aae_train_slices_per_sec_steady": round(rates["steady"], 1),
           "aae_updates_per_batch": updates,
           "aae_updates_per_batch_steady": ai1 + tr.d_iters + 1,
           "ae_ms_per_update": round(ae_ms, 3),
           "aae_ms_per_update": round(
               1e3 * a.batch / rates["first"] / updates, 3)}
    dt_batch = 1 / rates["first"] - 1 / rates["steady"]
    if ai0 > ai1 and dt_batch > 0:
        substep_ms = 1e3 * a.batch * dt_batch / (ai0 - ai1)
        out.update(aae_ae_substep_ms=round(substep_ms, 3),
                   aae_ae_substep_vs_ae=round(substep_ms / ae_ms, 3))
    else:
        out.update(aae_ae_substep_ms=None, aae_ae_substep_note=(
            "noise-dominated: schedule A/B time difference <= 0"))
    run.record(**out)


def vae(run: Run) -> None:
    a = run.args
    tr = run.trainer(Config(trainer="VAE", model="variational_autoencoder",
                            batchsize=a.batch, outputWidth=a.image,
                            outputHeight=a.image, zDim=128))
    epoch = run.epoch_runner(tr, run.pool)
    check_finite("VAE warm-up", epoch(1))
    run.record(native_vae_slices_per_sec=round(run.clock.best_rate(
        epoch, _epoch_slices(a.slices, a.batch), 4), 1))


def fanogan(run: Run) -> None:
    """fAnoGAN's WGAN and encoder phases and AnoVAEGAN at their presets'
    batch 8, on a pool of up to N_GAN slices."""
    a = run.args
    n = min(N_GAN, a.slices)
    pool = {"x": run.pool["x"][:n]}
    out = {}
    for key, name, encoder in (
            ("fanogan_wgan_slices_per_sec", "fAnoGAN", False),
            ("fanogan_encoder_slices_per_sec", "fAnoGAN", True),
            ("anovaegan_slices_per_sec", "AnoVAEGAN", False)):
        config = preset(name, numEpochs=1, outputWidth=a.image,
                        outputHeight=a.image)
        tr = run.trainer(config)
        # fAnoGAN's epochs from numEpochs on are its encoder phase
        tr.epoch = config.numEpochs if encoder else 0
        epoch = run.epoch_runner(tr, pool)
        check_finite(f"{key} warm-up", epoch(1))
        out[key] = round(run.clock.best_rate(
            epoch, _epoch_slices(n, config.batchsize), 1), 1)
    run.record(**out)


SECTIONS = (ae_headline, tf1_baseline, mfu, fastmode, gmvae_restoration,
            vae_you_restoration, median, eval_pipeline, aae, vae, fanogan)

# the rows a complete run gives a number; the marginal slopes, the metric
# sweep and the AE substep may be null (a noise-dominated difference)
ROW_KEYS = (
    "native_ae_slices_per_sec", "tf1_shaped_baseline_slices_per_sec",
    "ae_train_step_gflops", "ae_mfu_pct", "fastmode_ae_slices_per_sec",
    "fastmode_speedup", "fastmode_ae_train_step_gflops",
    "fastmode_ae_mfu_pct", "gmvae_restoration_volumes_per_sec",
    "gmvae_restoration_batched_volumes_per_sec",
    "gmvae_restoration_batched_speedup",
    "vae_you_restoration_volumes_per_sec",
    "vae_you_restoration_batched_volumes_per_sec",
    "restoration_batched_speedup", "median5_volumes_per_sec",
    "median5_plain_volumes_per_sec", "kernel_vs_plain_median_speedup",
    "eval_pipeline_sec_4x112", "aae_train_slices_per_sec",
    "aae_train_slices_per_sec_steady", "ae_ms_per_update",
    "aae_ms_per_update", "native_vae_slices_per_sec",
    "fanogan_wgan_slices_per_sec", "fanogan_encoder_slices_per_sec",
    "anovaegan_slices_per_sec")


# ---------------------------------------------------------------------------


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--image", type=int, default=128)
    ap.add_argument("--slices", type=int, default=1024,
                    help="slices in the training pool")
    ap.add_argument("--depth", type=int, default=112,
                    help="slices of a volume (restoration, median, eval)")
    ap.add_argument("--restore-steps", type=int, default=150)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), or cpu for the tests")
    return ap


def main(argv: Optional[list] = None) -> int:
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    run = Run(args, device)
    run.record(**card_info(device))
    if run.detail["nvidia_smi"]:
        print(run.detail["nvidia_smi"], flush=True)
    secs = float(os.environ.get("UADMRI_BENCH_WATCHDOG_SECS", "540"))
    timer = threading.Timer(secs, run.watchdog, (secs,))
    timer.daemon = True
    timer.start()
    try:
        for section in SECTIONS:
            run.begin(section.__name__)
            section(run)
        run.begin("done")
    except Exception as e:
        traceback.print_exc()
        run.emit(f"section {run.section} failed: {type(e).__name__}: "
                 f"{str(e)[:300]}")
        return 1
    finally:
        timer.cancel()
    return 0 if run.emit() else 1


if __name__ == "__main__":
    sys.exit(main())
