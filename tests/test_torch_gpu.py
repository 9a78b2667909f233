"""Tests of the port that need the card (marked ``gpu``; each skips where
``torch.cuda.is_available()`` is false).  This file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import importlib

import numpy as np
import pytest
import torch

from unsupervised_anomaly_detection_brain_mri_tpu_torch import Config, Options
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import PathConfig
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import make_phantom
from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.inference import (
    AnomalyDetector,
    save_calibration,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import median as M
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _vol(shape, seed, kind):
    """The median's data sets: uniform; tied with exact +-0.0 and
    negatives; spread over e^-80..e^80 of both signs with +-0.0; constant
    (every window all-equal); two-level, where many windows hold exactly 62
    or 63 keys <= the lower level."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(size=shape).astype(np.float32)
    if kind == "tied":
        v = (np.floor(rng.uniform(size=shape) * 9) / 8.0 - 0.5)
        v = (v * (rng.uniform(size=shape) > 0.4)).astype(np.float32)
        v[rng.uniform(size=shape) < 0.2] = -0.0
        return v
    if kind == "spread":
        v = (np.exp(rng.uniform(-80, 80, size=shape))
             * rng.choice([-1.0, 1.0], size=shape)).astype(np.float32)
        u = rng.uniform(size=shape)
        v[u < 0.1] = 0.0
        v[u < 0.05] = -0.0
        return v
    if kind == "constant":
        return np.full(shape, 0.3, np.float32)
    if kind == "two_level":
        return np.where(rng.uniform(size=shape) < 0.5, -1.5, 2.5).astype(
            np.float32)
    raise ValueError(kind)


KINDS = ["uniform", "tied", "spread", "constant", "two_level"]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(110, 128, 128), (7, 37, 45), (2, 1, 5),
                                   (1, 1, 1)])
def test_cuda_kernel_equals_plain(cuda, shape, kind):
    vol = torch.from_numpy(_vol(shape, 5, kind)).to(cuda)
    before = M.LAUNCHES
    got = M.median_filter_3d_auto(vol, 5)
    torch.cuda.synchronize()
    assert M.LAUNCHES == before + 1
    assert torch.equal(got, M.median_filter_3d(vol))


@pytest.mark.gpu
def test_cuda_kernel_agrees_with_the_selection_rule(cuda):
    """The kernel's output equals ``median_select_reference`` run on the
    card over the volume's windows, whose rounds stay within 32."""
    vol = torch.from_numpy(_vol((6, 16, 32), 6, "uniform")).to(cuda)
    windows = M._symmetric_pad(vol, 2).unfold(0, 5, 1).unfold(
        1, 5, 1).unfold(2, 5, 1).reshape(-1, 125)
    med, rounds = M.median_select_reference(windows)
    assert torch.equal(M.median_filter_3d_cuda(vol), med.view(vol.shape))
    assert int(rounds.max()) <= 32


@pytest.mark.gpu
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    vol = torch.rand(4, 8, 8, device=cuda)
    for bad in (vol.double(), vol[None], vol.transpose(1, 2)):
        with pytest.raises(ValueError):
            M.median_filter_3d_cuda(bad)
    with pytest.raises(ValueError):
        M.median_filter_3d_auto(vol, 3)


@pytest.mark.gpu
def test_detect_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = Config(trainer="AE", model="autoencoder", outputWidth=32,
                 outputHeight=32, zDim=16, compute_dtype="float32")
    trainer = get_trainer("AE")(cfg, workdir=str(tmp_path), device="cuda")
    trainer.init_state()
    trainer.save_checkpoint()
    save_calibration(str(tmp_path), 0.1, 0.0,
                     Options(erosionIterations=1, minLesionSize=2), "phantom")
    vol = make_phantom(np.random.default_rng(0), 32, 12, True)["volume"]
    res = {dev: AnomalyDetector.from_workdir(str(tmp_path), device=dev)
           .detect(vol) for dev in ("cuda", "cpu")}
    np.testing.assert_allclose(res["cuda"]["anomaly_map"],
                               res["cpu"]["anomaly_map"], atol=1e-5, rtol=0)
    near = np.abs(res["cpu"]["anomaly_map"] - 0.1) <= 1e-5
    assert not ((res["cuda"]["mask"] != res["cpu"]["mask"]) & ~near).any()


def _small_cohort(with_lesions):
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.synthetic import (
        SYNTH,
        SyntheticOptions,
    )

    part = ({"TRAIN": 0.0, "VAL": 0.5, "TEST": 0.5} if with_lesions
            else {"TRAIN": 0.7, "VAL": 0.3, "TEST": 0.0})
    return SYNTH(SyntheticOptions(numPatients=4, imageSize=32, numSlices=16,
                                  targetSize=32, withLesions=with_lesions,
                                  seed=99 if with_lesions else 1234,
                                  partition=part))


@pytest.mark.gpu
def test_fit_on_card_draws_dropout_on_the_card_and_resumes(cuda, tmp_path):
    """The dropout generator lives on the trainer's device; its state is in
    the checkpoint, so a resumed run continues the same stream."""
    cfg = Config(trainer="AE", model="autoencoder", outputWidth=32,
                 outputHeight=32, zDim=16, batchsize=8, numEpochs=1,
                 dropout_rate=0.2)
    t = get_trainer("AE")(cfg, workdir=str(tmp_path), device="cuda")
    assert t.generator.device.type == "cuda"
    t.fit(_small_cohort(False))
    assert all(p.is_cuda for p in t.model.parameters())
    state = t.generator.get_state()
    again = get_trainer("AE")(cfg.replace(numEpochs=2),
                              workdir=str(tmp_path), device="cuda")
    again.init_state()
    assert again.restore_training_checkpoint() == 1
    assert torch.equal(again.generator.get_state(), state)
    assert again.step == t.step


@pytest.mark.gpu
def test_evaluate_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    E = importlib.import_module(
        "unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate")

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = Config(trainer="AE", model="autoencoder", outputWidth=32,
                 outputHeight=32, zDim=16, compute_dtype="float32")
    ds = _small_cohort(True)
    res = {}
    for dev in ("cuda", "cpu"):
        t = get_trainer("AE")(cfg, device=dev)
        t.init_state()
        before = M.LAUNCHES
        res[dev] = E.evaluate(ds, t, Options(
            paths=PathConfig(sample_dir=str(tmp_path / dev)),
            erosionIterations=3), cfg)
        launches = M.LAUNCHES - before
        assert launches == (len(ds.patients_of("TEST")) if dev == "cuda"
                            else 0)
    for k in ("diff_AUC", "diff_AUPRC", "bestDiceScore"):
        np.testing.assert_allclose(res["cuda"][k], res["cpu"][k], rtol=1e-4)
    np.testing.assert_allclose(res["cuda"]["diffs"], res["cpu"]["diffs"],
                               atol=1e-5, rtol=0)


def _vae_trainer(trainer, model, device, **kw):
    cfg = Config(trainer=trainer, model=model, outputWidth=32,
                 outputHeight=32, zDim=16, compute_dtype="float32",
                 restore_steps=5, tv_lambda=0.5, **kw)
    t = get_trainer(trainer)(cfg, device=device)
    t.init_state()
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("trainer,model", [
    ("VAE", "variational_autoencoder"),
    ("ceVAE", "context_encoder_variational_autoencoder"),
    ("VAE_You", "variational_autoencoder"),
    ("ceVAE", "context_encoder_variational_autoencoder_Zimmerer"),
])
def test_reconstruction_on_card_matches_cpu(cuda, monkeypatch, trainer,
                                            model):
    """Forward (VAE, ceVAE), 5-step restoration (VAE_You) and gradient
    restoration (ceVAE) with the same given noise, float32, TF32 off."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(6, 32, 32, 1)).astype(np.float32))
    noise = torch.from_numpy(np.random.default_rng(1).normal(
        size=(6, 16)).astype(np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        t = _vae_trainer(trainer, model, dev,
                         use_gradient_based_restoration=0.1)
        out[dev] = t.reconstruct_device(x.to(dev), generator=noise.to(dev))[
            "reconstruction"].cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_batched_restoration_on_card_equals_per_volume_calls(cuda):
    t = _vae_trainer("VAE_You", "variational_autoencoder", "cuda",
                     dropout_rate=0.5)
    counts = [4, 2]
    vols = torch.zeros(2, 4, 32, 32, 1, device=cuda)
    for k, n in enumerate(counts):
        vols[k, :n] = torch.rand(n, 32, 32, 1, device=cuda)
    got = t.reconstruct_volumes_device(
        vols, dropout=True, counts=counts,
        generators=[torch.Generator(device=cuda).manual_seed(k)
                    for k in range(2)])["reconstruction"]
    for k, n in enumerate(counts):
        alone = t.reconstruct_device(
            vols[k, :n], dropout=True,
            generator=torch.Generator(device=cuda).manual_seed(k),
        )["reconstruction"]
        torch.testing.assert_close(got[k, :n], alone, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_mc_evaluate_on_card(cuda, tmp_path):
    """MC evaluation on the card: one median launch per volume (not per
    sample), finite variances that are 0 outside the eroded mask."""
    E = importlib.import_module(
        "unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate")

    t = _vae_trainer("VAE", "variational_autoencoder", "cuda",
                     dropout_rate=0.5)
    ds = _small_cohort(True)
    before = M.LAUNCHES
    res = E.evaluate(ds, t, Options(
        paths=PathConfig(sample_dir=str(tmp_path)), erosionIterations=3,
        numMonteCarloSamples=4), t.config)
    assert M.LAUNCHES - before == len(ds.patients_of("TEST"))
    ev = res["epistemic_variance"]
    assert np.isfinite(ev).all() and (ev > 0).any()
    assert not ev[res["reconstructions"] == 0].any()


@pytest.mark.gpu
def test_run_all_ae_ce_on_card_within_the_h100_table(cuda, tmp_path):
    """``run_all --presets AE,CE --device cuda`` at the quality tables'
    recipe, checked against ``scoreboards/expected_h100.json``: exit 0."""
    import json

    from unsupervised_anomaly_detection_brain_mri_tpu_torch import run_all

    paths = tmp_path / "paths.json"
    paths.write_text(json.dumps({
        "CHECKPOINTDIR": str(tmp_path / "checkpoints"),
        "SAMPLEDIR": str(tmp_path / "samples")}))
    assert run_all.main([
        "--presets", "AE,CE", "--check",
        f"{run_all.SCOREBOARDS}/expected_h100.json", "--synthetic", "-E", "1",
        "-w", "32", "-g", "32", "-s", "0", "-e", "8", "-z", "16", "-b", "8",
        "-O", "0.5", "--precision", "float32", "--device", "cuda", "-c",
        str(paths)]) == 0


@pytest.mark.gpu
def test_step_one_differences_are_rounding_or_kinks(cuda):
    """One float32 ``AE`` step (TF32 off, dropout 0) at 32x32, batch 8, on
    the card and on the CPU from one start, each recording its kink
    pattern: every parameter element that differs by more than 1e-5 is
    rounding or a kink against the CPU's float64 gradients with each
    device's kink pattern, and each tensor's float32 gradients lie within
    ``GRAD64_RTOL`` of float64's (``chip_smoke.flipped_gradients``, phase
    6 at the preset's width)."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    chip_smoke = importlib.import_module("chip_smoke")
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import preset

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        config = preset("AE", batchsize=8, dropout_rate=0.0, zDim=16,
                        compute_dtype="float32", outputWidth=32,
                        outputHeight=32)
        card, cpu = (get_trainer("AE")(config, device=d)
                     for d in ("cuda", "cpu"))
        cpu.init_state()
        card.init_state()
        start = {k: v.detach().clone()
                 for k, v in cpu.model.state_dict().items()}
        card.model.load_state_dict(start)
        x = torch.from_numpy(np.random.default_rng(3).uniform(
            size=(8, 32, 32, 1)).astype(np.float32))
        kinks = ([], [])
        for trainer, record in ((card, kinks[0]), (cpu, kinks[1])):
            with chip_smoke.kink_patterns(record=record):
                trainer.train_step({"x": x.to(trainer.device)})
        n, rounding, kink, neither = chip_smoke.flipped_gradients(
            card, cpu, start, x, kinks)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    assert neither == 0 and rounding + kink == n
    assert len(kinks[0]) == len(kinks[1]) > 1


@pytest.mark.gpu
def test_program_spans_hold_their_kernels_on_the_profilers_clock(cuda):
    """A ``torch.cuda._sleep`` kernel launched and waited for inside a
    program span lies within the span on the clock the benchmark aligns
    the profiler's device events to, within 0.1 ms; a recording without
    ``annotate`` adds no event of its spans' names to the device's."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmark.common.trace import DeviceTrace

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import (
        trace,
    )

    t = get_trainer("AE")(Config(trainer="AE", model="autoencoder",
                                 outputWidth=32, outputHeight=32, zDim=16,
                                 batchsize=8), device="cuda")
    t.init_state()
    pool = {"x": torch.rand(16, 32, 32, 1, device=cuda)}
    torch.cuda._sleep(1000)
    t._run_epoch("TRAIN", pool, np.arange(16).reshape(2, 8))
    torch.cuda.synchronize()
    with DeviceTrace(cuda) as tr, trace.recording() as rec:
        for _ in range(3):
            with trace.span("test.sleep"):
                torch.cuda._sleep(2_000_000)
                torch.cuda.synchronize()
        t._run_epoch("TRAIN", pool, np.arange(16).reshape(2, 8))
    sleeps = [(s, e) for n, s, e in tr.events if "spin" in n]
    spans = [(s["start_ns"], s["end_ns"]) for s in rec.spans()
             if s["name"] == "test.sleep"]
    assert len(sleeps) == len(spans) == 3, sorted({n for n, _, _ in
                                                   tr.events})
    marker = tr.events[0][1] - tr._mark_ns  # the marker's launch to start
    for (k0, k1), (s0, s1) in zip(sleeps, spans):
        assert s0 - 100_000 <= k0 < k1 <= s1 + 100_000, (
            f"kernel {k0 - s0} ns after the span's start, "
            f"{s1 - k1} ns before its end; marker {marker} ns")
    names = {s["name"] for s in rec.spans()}
    assert "train.forward" in names
    assert not names & {n for n, _, _ in tr.events}


def _synchronising_calls(fn):
    """(``host_syncs`` counted over ``fn()``, the Python stack of each
    synchronising call that ``torch.cuda.set_sync_debug_mode("warn")``
    reports while ``fn`` runs, innermost frame first).  After a training
    epoch the mode's switch itself reports one, outside ``fn``."""
    import traceback
    import warnings

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import (
        trace,
    )

    reported, running = [], []

    def keep(message, category, filename, lineno, file=None, line=None):
        if running and "synchroniz" in str(message):
            stack = [f for f in traceback.extract_stack()[:-1]
                     if not f.filename.endswith("warnings.py")]
            reported.append(" <- ".join(
                f"{f.filename.rsplit('/', 2)[-1]}:{f.lineno} {f.name}"
                for f in reversed(stack[-6:])))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = keep
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with trace.recording() as rec:
                running.append(True)
                fn()
                running.clear()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return rec.counters().get("host_syncs", 0), reported


@pytest.mark.gpu
def test_host_syncs_count_every_synchronising_call_of_an_epoch(cuda):
    """One ``AE`` epoch (warm): the index upload is its one sync."""
    t = get_trainer("AE")(Config(trainer="AE", model="autoencoder",
                                 outputWidth=32, outputHeight=32, zDim=16,
                                 batchsize=8, dropout_rate=0.2),
                          device="cuda")
    t.init_state()
    pool = {"x": torch.rand(32, 32, 32, 1, device=cuda)}
    idxs = np.arange(32).reshape(4, 8)
    t._run_epoch("TRAIN", pool, idxs)
    counted, reported = _synchronising_calls(
        lambda: t._run_epoch("TRAIN", pool, idxs))
    assert counted == len(reported) == 1, reported


@pytest.mark.gpu
@pytest.mark.parametrize("trainer,model", [
    ("AE", "autoencoder"), ("VAE_You", "variational_autoencoder")])
def test_host_syncs_count_every_synchronising_call_of_detect(cuda, trainer,
                                                             model):
    """One warm ``detect`` with a threshold that leaves lesions: every
    synchronising call the debug mode reports is counted, and no more."""
    t = _vae_trainer(trainer, model, "cuda") if trainer == "VAE_You" else \
        get_trainer("AE")(Config(trainer="AE", model="autoencoder",
                                 outputWidth=32, outputHeight=32, zDim=16),
                          device="cuda")
    if trainer == "AE":
        t.init_state()
    det = AnomalyDetector(t, t.config, Options(erosionIterations=1,
                                               minLesionSize=2))
    vol = make_phantom(np.random.default_rng(0), 48, 12, True)["volume"]
    det.threshold = float(np.quantile(det.detect(vol)["anomaly_map"], 0.99))
    counted, reported = _synchronising_calls(lambda: det.detect(vol))
    assert counted == len(reported), reported
