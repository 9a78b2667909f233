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
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import trace


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
    with trace.recording() as rec:
        got = M.median_filter_3d_auto(vol, 5)
    torch.cuda.synchronize()
    assert rec.counters() == {"median_kernel": 1}
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
        with trace.recording() as rec:
            res[dev] = E.evaluate(ds, t, Options(
                paths=PathConfig(sample_dir=str(tmp_path / dev)),
                erosionIterations=3), cfg)
        launches = rec.counters().get("median_kernel", 0)
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
    with trace.recording() as rec:
        res = E.evaluate(ds, t, Options(
            paths=PathConfig(sample_dir=str(tmp_path)), erosionIterations=3,
            numMonteCarloSamples=4), t.config)
    assert rec.counters()["median_kernel"] == len(ds.patients_of("TEST"))
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
    """(the trace counters over ``fn()``, the Python stack of each
    synchronising call that ``torch.cuda.set_sync_debug_mode("warn")``
    reports while ``fn`` runs, innermost frame first, followed by the
    port's spans open at the call).  After a training epoch the mode's
    switch itself reports one, outside ``fn``."""
    import traceback
    import warnings

    reported, running = [], []

    def keep(message, category, filename, lineno, file=None, line=None):
        if running and "synchroniz" in str(message):
            stack = [f for f in traceback.extract_stack()[:-1]
                     if not f.filename.endswith("warnings.py")]
            spans = [s["name"] for s in running[0].spans()
                     if s["end_ns"] == 0]
            reported.append(" <- ".join(
                f"{f.filename.rsplit('/', 2)[-1]}:{f.lineno} {f.name}"
                for f in reversed(stack[-6:])) + " in " + "/".join(spans))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = keep
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with trace.recording() as rec:
                running.append(rec)
                fn()
                running.clear()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return rec.counters(), reported


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
    counters, reported = _synchronising_calls(
        lambda: t._run_epoch("TRAIN", pool, idxs))
    assert counters.get("host_syncs", 0) == len(reported) == 1, reported


@pytest.mark.gpu
@pytest.mark.parametrize("trainer,model", [
    ("AE", "autoencoder"), ("VAE_You", "variational_autoencoder")])
def test_host_syncs_count_every_synchronising_call_of_detect(cuda, trainer,
                                                             model):
    """One warm ``detect`` with a threshold that leaves lesions: every
    synchronising call the debug mode reports is counted, and no more; the
    components go through the kernel chain, with no sync inside
    ``serve.components`` and no propagation round."""
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
    counters, reported = _synchronising_calls(lambda: det.detect(vol))
    assert counters.get("host_syncs", 0) == len(reported), reported
    _assert_components_never_sync(counters, reported)


def _assert_components_never_sync(counters, reported):
    """One request's components went through the kernel chain once, with
    no propagation round and no synchronising call inside
    ``serve.components``."""
    assert counters.get("cc_kernel") == counters.get("serve.requests") == 1
    assert counters.get("cc_rounds", 0) == 0
    assert not [r for r in reported if "serve.components" in r], reported


def _serve_phantom():
    """A lesioned phantom at the serving geometry, (181, 217, 181)."""
    import _torch_realdata as R

    lab = R.head_labels(R.BRAINWEB_SHAPE, 2)
    return R.intensity(lab, R._FLAIR, np.random.default_rng(7),
                       noise_pct=3.0, inu_pct=20.0)


@pytest.mark.gpu
def test_detect_prepares_on_card_as_on_cpu_at_the_serving_geometry(
        cuda, tmp_path, monkeypatch):
    """The card's prep (``eval/prep.py``) against the CPU's host prep for
    the same weights and scan: x within 1e-6, the prior's quantile
    bit-equal, the map and mask as in ``test_detect_on_card_matches_cpu``."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval import (
        inference,
    )

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = Config(trainer="AE", model="autoencoder", outputWidth=128,
                 outputHeight=128, zDim=128, compute_dtype="float32")
    trainer = get_trainer("AE")(cfg, workdir=str(tmp_path), device="cuda")
    trainer.init_state()
    trainer.save_checkpoint()
    save_calibration(str(tmp_path), 0.1, 0.0, Options(), "phantom")
    vol = _serve_phantom()
    seen = {}
    post = inference._postprocess

    def keep(x, rec, eroded, prior_q, *a, **k):
        seen[x.device.type] = (x.cpu().numpy(), prior_q)
        return post(x, rec, eroded, prior_q, *a, **k)

    monkeypatch.setattr(inference, "_postprocess", keep)
    dets = {dev: AnomalyDetector.from_workdir(str(tmp_path), device=dev)
            for dev in ("cuda", "cpu")}
    res = {"cpu": dets["cpu"].detect(vol)}
    t = float(np.quantile(res["cpu"]["anomaly_map"], 0.999))
    res = {dev: det.detect(vol, threshold=t) for dev, det in dets.items()}
    np.testing.assert_allclose(seen["cuda"][0], seen["cpu"][0], atol=1e-6,
                               rtol=0)
    assert seen["cuda"][1] == seen["cpu"][1]
    np.testing.assert_allclose(res["cuda"]["anomaly_map"],
                               res["cpu"]["anomaly_map"], atol=1e-5, rtol=0)
    near = np.abs(res["cpu"]["anomaly_map"] - t) <= 1e-5
    assert not ((res["cuda"]["mask"] != res["cpu"]["mask"]) & ~near).any()
    assert res["cpu"]["anomalous_voxels"] > 0


@pytest.mark.gpu
def test_every_request_on_the_card_is_prepared_there(cuda):
    """``serve.prep_device`` counts each ``detect`` on the card."""
    t = get_trainer("AE")(Config(trainer="AE", model="autoencoder",
                                 outputWidth=32, outputHeight=32, zDim=16),
                          device="cuda")
    t.init_state()
    det = AnomalyDetector(t, t.config, Options(erosionIterations=1,
                                               minLesionSize=2), 0.1)
    vol = make_phantom(np.random.default_rng(0), 48, 12, True)["volume"]
    with trace.recording() as rec:
        for _ in range(3):
            det.detect(vol)
    counts = rec.counters()
    assert counts["serve.prep_device"] == counts["serve.requests"] == 3
    names = [s["name"] for s in rec.spans()]
    assert names.count("serve.normalize") == 3


@pytest.mark.gpu
def test_host_syncs_count_every_synchronising_call_of_detect_with_a_brainmask(
        cuda):
    """A warm ``detect`` given a brain mask (uploaded and zoomed on the
    card): every synchronising call the debug mode reports is counted, and
    none lies inside ``serve.components``."""
    t = get_trainer("AE")(Config(trainer="AE", model="autoencoder",
                                 outputWidth=32, outputHeight=32, zDim=16),
                          device="cuda")
    t.init_state()
    det = AnomalyDetector(t, t.config, Options(erosionIterations=1,
                                               minLesionSize=2))
    ph = make_phantom(np.random.default_rng(0), 48, 12, True)
    vol, mask = ph["volume"], ph["brainmask"]
    det.threshold = float(np.quantile(
        det.detect(vol, mask)["anomaly_map"], 0.99))
    counters, reported = _synchronising_calls(lambda: det.detect(vol, mask))
    assert counters.get("host_syncs", 0) == len(reported), reported
    _assert_components_never_sync(counters, reported)


def _ccl_mask(case):
    """The components' data sets: random masks at four densities (0.5 is
    above 26-connectivity's percolation point: one component snakes
    through the volume), a stack of 20-slice chunks, lesion blobs at the
    serving shape, one voxel, and masks with no foreground."""
    import _torch_ccl as C

    rng = np.random.default_rng(11)
    if case.startswith("density"):
        return rng.uniform(size=(24, 48, 40)) < float(case.split("_")[1])
    if case == "stack":
        return rng.uniform(size=(3, 20, 64, 64)) < 0.3
    if case == "serving":
        return C.lesion_blobs((181, 128, 128), 3)
    if case == "one_voxel":
        return np.ones((1, 1, 1), bool)
    if case == "empty":
        return np.zeros((9, 16, 16), bool)
    if case == "empty_stack":
        return np.zeros((2, 5, 8, 8), bool)
    raise ValueError(case)


CCL_CASES = ["density_0.01", "density_0.1", "density_0.3", "density_0.5",
             "stack", "serving", "one_voxel", "empty", "empty_stack"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CCL_CASES)
def test_cuda_components_equal_the_plain_propagation(cuda, case):
    """The kernel chain's labels and size filter equal the plain
    propagation's, run to its fixpoint on the card, bit for bit, and the
    labels equal SciPy's renamed to the minimal flat index."""
    import _torch_ccl as C

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import ccl
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
        postprocess as P,
    )

    m = torch.from_numpy(_ccl_mask(case)).to(cuda)
    labels, conv = P.connected_components_3d(m, return_converged=True)
    ref, ref_conv = P.connected_components_3d_plain(m, 10 ** 6,
                                                    return_converged=True)
    assert bool(torch.as_tensor(ref_conv).all())
    assert bool(torch.as_tensor(conv).all())
    assert labels.dtype == torch.int32 and labels.device.type == "cuda"
    assert torch.equal(labels, ref)
    np.testing.assert_array_equal(labels.cpu().numpy(),
                                  C.min_index_labels(m.cpu().numpy()))
    for min_size in (0, 7):
        got = P.filter_small_components(m, min_size)
        assert got.dtype == torch.float32
        assert torch.equal(got, P.filter_small_components_plain(
            m, min_size, 10 ** 6))
    assert torch.equal(ccl.filter_small_components_cuda(m.to(torch.uint8), 7),
                       P.filter_small_components(m, 7))


@pytest.mark.gpu
def test_cuda_components_count_each_call_and_never_sync(cuda):
    """``cc_kernel`` advances once a call of the chain; no call reads
    anything back (``set_sync_debug_mode("error")``)."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
        postprocess as P,
    )

    m = torch.rand(12, 32, 32, device=cuda) < 0.2
    P.filter_small_components(m, 7)  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with trace.recording() as rec:
            labels, conv = P.connected_components_3d(m, return_converged=True)
            out, fconv = P.filter_small_components(m, 7, return_converged=True)
            stacked = P.connected_components_3d(m.reshape(3, 4, 32, 32))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert rec.counters() == {"cc_kernel": 3}
    assert conv is True and fconv is True
    assert labels.shape == out.shape == m.shape
    assert stacked.shape == (3, 4, 32, 32)


@pytest.mark.gpu
def test_cuda_components_reject_what_the_kernels_do_not_take(cuda):
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import ccl

    m = torch.rand(4, 8, 8, device=cuda) < 0.5
    for bad in (m.transpose(1, 2), m.float(), m.to(torch.int32), m[0],
                m.cpu()):
        for fn in (ccl.connected_components_3d_cuda,
                   lambda x: ccl.filter_small_components_cuda(x, 7)):
            with pytest.raises(ValueError):
                fn(bad)


def _stem_case(shape, dtype, channels_last, cuda):
    """grad_out of a SAME k5 s2 stem over (B, H, W) inputs, its weight and
    pads, from a seeded generator."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import (
        layers,
    )

    B, H, W = shape
    ph, pw = layers._same_pads(H, 5, 2), layers._same_pads(W, 5, 2)
    OH, OW = (H + sum(ph) - 5) // 2 + 1, (W + sum(pw) - 5) // 2 + 1
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    g = torch.randn((B, 32, OH, OW), generator=gen, device=cuda).to(dtype)
    if channels_last:
        g = g.contiguous(memory_format=torch.channels_last)
    w = (torch.randn((32, 1, 5, 5), generator=gen, device=cuda)
         * 0.2).to(dtype)
    return g, w, ph, pw


def _library_input_grad(g, w, size, ph, pw):
    """The library's input gradient of the stem (input only), cropped to
    the unpadded input and cast to float32 as the pad's and the cast's
    backwards do."""
    H, W = size
    x = torch.empty((g.shape[0], 1, H + sum(ph), W + sum(pw)),
                    dtype=g.dtype, device=g.device)
    grad = torch.ops.aten.convolution_backward(
        g, x, w, None, [2, 2], [0, 0], [1, 1], False, [0, 0], 1,
        [True, False, False])[0]
    return grad[:, :, ph[0]:ph[0] + H, pw[0]:pw[0] + W].float()


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,channels_last", [
    (shape, dtype, False)
    for shape in ((181, 128, 128), (8, 128, 128), (7, 37, 45))
    for dtype in (torch.bfloat16, torch.float32)
] + [((181, 128, 128), torch.bfloat16, True)])
def test_stem_dgrad_kernel_matches_the_library_input_gradient(
        cuda, monkeypatch, shape, channels_last, dtype):
    """``csrc/stem_dgrad.cu`` against cuDNN's input gradient (TF32 off),
    on NCHW grad_out as served, and once on channels-last grad_out, which
    the wrapper makes contiguous.  Both sum 800 products in fp32 in their
    own order and round once to the dtype, so they may differ by one ulp
    of the dtype plus the fp32 sums' error bound, 200 terms of u = 2^-24
    each over S, the sum of the products' magnitudes, for each: 2^-15 S
    covers both.  In bf16 nearly every value rounds to the same number."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
        stem_dgrad,
    )

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    g, w, ph, pw = _stem_case(shape, dtype, channels_last, cuda)
    size = shape[1:]
    with trace.recording() as rec:
        got = stem_dgrad.stem_input_grad_cuda(g, w, size, ph, pw)
    torch.cuda.synchronize()
    assert rec.counters() == {"stem_dgrad_kernel": 1}
    want = _library_input_grad(g, w, size, ph, pw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    S = stem_dgrad.stem_input_grad_plain(g.float().abs(), w.float().abs(),
                                         size, ph, pw)
    if dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(2.0 ** -126))) - 7)
        assert float((got == want).float().mean()) >= 0.999
    else:
        ulp = torch.zeros_like(want)
    excess = (got - want).abs() - ulp - 2.0 ** -15 * S
    assert float(excess.max()) <= 0, float(excess.max())


def _vae_you_128(cuda):
    """The served VAE_You configuration: 128x128, zDim 128, bf16."""
    cfg = Config(trainer="VAE_You", model="variational_autoencoder",
                 outputWidth=128, outputHeight=128, zDim=128,
                 intermediateResolutions=(8, 8), compute_dtype="bfloat16",
                 restore_steps=150, tv_lambda=0.5)
    t = get_trainer("VAE_You")(cfg, device="cuda")
    t.init_state()
    return t


@pytest.mark.gpu
def test_restoration_of_a_volume_launches_the_stem_kernel_each_step(cuda):
    """A served 181-slice volume's 150 restoration steps take the stem's
    input gradient from the kernel once a step, and leave every parameter
    requiring grad."""
    t = _vae_you_128(cuda)
    vols = torch.rand(1, 181, 128, 128, 1, device=cuda)
    with trace.recording() as rec:
        out = t.reconstruct_volumes_device(
            vols, generators=[torch.Generator(device=cuda).manual_seed(0)]
        )["reconstruction"]
    torch.cuda.synchronize()
    assert rec.counters().get("stem_dgrad_kernel") == 150
    assert bool(torch.isfinite(out).all())
    assert all(p.requires_grad for p in t.model.parameters())


@pytest.mark.gpu
def test_restoration_step_points_as_the_library_path(cuda, monkeypatch):
    """One restoration step's input gradient at the same input and noise,
    through the kernel and through the library: the same direction (a
    single step: the 150-step chain is chaotic)."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import (
        layers,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
        restoration,
    )

    t = _vae_you_128(cuda)
    x = torch.from_numpy(np.stack([
        make_phantom(np.random.default_rng(s), 128, 4, False)["volume"]
        for s in range(4)]).transpose(0, 3, 1, 2).reshape(16, 128, 128, 1)
        .astype(np.float32)).to(cuda)
    noise = torch.from_numpy(np.random.default_rng(1).normal(
        size=(16, 128)).astype(np.float32)).to(cuda)
    grads, counts = [], []
    for library in (False, True):
        if library:
            monkeypatch.setattr(layers.UnifiedEncoder, "_input_grad_only",
                                lambda self, x: False)
        with restoration.frozen(t.model), trace.recording() as rec:
            grads.append(restoration.restoration_grads(
                t._restoration_fn(False), x, 0.5, noise).flatten().double())
        counts.append(rec.counters().get("stem_dgrad_kernel", 0))
    assert counts == [1, 0]
    cos = torch.dot(grads[0], grads[1]) / (grads[0].norm() * grads[1].norm())
    assert 1 - float(cos) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("call", ["detect", "train_step"])
def test_ae_launches_no_stem_kernel(cuda, call):
    """AE serving forwards under no grad and AE training trains the
    weights: neither takes the stem's input-gradient kernel."""
    t = get_trainer("AE")(Config(trainer="AE", model="autoencoder",
                                 outputWidth=32, outputHeight=32, zDim=16),
                          device="cuda")
    t.init_state()
    with trace.recording() as rec:
        if call == "detect":
            AnomalyDetector(t, t.config, Options(erosionIterations=1,
                                                 minLesionSize=2), 0.1
                            ).detect(make_phantom(np.random.default_rng(0),
                                                  48, 12, True)["volume"])
        else:
            t.train_step({"x": torch.rand(8, 32, 32, 1, device=cuda)})
    torch.cuda.synchronize()
    assert rec.counters().get("stem_dgrad_kernel", 0) == 0


@pytest.mark.gpu
def test_stem_dgrad_raises_on_a_failed_launch(cuda, monkeypatch):
    """A non-zero return of the C function raises and counts nothing."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
        stem_dgrad,
    )

    class Failing:
        @staticmethod
        def uad_stem_dgrad(*args):
            return 1

    monkeypatch.setattr(stem_dgrad, "load_library", lambda: Failing())
    g, w, ph, pw = _stem_case((2, 37, 45), torch.bfloat16, False, cuda)
    with trace.recording() as rec:
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            stem_dgrad.stem_input_grad_cuda(g, w, (37, 45), ph, pw)
    assert rec.counters() == {}
