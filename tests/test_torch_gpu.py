"""Tests of the port that need the card (marked ``gpu``; each skips where
``torch.cuda.is_available()`` is false).  This file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

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
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval import (
        evaluate as E,
    )

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
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval import (
        evaluate as E,
    )

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
