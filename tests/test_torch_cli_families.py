"""The port's training CLI on the CPU for the GMVAE and latent-critic
families: ``--preset GMVAE_You`` and ``--preset AAE`` at 64x64 for one
epoch on a short slice range train, evaluate three times, calibrate and
serve, with one median per evaluated or served volume."""

import json

import numpy as np
import pytest
import torch

from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import Config
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.formats import (
    write_nifti,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.synthetic import (
    make_phantom,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval import (
    evaluate as E,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import gan

SMALL = ["-w", "64", "-g", "64", "-b", "8", "-s", "0", "-e", "16", "-E", "1",
         "--precision", "float32", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small and the suite runs in several worker
    processes: one intra-op thread per worker keeps them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["GMVAE_You", "AAE"])
def trained(request, tmp_path_factory):
    """The CLI run of the preset, counting the median's calls.  The AAE
    runs 2 AE and 2 critic updates per batch instead of 20 and 20 (the
    class attribute ``d_iters``; the schedule has its own tests in
    ``tests/test_torch_aae.py``)."""
    name = request.param
    root = tmp_path_factory.mktemp(name)
    paths = root / "paths.json"
    paths.write_text(json.dumps({"SAMPLEDIR": str(root / "samples")}))
    wd, metrics = root / "wd", root / "metrics.jsonl"
    calls = []
    real, d_iters = E.median_filter_3d_auto, gan.AAE.d_iters
    E.median_filter_3d_auto = lambda vol, kernel=5: calls.append(
        tuple(vol.shape)) or real(vol, kernel)
    gan.AAE.d_iters = 2
    try:
        rc = cli.main(["--preset", name, "--synthetic", *SMALL, "--workdir",
                       str(wd), "--metrics-out", str(metrics), "-c",
                       str(paths)])
    finally:
        E.median_filter_3d_auto, gan.AAE.d_iters = real, d_iters
    assert rc == 0
    return name, root, wd, metrics, calls


def test_preset_trains_evaluates_and_calibrates(trained):
    name, root, wd, metrics, calls = trained
    config = Config.from_json((wd / "config.json").read_text())
    assert (config.trainer, config.model) == {
        "GMVAE_You": ("GMVAE_spatial",
                      "gaussian_mixture_variational_autoencoder_You"),
        "AAE": ("AAE", "adversarial_autoencoder")}[name]
    history = json.loads((wd / "curves.json").read_text())
    train = [h for h in history if h["phase"] == "TRAIN"]
    assert len(train) == 1 and all(np.isfinite(v) for k, v in train[0].items()
                                   if k != "phase")
    if name == "AAE":
        assert {"disc_loss", "gen_loss", "reconstructionLoss"} <= set(
            train[0])
        ckpt = torch.load(wd / "torch" / "ckpt" / "epoch_000001.pt",
                          weights_only=True)
        assert sorted(ckpt["optimizer"]) == ["ae", "disc", "gen"]
    # GMVAE_You restores 0 steps: no lambda sweep
    assert not (wd / "tv_lambda.json").exists()
    rows = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    assert len(rows) == 3
    for r in rows:
        for k in ("AUROC", "AUPRC", "bestDice", "finalTrainLoss"):
            assert np.isfinite(r[k]), k
    calib = json.loads((wd / "calibration.json").read_text())
    assert np.isfinite(calib["threshold"])
    # 3 evaluations of the 3 TEST volumes, one threshold fit over the 3 VAL
    assert calls == [(16, 64, 64)] * (3 * 3 + 3)


def test_infer_serves_the_trained_workdir(trained, tmp_path):
    name, _, wd, _, _ = trained
    scan = tmp_path / "scan.nii.gz"
    write_nifti(str(scan), make_phantom(np.random.default_rng(1), 64, 16,
                                        True)["volume"])
    calls = []
    real = E.median_filter_3d_auto
    E.median_filter_3d_auto = lambda vol, kernel=5: calls.append(1) or real(
        vol, kernel)
    try:
        assert cli.main(["infer", "--workdir", str(wd), "-i", str(scan),
                         "-o", str(tmp_path / "out"), "-n", "2",
                         "--device", "cpu"]) == 0
    finally:
        E.median_filter_3d_auto = real
    report = json.loads((tmp_path / "out" / "scan.report.json").read_text())
    calib = json.loads((wd / "calibration.json").read_text())
    assert report["threshold"] == calib["threshold"]
    assert len(report["slice_scores"]) == 16
    assert calls == [1]  # two MC samples, one median
