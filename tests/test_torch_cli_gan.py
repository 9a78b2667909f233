"""The port's training CLI on the CPU for the last four presets ported:
``constrainedAAE_Chen``, ``fAnoGAN``, ``fAnoGAN_schlegl`` and ``AnoVAEGAN``
at 64x64 for one epoch (fAnoGAN: one WGAN and one encoder epoch) on a short
slice range, with MC dropout (``-n 4``): train, evaluate three times,
calibrate, and serve one scan with the calibrated threshold, with one
median per evaluated or served volume.  The ResNets run at ``dim`` 8 and
the schedules at 1 critic (and for Chen 1 AE) update per batch; the
schedules have their own tests (``tests/test_torch_resnet.py``,
``tests/test_torch_fanogan.py``)."""

import importlib
import json

import numpy as np
import pytest
import torch

from test_torch_resnet import small_resnets
from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
    Config,
    preset,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.formats import (
    write_nifti,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.synthetic import (
    make_phantom,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import gan

E = importlib.import_module(
    "unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes in several worker processes: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = ["-w", "64", "-g", "64", "-b", "8", "-s", "0", "-e", "16", "-E", "1",
         "-n", "4", "--precision", "float32", "--device", "cpu"]
CLI_PRESETS = ["constrainedAAE_Chen", "fAnoGAN", "fAnoGAN_schlegl",
               "AnoVAEGAN"]


@pytest.fixture(scope="module", params=CLI_PRESETS)
def trained(request, tmp_path_factory):
    """The CLI run of the preset with MC dropout (``-n 4``), counting the
    median's calls; 1 critic (and for Chen 1 AE) update per batch, the
    ResNets at ``dim`` 8 (the schedules have their own tests)."""
    name = request.param
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp(name)
    paths = root / "paths.json"
    paths.write_text(json.dumps({"SAMPLEDIR": str(root / "samples")}))
    wd, metrics = root / "wd", root / "metrics.jsonl"
    calls = []
    real = E.median_filter_3d_auto
    mp.setattr(E, "median_filter_3d_auto", lambda vol, kernel=5: calls.append(
        tuple(vol.shape)) or real(vol, kernel))
    for cls in (gan.AAE, gan.FAnoGAN, gan.AnoVAEGAN):
        mp.setattr(cls, "d_iters", 1)
    small_resnets(mp)
    try:
        rc = cli.main(["--preset", name, "--synthetic", *SMALL, "--workdir",
                       str(wd), "--metrics-out", str(metrics), "-c",
                       str(paths)])
    finally:
        mp.undo()
    assert rc == 0
    return name, root, wd, metrics, calls


def test_preset_trains_evaluates_and_calibrates(trained):
    name, root, wd, metrics, calls = trained
    assert calls, "the CLI run evaluated nothing"
    config = Config.from_json((wd / "config.json").read_text())
    assert config.model == preset(name).model
    history = json.loads((wd / "curves.json").read_text())
    phases = [h["phase"] for h in history]
    if name.startswith("fAnoGAN"):
        assert phases == ["TRAIN_WGAN", "TRAIN_Encoder", "VAL"]
        groups = ["disc", "enc", "gen"]
    else:
        assert phases == ["TRAIN", "VAL"]
        groups = (["ae", "disc", "gen"] if name == "constrainedAAE_Chen"
                  else ["disc", "gen", "vae"])
    assert all(np.isfinite(v) for h in history for k, v in h.items()
               if k not in ("phase", "epoch"))
    n_epochs = len({h["epoch"] for h in history})
    ckpt = torch.load(wd / "torch" / "ckpt" / f"epoch_{n_epochs:06d}.pt",
                      weights_only=True)
    assert sorted(ckpt["optimizer"]) == groups
    rows = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    assert len(rows) == 3
    for r in rows:
        for k in ("AUROC", "AUPRC", "bestDice"):
            assert np.isfinite(r[k]), k
        # the last TRAIN entry's ``loss``: fAnoGAN's encoder phase reports
        # ``enc_loss`` instead, and the JAX package's CLI writes null too
        if name.startswith("fAnoGAN"):
            assert r["finalTrainLoss"] is None
        else:
            assert np.isfinite(r["finalTrainLoss"])
    calib = json.loads((wd / "calibration.json").read_text())
    assert np.isfinite(calib["threshold"])
    # 3 evaluations of the 3 TEST volumes, one threshold fit over the 3 VAL
    assert calls == [(16, 64, 64)] * (3 * 3 + 3)


def test_infer_serves_the_trained_workdir(trained, tmp_path, monkeypatch):
    name, _, wd, _, _ = trained
    small_resnets(monkeypatch)
    scan = tmp_path / "scan.nii.gz"
    write_nifti(str(scan), make_phantom(np.random.default_rng(1), 64, 16,
                                        True)["volume"])
    calls = []
    real = E.median_filter_3d_auto
    E.median_filter_3d_auto = lambda vol, kernel=5: calls.append(1) or real(
        vol, kernel)
    try:
        assert cli.main(["infer", "--workdir", str(wd), "-i", str(scan),
                         "-o", str(tmp_path / "out"), "-n", "4",
                         "--device", "cpu"]) == 0
    finally:
        E.median_filter_3d_auto = real
    report = json.loads((tmp_path / "out" / "scan.report.json").read_text())
    calib = json.loads((wd / "calibration.json").read_text())
    assert report["threshold"] == calib["threshold"]
    assert len(report["slice_scores"]) == 16
    assert calls == [1]  # four MC samples, one median
