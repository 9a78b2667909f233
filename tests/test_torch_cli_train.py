"""The port's training CLI end to end on the CPU at 32x32: train 2 epochs
on the synthetic cohort, evaluate, calibrate, and serve the workdir."""

import json
import os

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

SMALL = ["-w", "32", "-g", "32", "-z", "16", "-b", "8", "-s", "0", "-e",
         "16", "--precision", "float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small and the suite runs in several worker
    processes: one intra-op thread per worker keeps them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``--preset AE --synthetic --device cpu`` at 32x32 (the preset's 2
    epochs and dropout; width, batch and depth from the flags; ``--parity``
    and ``--fast-convt-grad`` accepted and without effect)."""
    root = tmp_path_factory.mktemp("cli")
    paths = root / "paths.json"
    paths.write_text(json.dumps({"SAMPLEDIR": str(root / "samples")}))
    wd, metrics = root / "wd", root / "metrics.jsonl"
    rc = cli.main(["--preset", "AE", "--synthetic", *SMALL, "--device",
                   "cpu", "--workdir", str(wd), "--metrics-out",
                   str(metrics), "-c", str(paths), "--log-every-n", "2",
                   "--parity", "--fast-convt-grad"])
    assert rc == 0
    return root, wd, metrics


def test_workdir_holds_checkpoints_and_calibration(trained):
    root, wd, _ = trained
    config = Config.from_json((wd / "config.json").read_text())
    assert (config.numEpochs, config.batchsize, config.outputWidth,
            config.dropout_rate, config.learningrate) == (2, 8, 32, 0.2, 1e-4)
    assert sorted(os.listdir(wd / "torch" / "ckpt")) == [
        "epoch_000001.pt", "epoch_000002.pt"]
    assert (wd / "torch" / "model.pt").is_file()
    history = json.loads((wd / "curves.json").read_text())
    assert [(h["epoch"], h["phase"]) for h in history] == [
        (0, "TRAIN"), (0, "VAL"), (1, "TRAIN"), (1, "VAL")]
    assert all(np.isfinite(h["loss"]) for h in history)
    calib = json.loads((wd / "calibration.json").read_text())
    assert calib["dataset"] == "Synth" and calib["epoch"] == 2
    assert calib["options"]["applyHyperIntensityPrior"] is False
    assert calib["options"]["erosionIterations"] == 3


def test_evaluations_and_metric_rows(trained):
    root, wd, metrics = trained
    rows = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    calib = json.loads((wd / "calibration.json").read_text())
    assert [r["description"] for r in rows] == [
        "Synth_upperbound", "Synth_upperbound_wPrior",
        f"Synth-VALthresh_{calib['threshold']:.5f}"]
    for r in rows:
        assert r["preset"] == "AE" and r["trainer"] == "AE"
        for k in ("AUROC", "AUPRC", "bestDice", "finalTrainLoss"):
            assert np.isfinite(r[k]), k
    eval_dirs = [d for d, _, files in os.walk(root / "samples")
                 if "evalPC.json" in files]
    assert len(eval_dirs) == 3
    for d in eval_dirs:
        assert {"evalPC.npy", "evalPC.txt", "rocPC.npy",
                "prcPC.npy"} <= set(os.listdir(d))
        ev = json.loads(open(os.path.join(d, "evalPC.json")).read())
        assert ev["ccConverged"] is True


def test_infer_serves_the_trained_workdir(trained, tmp_path):
    _, wd, _ = trained
    scan = tmp_path / "scan.nii.gz"
    write_nifti(str(scan), make_phantom(np.random.default_rng(1), 32, 16,
                                        True)["volume"])
    out = tmp_path / "out"
    assert cli.main(["infer", "--workdir", str(wd), "-i", str(scan), "-o",
                     str(out), "--device", "cpu"]) == 0
    report = json.loads((out / "scan.report.json").read_text())
    calib = json.loads((wd / "calibration.json").read_text())
    assert report["threshold"] == calib["threshold"]
    assert len(report["slice_scores"]) == 16


def test_resumed_run_trains_nothing_more(trained, capsys):
    """A second fit in the same workdir resumes at epoch 2 of 2 and holds
    the weights the CLI saved."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.synthetic import (
        SYNTH,
        SyntheticOptions,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    _, wd, _ = trained
    config = Config.from_json((wd / "config.json").read_text())
    t = get_trainer("AE")(config, workdir=str(wd), device="cpu")
    t.fit(SYNTH(SyntheticOptions(numPatients=3, imageSize=32, numSlices=16,
                                 targetSize=32)))
    out = capsys.readouterr().out
    assert "Restored checkpoint at epoch 2" in out
    assert "Epoch (train)" not in out
    saved = torch.load(wd / "torch" / "model.pt", weights_only=True)
    assert all(torch.equal(saved[k], v)
               for k, v in t.model.state_dict().items())


@pytest.fixture(scope="module", params=["VAE_You", "ceVAE"])
def trained_restoration(request, tmp_path_factory):
    """``--preset VAE_You`` (lambda sweep, batched restoration) and
    ``--preset ceVAE`` (gradient restoration 0.1) at 32x32, 1 epoch, 5
    restoration steps."""
    name = request.param
    root = tmp_path_factory.mktemp(name)
    paths = root / "paths.json"
    paths.write_text(json.dumps({"SAMPLEDIR": str(root / "samples")}))
    wd, metrics = root / "wd", root / "metrics.jsonl"
    rc = cli.main(["--preset", name, "--synthetic", *SMALL, "-E", "1", "-S",
                   "5", "--device", "cpu", "--workdir", str(wd),
                   "--metrics-out", str(metrics), "-c", str(paths)])
    assert rc == 0
    return name, root, wd, metrics


def test_restoration_presets_train_evaluate_and_calibrate(
        trained_restoration):
    name, root, wd, metrics = trained_restoration
    config = Config.from_json((wd / "config.json").read_text())
    assert (config.trainer, config.restore_steps) == (
        {"VAE_You": "VAE_You", "ceVAE": "ceVAE"}[name], 5)
    if name == "VAE_You":
        lam = json.loads((wd / "tv_lambda.json").read_text())[
            "tv_lambda_value"]
        assert 0.0 <= lam <= 1.9
    else:
        assert config.use_gradient_based_restoration == 0.1
        assert not (wd / "tv_lambda.json").exists()
    calib = json.loads((wd / "calibration.json").read_text())
    assert np.isfinite(calib["threshold"])
    rows = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    assert len(rows) == 3
    for r in rows:
        assert r["trainer"] == config.trainer
        for k in ("AUROC", "AUPRC", "bestDice", "finalTrainLoss"):
            assert np.isfinite(r[k]), k


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--synthetic", *SMALL, "--workdir", str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flag", [["--tpu-fast"], ["--s2d-stem"],
                                  ["--d2s-head"], ["--mesh-data", "2"],
                                  ["--tb-every-n", "5"]])
def test_unported_flags_raise(flag, tmp_path, monkeypatch):
    """Every flag of the JAX CLI is ported.  ``--mesh-data 2`` without a
    process group of 2 ranks raises that the group has 1, before anything
    is written; the others reach the config and options that the protocol
    gets, as the JAX CLI sets them."""
    if flag[0] == "--mesh-data":
        with pytest.raises(ValueError, match="process group has 1 rank"):
            cli.main(["--synthetic", *SMALL, "--device", "cpu", "--workdir",
                      str(tmp_path), *flag])
        assert not os.listdir(tmp_path)
        return
    seen = {}
    monkeypatch.setattr(cli, "_train_protocol",
                        lambda args, config, options, *a: seen.update(
                            config=config, options=options) or 0)
    assert cli.main(["--synthetic", *SMALL, "--device", "cpu", "--workdir",
                     str(tmp_path), *flag]) == 0
    config, options = seen["config"], seen["options"]
    assert config.spaceToDepthStem == (flag[0] in ("--tpu-fast",
                                                   "--s2d-stem"))
    assert config.depthToSpaceHead == (flag[0] in ("--tpu-fast",
                                                   "--d2s-head"))
    assert options.tensorboard == (flag[0] == "--tb-every-n")
    assert options.tbEveryNBatches == (5 if flag[0] == "--tb-every-n"
                                       else 0)
