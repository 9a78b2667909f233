"""The port's serving path as a whole against the JAX package: ``detect`` on
the same weights and volume, the ``infer`` CLI on the same workdir, the
JAX-workdir converter, and the port's independence from JAX."""

import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from unsupervised_anomaly_detection_brain_mri_tpu import cli as jax_cli
from unsupervised_anomaly_detection_brain_mri_tpu.config import Config, Options
from unsupervised_anomaly_detection_brain_mri_tpu.data.formats import (
    write_nifti,
)
from unsupervised_anomaly_detection_brain_mri_tpu.data.synthetic import (
    SYNTH,
    SyntheticOptions,
    make_phantom,
)
from unsupervised_anomaly_detection_brain_mri_tpu.data.volume import (
    open_volume,
)
from unsupervised_anomaly_detection_brain_mri_tpu.eval import (
    inference as jax_inference,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    get_trainer as jax_get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
    Config as PortConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
    Options as PortOptions,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval import (
    inference,
    prep,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.convert import (
    params_from_flax,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.registry import (
    get_model,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.base import (
    CHECKPOINT,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
OPTIONS = Options(erosionIterations=1, minLesionSize=2)
PORT_OPTIONS = PortOptions(erosionIterations=1, minLesionSize=2)


def _config():
    return Config(trainer="AE", model="autoencoder", batchsize=8,
                  outputWidth=32, outputHeight=32, zDim=16,
                  compute_dtype="float32")


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_workdir_to_torch",
        os.path.join(ROOT, "tools", "jax_workdir_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_masks_agree(got, ref, amap, t):
    """Masks equal except at voxels whose residual is within ATOL of the
    threshold (and, through them, the components they join)."""
    near = np.abs(amap - t) <= ATOL
    differ = got != ref
    assert not (differ & ~near).any()
    assert abs(int(got.sum()) - int(ref.sum())) <= int(near.sum())


@pytest.fixture(scope="module")
def converted():
    """JAX AE at 32x32 with randomised BN statistics, and a port workdir
    holding the same weights."""
    cfg = _config()
    trainer = jax_get_trainer("AE")(cfg, OPTIONS)
    state = trainer.init_state()
    rng = np.random.default_rng(0)

    def draw(path, a):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 2.0, np.shape(a)).astype(np.float32)
        return rng.normal(0.0, 0.3, np.shape(a)).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(
        draw, jax.device_get(state.batch_stats))
    state = state.replace(batch_stats=jax.tree_util.tree_map(
        jax.numpy.asarray, stats))
    wd = tempfile.mkdtemp()
    os.makedirs(os.path.join(wd, "torch"))
    model, _ = get_model(PortConfig.from_json(cfg.to_json()))
    torch.save(params_from_flax(jax.device_get(state.params), stats, model),
               os.path.join(wd, CHECKPOINT))
    with open(os.path.join(wd, "config.json"), "w") as f:
        f.write(cfg.to_json())
    return trainer, state, cfg, wd


@pytest.mark.parametrize("size,with_brainmask", [(32, True), (32, False),
                                                 (40, True)])
def test_detect_matches_jax(converted, size, with_brainmask):
    trainer, state, cfg, wd = converted
    ph = make_phantom(np.random.default_rng(size), size, 12, True)
    bm = ph["brainmask"] if with_brainmask else None
    jax_det = jax_inference.AnomalyDetector(trainer, state, cfg, OPTIONS)
    positive = jax_det.detect(ph["volume"], brainmask=bm)["anomaly_map"]
    t = float(np.quantile(positive[positive > 0], 0.5))
    ref = jax_det.detect(ph["volume"], brainmask=bm, threshold=t)

    det = inference.AnomalyDetector.from_workdir(wd, threshold=t,
                                                 options=PORT_OPTIONS,
                                                 device="cpu")
    got = det.detect(ph["volume"], brainmask=bm)
    assert got["anomaly_map"].shape == (12, 32, 32)
    np.testing.assert_allclose(got["reconstruction"], ref["reconstruction"],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["anomaly_map"], ref["anomaly_map"],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=ATOL,
                               rtol=0)
    assert got["cc_converged"] is True and ref["cc_converged"] is True
    assert got["mask"].any()
    _assert_masks_agree(got["mask"], ref["mask"], ref["anomaly_map"], t)
    near = int((np.abs(ref["anomaly_map"] - t) <= ATOL).sum())
    assert abs(got["anomalous_voxels"] - ref["anomalous_voxels"]) <= near


@pytest.mark.parametrize("size,with_brainmask", [(32, True), (32, False),
                                                 (40, True), (40, False)])
def test_detect_with_device_prep_matches_jax(converted, monkeypatch, size,
                                             with_brainmask):
    """``test_detect_matches_jax`` with the port's prep forced through
    ``prep.prepare_device`` on the CPU, the prep ``detect`` runs on a CUDA
    device: at size 40 every slice and the brain mask are zoomed to 32x32
    by the operators, at 32 only transposed."""
    def on_device(self, volume, target, brainmask):
        return prep.prepare_device(volume, target,
                                   self.options.upperpercentile, self.device,
                                   brainmask)

    monkeypatch.setattr(inference.AnomalyDetector, "_prepare_host",
                        on_device)
    with trace.recording() as rec:
        test_detect_matches_jax(converted, size, with_brainmask)
    assert rec.counters()["serve.prep_device"] == 1


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_mc_dropout_serving_matches_jax(converted, tmp_path, rate):
    """``detect`` under an operating point of 8 MC samples.  At dropout 0
    the AE's samples are equal in both packages and every output agrees
    (variances 0); at dropout 0.5 each package draws its own masks and the
    mean epistemic variance agrees in distribution, 0 outside the eroded
    mask."""
    trainer, state, cfg, wd = converted
    cfg = cfg.replace(dropout_rate=rate)
    opts = OPTIONS.replace(numMonteCarloSamples=8)
    jax_det = jax_inference.AnomalyDetector(
        jax_get_trainer("AE")(cfg, opts), state, cfg, opts)
    os.makedirs(tmp_path / "torch")
    torch.save(torch.load(os.path.join(wd, CHECKPOINT), weights_only=True),
               tmp_path / CHECKPOINT)
    (tmp_path / "config.json").write_text(cfg.to_json())
    det = inference.AnomalyDetector.from_workdir(
        str(tmp_path), options=PORT_OPTIONS.replace(numMonteCarloSamples=8),
        device="cpu")
    vol = make_phantom(np.random.default_rng(1), 32, 12, True)["volume"]
    ref, got = jax_det.detect(vol), det.detect(vol)
    assert set(got) == set(ref)
    inside = ref["reconstruction"] != 0
    np.testing.assert_array_equal(got["reconstruction"] != 0, inside)
    ev = got["epistemic_variance"]
    assert not ev[~inside].any()
    np.testing.assert_array_equal(got["combined_variance"], ev)
    if rate == 0.0:
        for k in ("anomaly_map", "reconstruction", "scores",
                  "epistemic_variance"):
            np.testing.assert_allclose(got[k], ref[k], atol=ATOL, rtol=0,
                                       err_msg=k)
        assert np.abs(ev).max() < 1e-6  # equal samples, float32 round-off
    else:
        ratio = ev[inside].mean() / ref["epistemic_variance"][inside].mean()
        assert ev[inside].mean() > 0 and 0.67 < ratio < 1.5, ratio


def test_calibration_file_is_shared_with_jax(converted, tmp_path):
    wd = converted[3]
    opts = PortOptions(erosionIterations=2, minLesionSize=3,
                       applyHyperIntensityPrior=False)
    inference.save_calibration(str(tmp_path), 0.42, 0.5, opts, "SYNTH", 1)
    assert (jax_inference.load_calibration(str(tmp_path))
            == inference.load_calibration(str(tmp_path)))
    inference.save_calibration(wd, 0.42, 0.5, opts, "SYNTH", 1)
    try:
        det = inference.AnomalyDetector.from_workdir(wd, device="cpu")
        assert det.threshold == 0.42
        assert det.options.erosionIterations == 2
        assert det.options.applyHyperIntensityPrior is False
        det2 = inference.AnomalyDetector.from_workdir(
            wd, threshold=0.9, options=PortOptions(erosionIterations=5),
            device="cpu")
        assert det2.threshold == 0.9 and det2.options.erosionIterations == 5
    finally:
        os.remove(os.path.join(wd, inference.CALIBRATION_FILE))


@pytest.fixture(scope="module")
def jax_workdir():
    """A 1-epoch JAX AE run, converted for the port by the tool."""
    wd = tempfile.mkdtemp()
    trainer = jax_get_trainer("AE")(_config(), workdir=wd)
    trainer.fit(SYNTH(SyntheticOptions(numPatients=3, imageSize=32,
                                       numSlices=8, targetSize=32)))
    path = _load_tool().convert(wd)
    assert path == os.path.join(wd, CHECKPOINT) and os.path.isfile(path)
    return wd


@pytest.mark.parametrize("trainer,model", [
    ("AE", "autoencoder_spatial"),
    ("VAE_You", "variational_autoencoder"),
    ("ceVAE", "context_encoder_variational_autoencoder"),
])
def test_tool_converts_vae_family_workdirs(trainer, model, tmp_path):
    """A JAX checkpoint of each unified-backbone model of the family
    becomes the port's checkpoint, and the swept ``tv_lambda.json`` is read
    by both packages as it stands."""
    cfg = _config().replace(trainer=trainer, model=model)
    jt = jax_get_trainer(trainer)(cfg, workdir=str(tmp_path))
    js = jt.init_state()
    jt.save_checkpoint(js, 1)
    (tmp_path / "tv_lambda.json").write_text('{"tv_lambda_value": 0.3}')
    _load_tool().convert(str(tmp_path))
    port = get_trainer(trainer)(PortConfig.from_json(cfg.to_json()),
                                workdir=str(tmp_path), device="cpu")
    assert port.load_checkpoint() is not None
    assert port.tv_lambda_value == 0.3
    want = params_from_flax(jax.device_get(js.params),
                            jax.device_get(js.batch_stats), port.model)
    got = port.model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_infer_cli_matches_jax_cli(jax_workdir, tmp_path):
    wd = jax_workdir
    jax_inference.save_calibration(
        wd, 0.2, 0.5, OPTIONS.replace(applyHyperIntensityPrior=False),
        dataset="SYNTH", epoch=1)
    vol = make_phantom(np.random.default_rng(3), 32, 10, True)["volume"]
    affine = np.array([[0.0, 1.1, 0.0, -10.0], [1.2, 0.0, 0.0, 20.0],
                       [0.0, 0.0, 1.3, 5.0], [0.0, 0.0, 0.0, 1.0]])
    scan = tmp_path / "patient.nii.gz"
    write_nifti(str(scan), vol, affine=affine)
    outs = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("torch", cli.main, ["--device", "cpu"])):
        outs[name] = tmp_path / name
        assert main(["infer", "--workdir", wd, "-i", str(scan), "-o",
                     str(outs[name])] + extra) == 0
    reports = {k: json.loads((d / "patient.report.json").read_text())
               for k, d in outs.items()}
    assert set(reports["torch"]) == set(reports["jax"])
    assert set(reports["torch"]["files"]) == set(reports["jax"]["files"])
    for key in ("threshold", "calibration", "model_resolution", "num_slices",
                "cc_converged", "workdir", "input"):
        assert reports["torch"][key] == reports["jax"][key]
    np.testing.assert_allclose(reports["torch"]["slice_scores"],
                               reports["jax"]["slice_scores"], atol=ATOL)
    maps = {k: open_volume(str(d / "patient.anomaly.nii.gz"))
            for k, d in outs.items()}
    assert maps["torch"].data.shape == maps["jax"].data.shape == vol.shape
    np.testing.assert_allclose(maps["torch"].data, maps["jax"].data,
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.asarray(maps["torch"].meta["affine"])[:3],
                               affine[:3], atol=1e-4)
    masks = {k: open_volume(str(d / "patient.anomaly.binary.nii.gz")).data
             for k, d in outs.items()}
    _assert_masks_agree(masks["torch"], masks["jax"], maps["jax"].data, 0.2)


def test_cli_training_subcommands_are_not_yet_ported(capsys):
    """Every subcommand of the JAX CLI is ported: ``validate-data`` with
    no arguments checks every dataset root of the default paths and
    reports and exits as the JAX CLI does
    (``tests/test_torch_validate_data.py`` holds it on real trees)."""
    rc = cli.main(["validate-data"])
    ours = capsys.readouterr().out
    assert rc == jax_cli.main(["validate-data"])
    assert ours == capsys.readouterr().out
    assert "BRAINWEB" in ours and "MSSEG2008" in ours


def test_cli_cuda_without_a_card_raises(converted, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scan = tmp_path / "s.nii.gz"
    write_nifti(str(scan), np.ones((32, 32, 4), np.float32))
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["infer", "--workdir", converted[3], "-i", str(scan)])


_NO_JAX_SCRIPT = """
import json, os, sys, tempfile
import numpy as np
import torch
import unsupervised_anomaly_detection_brain_mri_tpu_torch as uad
from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import make_phantom
from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.inference import (
    AnomalyDetector)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import convert
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import trace
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import metrics
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
    engine, losses, state)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval import evaluate
wd = tempfile.mkdtemp()
with open(wd + "/paths.json", "w") as f:
    json.dump({"SAMPLEDIR": wd + "/samples"}, f)
rc = cli.main(["--synthetic", "-w", "32", "-g", "32", "-z", "16", "-b", "8",
               "-E", "1", "-s", "0", "-e", "16", "--precision", "float32",
               "-O", "0.5", "--device", "cpu", "--workdir", wd + "/trained",
               "-c", wd + "/paths.json"])
assert rc == 0
wd = tempfile.mkdtemp()
cfg = uad.Config(outputWidth=32, outputHeight=32, zDim=16,
                 compute_dtype="float32")
t = get_trainer("AE")(cfg, workdir=wd, device="cpu")
t.init_state()
t.save_checkpoint()
det = AnomalyDetector.from_workdir(wd, threshold=0.1, device="cpu")
with trace.recording() as rec:
    res = det.detect(make_phantom(np.random.default_rng(0), 32, 8, True)[
        "volume"])
assert res["anomaly_map"].shape == (8, 32, 32)
assert "median_kernel" not in rec.counters()
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "orbax", "unsupervised_anomaly_"
                                       "detection_brain_mri_tpu"))
print("BANNED", banned)
sys.exit(1 if banned else 0)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BANNED []" in proc.stdout
