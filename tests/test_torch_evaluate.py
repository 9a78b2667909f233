"""The port's ``evaluate()`` and threshold transfer against the JAX package
on the same weights and the lesioned synthetic cohort at 64x64, and against
the golden host recipe of `tests/test_golden_parity.py`."""

import os

import jax
import numpy as np
import pytest
import torch

from test_golden_parity import (
    CASES,
    GoldenDataset,
    GoldenTrainer,
    golden_host_eval,
    make_patients,
)
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    Config as JaxConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    Options as JaxOptions,
)
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    PathConfig as JaxPathConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu.data.synthetic import (
    SYNTH,
    SyntheticOptions,
)
from unsupervised_anomaly_detection_brain_mri_tpu.eval import (
    determine_threshold_on_labeled_patients as jax_threshold_transfer,
)
from unsupervised_anomaly_detection_brain_mri_tpu.eval import (
    evaluate as jax_evaluate,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    get_trainer as jax_get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
    Config,
    Options,
    PathConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval import (
    evaluate as E,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import (
    vae as port_vae,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.convert import (
    params_from_flax,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)

CURVE_TOL = 1e-5  # AUROC, AUPRC, best Dice, thresholds
COUNTS = ("TP", "FP", "TN", "FN", "TPCC", "FPCC", "FNCC")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small and the suite runs in several worker
    processes: one intra-op thread per worker keeps them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return Config(trainer="AE", model="autoencoder", batchsize=4,
                  outputWidth=64, outputHeight=64, zDim=16,
                  compute_dtype="float32")


def _jax(cfg):
    """The JAX package's Config with the same fields as the port's."""
    return JaxConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def pair():
    """A JAX AE at 64x64 with randomised BN statistics, the port's AE on
    the same converted weights, and the lesioned cohort."""
    cfg = _cfg()
    jt = jax_get_trainer("AE")(_jax(cfg))
    js = jt.init_state()
    rng = np.random.default_rng(0)

    def draw(path, a):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 2.0, np.shape(a)).astype(np.float32)
        return rng.normal(0.0, 0.3, np.shape(a)).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(
        draw, jax.device_get(js.batch_stats))
    js = js.replace(batch_stats=jax.tree_util.tree_map(jax.numpy.asarray,
                                                       stats))
    tt = get_trainer("AE")(cfg, device="cpu")
    tt.model.load_state_dict(params_from_flax(jax.device_get(js.params),
                                              stats, tt.model))
    ds = SYNTH(SyntheticOptions(
        numPatients=4, imageSize=64, numSlices=24, targetSize=64,
        withLesions=True, seed=99,
        partition={"TRAIN": 0.0, "VAL": 0.5, "TEST": 0.5}))
    return cfg, jt, js, tt, ds


def _options(tmp, **kw):
    return Options(paths=PathConfig(sample_dir=str(tmp)), erosionIterations=6,
                   **kw)


def _jax_options(tmp, **kw):
    return JaxOptions(paths=JaxPathConfig(sample_dir=str(tmp)),
                      erosionIterations=6, **kw)


def _files(root):
    out = set()
    for dirpath, _, names in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        out.update(os.path.join(rel, n) for n in names)
    return out


@pytest.mark.parametrize("kw", [
    dict(threshold=None, applyHyperIntensityPrior=True),
    dict(threshold=None, applyHyperIntensityPrior=False, exportPNGs=True,
         exportVolumes=True),
    dict(threshold=0.05, applyHyperIntensityPrior=False),
], ids=["bestdice_prior", "bestdice_artifacts", "numeric_threshold"])
def test_evaluate_matches_jax(pair, tmp_path, kw):
    cfg, jt, js, tt, ds = pair
    ref = jax_evaluate(ds, jt, js, _jax_options(tmp_path / "jax", **kw),
                       _jax(cfg), description="d")
    got = E.evaluate(ds, tt, _options(tmp_path / "torch", **kw), cfg,
                     description="d")
    assert set(got) == set(ref)
    for k in ("diff_AUC", "diff_AUPRC", "bestDiceScore", "bestThreshold",
              "DiceScore"):
        np.testing.assert_allclose(got[k], ref[k], rtol=CURVE_TOL,
                                   atol=1e-7, err_msg=k)
    if "precision70Threshold" in ref:
        np.testing.assert_allclose(got["precision70Threshold"],
                                   ref["precision70Threshold"],
                                   rtol=CURVE_TOL, atol=1e-7)
    for k in COUNTS:
        assert got[k] == ref[k], (k, got[k], ref[k])
    assert got["ccConverged"] == ref["ccConverged"]
    np.testing.assert_allclose(got["diffs"], ref["diffs"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["DiceScorePerPatient"],
                               ref["DiceScorePerPatient"], rtol=CURVE_TOL)
    np.testing.assert_allclose(got["l1reconstructionErrorMean"],
                               ref["l1reconstructionErrorMean"], rtol=1e-5)
    assert got["slices_per_patient"] == ref["slices_per_patient"]
    assert _files(got["eval_dir"]) == _files(ref["eval_dir"])


def test_threshold_transfer_matches_jax(pair, tmp_path):
    cfg, jt, js, tt, ds = pair
    opts = _options(tmp_path, applyHyperIntensityPrior=False)
    ref = jax_threshold_transfer(
        [ds], jt, js, _jax_options(tmp_path, applyHyperIntensityPrior=False),
        _jax(cfg))
    got = E.determine_threshold_on_labeled_patients([ds], tt, opts, cfg)
    np.testing.assert_allclose(got, ref, rtol=CURVE_TOL, atol=1e-7)


class _PortGoldenTrainer:
    """The golden harness's mock model behind the port's duck-typed
    trainer contract (``device``, ``reconstruct_device(x)`` and
    ``batched_volume_restoration()``)."""

    device = torch.device("cpu")

    def reconstruct_device(self, x, dropout=False, generator=None):
        rec = GoldenTrainer().reconstruct(None, x.numpy())["reconstruction"]
        return {"reconstruction": torch.as_tensor(np.asarray(rec, np.float32),
                                                  device=x.device)}

    def batched_volume_restoration(self):
        return False


def test_evaluate_matches_golden_host_recipe(tmp_path):
    patients = make_patients(n=3, native=80, n_slices=14, seed=0)
    cfg = Config(trainer="AE", model="autoencoder", batchsize=4,
                 outputWidth=64, outputHeight=64, compute_dtype="float32",
                 seed=0)
    opts = Options(paths=PathConfig(sample_dir=str(tmp_path)),
                   **CASES["bestdice_prior_median"])
    dev = E.evaluate(GoldenDataset(patients, slice_start=2, slice_end=12),
                     _PortGoldenTrainer(), opts, cfg)
    host = golden_host_eval(patients, opts, (64, 64), 0)
    np.testing.assert_array_equal(dev["labelmaps"] > 0.5, host["labels"])
    np.testing.assert_allclose(dev["diffs"], host["diffs"], atol=2e-6, rtol=0)
    np.testing.assert_allclose(dev["diff_AUC"], host["diff_AUC"], rtol=1e-6)
    np.testing.assert_allclose(dev["diff_AUPRC"], host["diff_AUPRC"],
                               rtol=1e-6)
    np.testing.assert_allclose(dev["bestDiceScore"], host["exactBestDice"],
                               rtol=1e-5)
    assert dev["bestDiceScore"] >= host["recursiveBestDice"] - 1e-6
    np.testing.assert_allclose(dev["bestThreshold"],
                               host["exactBestThreshold"], rtol=1e-5)
    np.testing.assert_allclose(dev["precision70Threshold"],
                               host["precision70Threshold"], rtol=1e-5)
    np.testing.assert_allclose(dev["DiceScore"], host["DiceScore"], rtol=1e-5)
    np.testing.assert_allclose(dev["DiceScorePerPatient"],
                               host["DiceScorePerPatient"], rtol=1e-5)
    for k in ("TP", "FP", "TN", "FN", "TPCC", "FPCC", "FNCC"):
        assert dev[k] == host[k], k
    np.testing.assert_allclose(dev["VD"], host["VD"], rtol=1e-6)


@pytest.mark.parametrize("slice_end,truncate_last", [(12, True), (0, False)])
def test_volume_selection_matches_jax(tmp_path, slice_end, truncate_last):
    """The shape-sanity skip (a volume shallower than the slice range) and
    a falsy ``sliceEnd`` meaning the full depth, against the JAX
    ``evaluate()`` on the golden harness's mock model."""
    patients = make_patients(n=3, native=80, n_slices=14, seed=1,
                             truncate_last=truncate_last)
    ds = GoldenDataset(patients, slice_start=2, slice_end=slice_end)
    cfg = Config(trainer="AE", model="autoencoder", batchsize=4,
                 outputWidth=64, outputHeight=64, compute_dtype="float32")
    opts = {name: options(paths=path(sample_dir=str(tmp_path / name)),
                          **CASES["fixed_threshold"])
            for name, options, path in (
                ("jax", JaxOptions, JaxPathConfig),
                ("torch", Options, PathConfig))}
    ref = jax_evaluate(ds, GoldenTrainer(), None, opts["jax"], _jax(cfg))
    got = E.evaluate(ds, _PortGoldenTrainer(), opts["torch"], cfg)
    assert got["slices_per_patient"] == ref["slices_per_patient"] == (
        [10, 10] if truncate_last else [12, 12, 12])
    np.testing.assert_allclose(got["diffs"], ref["diffs"], atol=2e-6, rtol=0)
    for k in COUNTS:
        assert got[k] == ref[k], k


def test_numeric_artifacts_without_plotting_packages(pair, tmp_path,
                                                     monkeypatch, capsys):
    """With matplotlib missing, every picture is one printed line and every
    numeric artifact is still written."""
    cfg, _, _, tt, ds = pair
    monkeypatch.setattr(E, "_artifacts", lambda: (None, "matplotlib"))
    res = E.evaluate(ds, tt, _options(tmp_path, exportPNGs=True), cfg)
    files = _files(res["eval_dir"])
    assert {"evalPC.npy", "evalPC.txt", "evalPC.json", "rocPC.npy",
            "prcPC.npy"} <= {os.path.basename(f) for f in files}
    assert not any(f.endswith((".png", ".pdf")) for f in files)
    notes = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[artifacts] matplotlib is not installed")]
    assert len(notes) == 5  # histogram, ROC, PRC, Dice curve, slice PNGs


def test_evaluate_launches_one_median_per_volume(pair, tmp_path,
                                                 monkeypatch):
    """Every evaluated volume goes through ``median_filter_3d_auto`` once
    (on the card that is one kernel launch per volume)."""
    cfg, _, _, tt, ds = pair
    calls = []
    real = E.median_filter_3d_auto

    def counting(vol, kernel=5):
        calls.append(tuple(vol.shape))
        return real(vol, kernel)

    monkeypatch.setattr(E, "median_filter_3d_auto", counting)
    E.evaluate(ds, tt, _options(tmp_path), cfg)
    E.determine_threshold_on_labeled_patients(ds, tt, _options(tmp_path),
                                              cfg)
    n = len(ds.patients_of("TEST")) + len(ds.patients_of("VAL"))
    assert calls == [(24, 64, 64)] * n


@pytest.fixture(scope="module")
def vae_pairs():
    """JAX VAEs at 64x64 with randomised BN statistics, dropout 0 and 0.5,
    and the port's VAEs on the same converted weights."""
    out = {}
    for rate in (0.0, 0.5):
        cfg = _cfg().replace(trainer="VAE", model="variational_autoencoder",
                             dropout_rate=rate)
        jt = jax_get_trainer("VAE")(_jax(cfg))
        js = jt.init_state()
        rng = np.random.default_rng(1)

        def draw(path, a):
            if jax.tree_util.keystr(path).endswith("['var']"):
                return rng.uniform(0.5, 2.0, np.shape(a)).astype(np.float32)
            return rng.normal(0.0, 0.3, np.shape(a)).astype(np.float32)

        stats = jax.tree_util.tree_map_with_path(
            draw, jax.device_get(js.batch_stats))
        js = js.replace(batch_stats=jax.tree_util.tree_map(
            jax.numpy.asarray, stats))
        tt = get_trainer("VAE")(cfg, device="cpu")
        tt.model.load_state_dict(params_from_flax(
            jax.device_get(js.params), stats, tt.model))
        out[rate] = (cfg, jt, js, tt)
    return out


def test_mc_dropout_evaluation_matches_jax(pair, vae_pairs, tmp_path,
                                           monkeypatch):
    """MC evaluation (3 samples) of a VAE at dropout 0, with the same noise
    given to both packages for each reconstruction call (a different draw
    per call, so the samples differ): every output, the epistemic and
    combined variances and their histogram agree."""
    cfg, jt, js, tt = vae_pairs[0.0]
    ds = pair[4]
    calls = {"jax": 0, "torch": 0}

    def noise(n, shape):
        return np.random.default_rng(n).normal(size=shape).astype(np.float32)

    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jax.numpy.asarray(
                            noise(calls["jax"], tuple(shape))))
    monkeypatch.setattr(port_vae, "standard_normal",
                        lambda sample, shape, device: torch.from_numpy(
                            noise(calls["torch"], tuple(shape))))
    real = {"jax": jt.reconstruct_device, "torch": tt.reconstruct_device}

    def jax_call(*args, **kwargs):
        calls["jax"] += 1
        jt._reconstruct_jit.clear()  # the patched noise is traced anew
        return real["jax"](*args, **kwargs)

    def torch_call(*args, **kwargs):
        calls["torch"] += 1
        return real["torch"](*args, **kwargs)

    monkeypatch.setattr(jt, "reconstruct_device", jax_call)
    monkeypatch.setattr(tt, "reconstruct_device", torch_call)
    kw = dict(threshold=None, applyHyperIntensityPrior=False,
              numMonteCarloSamples=3)
    ref = jax_evaluate(ds, jt, js, _jax_options(tmp_path / "jax", **kw),
                       _jax(cfg))
    got = E.evaluate(ds, tt, _options(tmp_path / "torch", **kw), cfg)
    n_test = len(ds.patients_of("TEST"))
    assert calls == {"jax": 3 * n_test, "torch": 3 * n_test}
    assert set(got) == set(ref)
    for k in ("diffs", "reconstructions", "epistemic_variance",
              "combined_variance"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    for k in ("diff_AUC", "diff_AUPRC", "bestDiceScore", "bestThreshold",
              "l1reconstructionErrorMean", "l2reconstructionErrorMean"):
        np.testing.assert_allclose(got[k], ref[k], rtol=CURVE_TOL, atol=1e-7,
                                   err_msg=k)
    for k in COUNTS:
        assert got[k] == ref[k], k
    hist_got, hist_ref = got["uncertaintyHistogram"], ref[
        "uncertaintyHistogram"]
    # float32 round-off moves a voxel or two across a bin or range edge
    assert abs(int(hist_got.sum()) - int(hist_ref.sum())) <= 2
    assert np.abs(hist_got - hist_ref).max() <= 2
    ev = got["epistemic_variance"]
    assert (ev > 1e-6).any()
    assert not ev[got["reconstructions"] == 0].any()  # outside the mask
    np.testing.assert_array_equal(got["combined_variance"], ev)
    assert _files(got["eval_dir"]) == _files(ref["eval_dir"])


def test_mc_dropout_evaluation_agrees_with_jax_in_distribution(
        pair, vae_pairs, tmp_path):
    """MC evaluation (8 samples) at dropout 0.5 with each package's own
    random streams: the mean reconstruction and the mean epistemic variance
    agree in distribution, and the variance is 0 outside the eroded
    mask."""
    cfg, jt, js, tt = vae_pairs[0.5]
    ds = pair[4]
    kw = dict(threshold=None, applyHyperIntensityPrior=False,
              numMonteCarloSamples=8)
    ref = jax_evaluate(ds, jt, js, _jax_options(tmp_path / "jax", **kw),
                       _jax(cfg))
    got = E.evaluate(ds, tt, _options(tmp_path / "torch", **kw), cfg)
    rec_got, rec_ref = got["reconstructions"], ref["reconstructions"]
    np.testing.assert_array_equal(rec_got == 0, rec_ref == 0)  # the mask
    inside = rec_ref != 0
    assert abs(rec_got[inside].mean() / rec_ref[inside].mean() - 1) < 0.05
    ratio = (got["epistemic_variance"][inside].mean()
             / ref["epistemic_variance"][inside].mean())
    assert 0.67 < ratio < 1.5, ratio
    assert not got["epistemic_variance"][~inside].any()


def test_mc_evaluation_launches_one_median_per_volume(pair, vae_pairs,
                                                      tmp_path, monkeypatch):
    """MC samples do not multiply the median: one call per volume."""
    cfg, _, _, tt = vae_pairs[0.5]
    ds = pair[4]
    calls = []
    real = E.median_filter_3d_auto
    monkeypatch.setattr(E, "median_filter_3d_auto",
                        lambda vol, kernel=5: calls.append(1) or real(
                            vol, kernel))
    E.evaluate(ds, tt, _options(tmp_path, numMonteCarloSamples=4), cfg)
    assert len(calls) == len(ds.patients_of("TEST"))
