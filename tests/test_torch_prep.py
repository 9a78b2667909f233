"""Serving's device prep (``eval/prep.py``) on CPU tensors against the host
prep of both packages, the port's (the path ``detect`` takes off CUDA) and
the JAX package's (``data/preprocess.py::normalize_volume``,
``eval/evaluate.py::_zoom_volume``, its detect's ``np.quantile`` and mask):
the normalisation and both quantiles bit-equal to ``normalize_volume``,
``np.percentile`` and ``np.quantile``, the zoom within a float32 rounding of
``_zoom_volume``, the masks equal; a CPU ``detect`` still prepares on the
host; the zoom operators are built once per shape and mode."""

import numpy as np
import pytest
import torch

import _torch_realdata as R
from unsupervised_anomaly_detection_brain_mri_tpu.data.preprocess import (
    normalize_volume as jax_normalize_volume,
)
from unsupervised_anomaly_detection_brain_mri_tpu.eval.evaluate import (
    _zoom_volume as jax_zoom_volume,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch import Config, Options
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import (
    make_phantom,
    normalize_volume,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval import (
    inference,
    prep,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate import (
    _zoom_volume,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import trace

CPU = torch.device("cpu")
SERVE_TARGET = (128, 128)
ZOOM_ATOL = 1e-6
# the host prep each device function is held against: (normalize_volume,
# _zoom_volume) of the port and of the JAX package
HOST = {"port": (normalize_volume, _zoom_volume),
        "jax": (jax_normalize_volume, jax_zoom_volume)}
REFS = sorted(HOST)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _volume(kind):
    """The raw volumes: a lesioned phantom at the serving geometry; noise
    at an odd small shape; all zero; constant; a phantom with NaN and
    +-inf voxels."""
    rng = np.random.default_rng(7)
    if kind == "phantom":
        lab = R.head_labels(R.BRAINWEB_SHAPE, 2)
        return R.intensity(lab, R._FLAIR, rng, noise_pct=3.0, inu_pct=20.0)
    if kind == "odd":
        return (rng.gamma(2.0, 300.0, (7, 37, 45))
                * (rng.uniform(size=(7, 37, 45)) > 0.3)).astype(np.float32)
    if kind == "zero":
        return np.zeros((9, 21, 13), np.float32)
    if kind == "constant":
        return np.full((9, 21, 13), 412.5, np.float32)
    if kind == "nonfinite":
        v = R.intensity(R.head_labels((40, 48, 24), 1), R._FLAIR, rng,
                        noise_pct=5.0)
        flat = v.reshape(-1)
        idx = rng.permutation(flat.size)
        flat[idx[:11]] = np.nan
        flat[idx[11:14]] = np.inf
        flat[idx[14:20]] = -np.inf
        return v
    raise ValueError(kind)


KINDS = ["phantom", "odd", "zero", "constant", "nonfinite"]


def _fraction(p):
    """The fraction ``np.percentile`` takes a float32 array's percentile
    ``p`` at."""
    return np.true_divide(p, np.float32(100))


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("upper", [99.8, None])
@pytest.mark.parametrize("kind", KINDS)
def test_normalisation_and_quantiles_are_bit_equal(kind, upper, ref):
    raw = _volume(kind)
    v = np.nan_to_num(raw.astype(np.float32))
    t = torch.nan_to_num(torch.from_numpy(raw))
    vol, prior = prep.normalize_device(t, upper)
    host = HOST[ref][0](raw, upper_percentile=upper)
    assert vol.dtype == torch.float32
    np.testing.assert_array_equal(vol.numpy(), host)
    assert prior.item() == float(np.quantile(host, 0.9))
    ordered = torch.sort(t.reshape(-1)).values
    assert prep.percentile_device(ordered, _fraction(99.8)).item() == float(
        np.percentile(v, 99.8))
    assert prep.percentile_device(ordered, 0.9).item() == float(
        np.quantile(v, 0.9))


@pytest.mark.parametrize("q", [0.0, 1.0, 37.5, 50.0, 99.8, 100.0])
def test_percentiles_match_numpy_at_every_weight(q):
    """Weights below and above one half, and the ends of the range."""
    v = _volume("odd")
    ordered = torch.sort(torch.from_numpy(v).reshape(-1)).values
    assert prep.percentile_device(ordered, _fraction(q)).item() == float(
        np.percentile(v, q))
    assert prep.percentile_device(ordered, q / 100).item() == float(
        np.quantile(v, q / 100))


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("mode", ["constant", "nearest"])
@pytest.mark.parametrize("shape,target", [
    (R.BRAINWEB_SHAPE, SERVE_TARGET), ((7, 37, 45), (16, 24)),
    ((32, 32, 5), (32, 32))], ids=["serve", "odd", "identity"])
def test_zoom_matches_the_host_zoom(shape, target, mode, ref):
    rng = np.random.default_rng(3)
    if mode == "nearest":
        vol = (rng.uniform(size=shape) > 0.5).astype(np.float32)
    else:
        vol = rng.uniform(size=shape).astype(np.float32)
    got = prep.zoom_volume_device(torch.from_numpy(vol), target, mode)
    want = HOST[ref][1](vol, target, seg=mode == "nearest")
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (shape[2],) + target
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ZOOM_ATOL)


def _host_prep(ref, raw, target, brainmask=None):
    """The prep of the JAX package's ``detect`` (and of the port's
    ``_prepare_host``), with ``ref``'s functions."""
    normalize, zoom = HOST[ref]
    vol = normalize(raw)
    x = zoom(vol, target)
    if brainmask is None:
        skm = (x > 0.05).astype(np.float32)
    else:
        skm = (zoom(brainmask.astype(np.float32), target, seg=True)
               > 0.5).astype(np.float32)
    return x, skm, float(np.quantile(vol, 0.9))


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("with_brainmask", [False, True],
                         ids=["threshold", "brainmask"])
def test_prepare_equals_the_host_prep_at_the_serving_geometry(
        with_brainmask, ref):
    raw = _volume("phantom")
    brainmask = None
    if with_brainmask:
        brainmask = (R.head_labels(R.BRAINWEB_SHAPE) >= 1).astype(np.uint8)
    with trace.recording() as rec:
        x, skm, prior_q = prep.prepare_device(raw, SERVE_TARGET, 99.8, CPU,
                                              brainmask)
    hx, hskm, hprior = _host_prep(ref, raw, SERVE_TARGET, brainmask)
    np.testing.assert_allclose(x.numpy(), hx, rtol=0, atol=ZOOM_ATOL)
    np.testing.assert_array_equal(skm.numpy(), hskm)
    assert prior_q == hprior
    counts = rec.counters()
    assert counts["serve.prep_device"] == 1
    assert {s["name"] for s in rec.spans()} == {
        "serve.upload", "serve.normalize", "serve.zoom", "serve.mask"}


def _detector(erosions=1):
    cfg = Config(trainer="AE", model="autoencoder", outputWidth=32,
                 outputHeight=32, zDim=16, compute_dtype="float32")
    t = get_trainer("AE")(cfg, device="cpu")
    t.init_state()
    return inference.AnomalyDetector(
        t, cfg, Options(erosionIterations=erosions, minLesionSize=2), 0.1)


def test_cpu_detect_keeps_the_host_path(monkeypatch):
    """On the CPU ``detect`` normalises and zooms with the host functions,
    hands the reconstruction their exact result, and counts no device
    prep."""
    det = _detector()
    vol = make_phantom(np.random.default_rng(0), 48, 12, True)["volume"]
    seen = {}
    recon = inference._reconstruct_volume

    def keep(trainer, x, *a, **k):
        seen["x"] = x[..., 0].clone()
        return recon(trainer, x, *a, **k)

    def refuse(*a, **k):
        raise AssertionError("the CPU path prepared on the device")

    monkeypatch.setattr(inference, "_reconstruct_volume", keep)
    monkeypatch.setattr(prep, "prepare_device", refuse)
    with trace.recording() as rec:
        out = det.detect(vol)
    want = _zoom_volume(normalize_volume(vol), (32, 32))
    np.testing.assert_array_equal(seen["x"].numpy(), want)
    assert rec.counters().get("serve.prep_device", 0) == 0
    assert rec.counters()["serve.requests"] == 1
    assert out["anomaly_map"].shape == want.shape


def test_the_operator_cache_builds_once_per_shape_and_mode():
    prep.zoom_operator.cache_clear()
    prep._operator_on.cache_clear()
    vol = torch.rand(20, 30, 3)
    for _ in range(3):
        for mode in ("constant", "nearest"):
            prep.zoom_volume_device(vol, (8, 12), mode)
    prep.zoom_volume_device(torch.rand(30, 20, 2), (12, 8))
    # (20, 8), (30, 12) in two modes; (30, 12) and (20, 8) again
    assert prep.zoom_operator.cache_info().misses == 4
    assert prep._operator_on.cache_info().misses == 4
    op = prep.zoom_operator(20, 8, "constant")
    assert op.shape == (8, 20) and op.dtype == np.float64
    assert not op.flags.writeable
