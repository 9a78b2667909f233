"""The port's metric sweep and lesion-detection counts against the JAX ops,
on tie-heavy random scores and on random blobs that touch 20-slice chunk
edges.  Counts and thresholds must be equal; ratios agree within 1e-6."""

import numpy as np
import pytest
import torch

from test_golden_parity import prc_sklearn_023
from unsupervised_anomaly_detection_brain_mri_tpu.ops import metrics as JM
from unsupervised_anomaly_detection_brain_mri_tpu.ops import (
    postprocess as JP,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
    metrics as TM,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
    postprocess as TP,
)

RATIO = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small and the suite runs in several worker
    processes: one intra-op thread per worker keeps them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tied_scores(seed, n=None):
    """Scores rounded to 1-3 decimals (many ties, exact zeros) and labels
    with a random positive rate."""
    rng = np.random.default_rng(seed)
    n = n or int(rng.integers(200, 3000))
    scores = np.round(rng.uniform(0, 1, n), int(rng.integers(1, 4)))
    scores[rng.uniform(size=n) < 0.3] = 0.0
    labels = rng.uniform(0, 1, n) < rng.uniform(0.05, 0.5)
    labels[0] = True
    return scores.astype(np.float32), labels


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("seed", range(6))
def test_curve_summary_matches_jax(seed):
    scores, labels = _tied_scores(seed)
    ref = JM.anomaly_curve_summary(scores, labels)
    got = TM.anomaly_curve_summary(_t(scores), _t(labels))
    # the cut points: exact
    assert float(got["best_threshold"]) == float(ref["best_threshold"])
    assert float(got["precision70_threshold"]) == float(
        ref["precision70_threshold"])
    assert float(got["best_dice"]) == float(ref["best_dice"])
    # the ratios: float64 sums here, float32 in the JAX package
    np.testing.assert_allclose(float(got["auc"]), float(ref["auc"]), **RATIO)
    np.testing.assert_allclose(float(got["ap"]), float(ref["ap"]), **RATIO)
    for curve in ("roc", "prc", "dice_curve"):
        assert set(got[curve]) == set(ref[curve])
        for k, v in got[curve].items():
            assert v.shape == (256,)


@pytest.mark.parametrize("seed", range(4))
def test_standalone_sweeps_match_jax_and_sklearn(seed):
    from sklearn.metrics import average_precision_score, roc_auc_score

    scores, labels = _tied_scores(100 + seed)
    s, l_ = _t(scores), _t(labels)
    best, thr = TM.best_dice_threshold(s, l_)
    rbest, rthr = JM.best_dice_threshold(scores, labels)
    assert float(best) == float(rbest) and float(thr) == float(rthr)
    np.testing.assert_allclose(float(TM.roc_auc(s, l_)),
                               roc_auc_score(labels, scores), **RATIO)
    np.testing.assert_allclose(float(TM.average_precision(s, l_)),
                               average_precision_score(labels, scores),
                               **RATIO)
    t70 = float(TM.precision70_threshold(s, l_))
    assert t70 == float(JM.precision70_threshold(scores, labels))
    prec, _, thresholds = prc_sklearn_023(labels, scores)
    idx = int(np.argmax(prec <= 0.7))
    if idx < len(thresholds):
        assert t70 == thresholds[idx]


def test_int64_counts_past_float32_integer_range():
    """2^24 + 5 scores: a float32 cumulative count stalls at 2^24, the
    int64 one does not.  Two positives and one negative score 1, every
    other negative 0: AUROC = 1 - 0.5 / N exactly."""
    n = 2 ** 24 + 5
    scores = torch.zeros(n)
    scores[-3:] = 1.0
    labels = torch.zeros(n, dtype=torch.bool)
    labels[-2:] = True
    summary = TM.anomaly_curve_summary(scores, labels)
    negatives = n - 2
    assert float(summary["auc"]) == 1.0 - 0.5 / negatives
    assert float(summary["best_dice"]) == np.float32(0.8)
    assert float(summary["best_threshold"]) == 0.0


@pytest.mark.parametrize("seed", range(3))
def test_pointwise_and_segmented_stats_match_jax(seed):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(size=(9, 6, 7)) < 0.3
    gt = rng.uniform(size=(9, 6, 7)) < 0.2
    P, G = _t(pred), _t(gt)
    for name in ("dice", "tpr", "fpr", "precision", "recall", "vd"):
        np.testing.assert_allclose(float(getattr(TM, name)(P, G)),
                                   float(getattr(JM, name)(pred, gt)),
                                   **RATIO, err_msg=name)
    assert [int(v) for v in TM.confusion_matrix(P, G)] == [
        int(v) for v in JM.confusion_matrix(pred, gt)]
    owners = np.repeat(np.arange(3, dtype=np.int32), [2, 4, 3])
    got = TM.segmented_confusion_stats(P.float(), G.float(), _t(owners), 3)
    ref = JM.segmented_confusion_stats(pred.astype(np.float32),
                                       gt.astype(np.float32), owners, 3)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    p = rng.uniform(size=(5, 4, 3)).astype(np.float32)
    sig = rng.normal(size=(5, 4, 3)).astype(np.float32)
    for log_var in (False, True):
        np.testing.assert_allclose(
            TM.combined_predictive_uncertainty(_t(p), _t(sig), 0,
                                               log_var).numpy(),
            np.asarray(JM.combined_predictive_uncertainty(p, sig, 0,
                                                          log_var)),
            rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# lesion detection


def _blobs(seed, shape=(47, 24, 24), n=14):
    """Random ellipsoid blobs, several straddling the slice-20 and slice-40
    chunk edges, plus single-voxel specks (< 8-voxel components)."""
    rng = np.random.default_rng(seed)
    S, H, W = shape
    zz, yy, xx = np.mgrid[:S, :H, :W]
    m = np.zeros(shape, bool)
    for i in range(n):
        cz = (19.5 if i % 3 == 0 else 39.5 if i % 3 == 1
              else rng.uniform(0, S))
        c = (cz, rng.uniform(0, H), rng.uniform(0, W))
        r = rng.uniform(1.0, 3.5, size=3)
        m |= (((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2
              + ((xx - c[2]) / r[2]) ** 2) <= 1.0
    specks = rng.uniform(size=shape) < 0.002
    return m | specks


@pytest.mark.parametrize("seed", range(4))
def test_detection_counts_match_jax(seed):
    gt = _blobs(seed)
    pred = _blobs(seed + 50) | (gt & (np.random.default_rng(seed).uniform(
        size=gt.shape) < 0.7))
    got = TP.compute_detection_rate(_t(pred.astype(np.float32)),
                                    _t(gt.astype(np.float32)))
    ref = JP.compute_detection_rate(pred.astype(np.float32),
                                    gt.astype(np.float32))
    assert [int(v) for v in got] == [int(v) for v in ref]
    pc = TP.volume_to_chunks(_t(pred.astype(np.float32)))
    gc = TP.volume_to_chunks(_t(gt.astype(np.float32)))
    np.testing.assert_array_equal(
        pc.numpy(), np.asarray(JP.volume_to_chunks(pred.astype(np.float32))))
    t, f, n, conv = TP.detection_counts_batch(pc, gc)
    rt, rf, rn, rconv = JP.detection_counts_batch(
        np.asarray(pc.numpy()), np.asarray(gc.numpy()))
    for a, b in ((t, rt), (f, rf), (n, rn), (conv, rconv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_batched_labels_stay_inside_their_chunk():
    """A component crossing two stacked chunks is two components: labels
    are per-chunk flat indices, as under the JAX package's vmap."""
    m = np.zeros((2, 4, 5, 5), bool)
    m[0, 3, 2, 2] = m[1, 0, 2, 2] = True  # touching across the chunk seam
    labels = TP.connected_components_3d(_t(m))
    assert labels[0, 3, 2, 2] == 3 * 25 + 2 * 5 + 2 + 1
    assert labels[1, 0, 2, 2] == 2 * 5 + 2 + 1
    assert TP.num_components(labels).tolist() == [1, 1]
    single = np.asarray(JP.connected_components_3d(m[1]))
    np.testing.assert_array_equal(labels[1].numpy(), single)


@pytest.mark.parametrize("seed", range(2))
def test_component_helpers_match_jax(seed):
    m = np.random.default_rng(seed).uniform(size=(5, 9, 8)) < 0.35
    labels = np.asarray(JP.connected_components_3d(m))
    tl = _t(labels)
    np.testing.assert_array_equal(TP.component_sizes(tl).numpy(),
                                  np.asarray(JP.component_sizes(labels)))
    assert int(TP.num_components(tl)) == int(JP.num_components(labels))
    hit = np.random.default_rng(seed + 9).uniform(size=m.shape) < 0.2
    assert int(TP._labels_hit(tl, _t(hit))) == int(
        JP._labels_hit(labels, hit))
    x = np.random.default_rng(seed).uniform(size=(3, 9, 8)).astype(np.float32)
    for erode in (False, True):
        np.testing.assert_array_equal(
            TP.apply_brainmask(_t(x), _t(m[:3]), erode, 2).numpy(),
            np.asarray(JP.apply_brainmask(x, m[:3], erode, 2)))
