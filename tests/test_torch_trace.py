"""The port's own spans and counters (``utils/trace.py``): off, a span is
one shared no-op that reads no clock and keeps nothing; on, the records
have the benchmark harness's span shape, a training step divides into
forward, backward and optimizer, ``detect`` into its stages in order, the
counters count what the code does, and recording changes no output."""

import time
import tracemalloc

import numpy as np
import pytest
import torch

from benchmark.common.spans import Spans
from benchmark.common.trace import innermost
from unsupervised_anomaly_detection_brain_mri_tpu_torch import Config, Options
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import make_phantom
from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.inference import (
    AnomalyDetector,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
    postprocess as P,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.engine import (
    epoch_indices,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import trace

STAGES = ["serve.zoom", "serve.mask", "serve.upload", "serve.erode",
          "serve.reconstruct", "serve.postprocess", "serve.download",
          "serve.components", "serve.download"]


def _forbid(*_a, **_k):
    raise AssertionError("called while recording is off")


def test_off_span_is_the_shared_noop_and_keeps_nothing(monkeypatch):
    monkeypatch.setattr(time, "time_ns", _forbid)
    monkeypatch.setattr(torch.cuda, "synchronize", _forbid)
    monkeypatch.setattr(torch.profiler, "record_function", _forbid)
    noop = trace.span("train.step")
    assert trace.span("serve.request", request=3) is noop
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for i in range(1000):
            with trace.span("train.step", step=i):
                assert trace.count("host_syncs") is None
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == trace.__file__ and d.size_diff]
    assert grown == []
    assert trace._ACTIVE is None


def test_nested_recordings_raise():
    with trace.recording():
        with pytest.raises(RuntimeError):
            with trace.recording():
                pass
    with trace.recording() as rec:  # the first one closed
        assert trace.count("cc_rounds", 2) == 2
        assert trace.count("cc_rounds") == 3
    assert rec.counters() == {"cc_rounds": 3}
    assert trace.count("cc_rounds") is None


def test_records_have_the_harness_span_shape(monkeypatch):
    """The same nesting through the harness's ``Spans`` and the port's
    recorder gives records with the same keys and parents, on the
    harness's clock; a recording without ``annotate`` opens no profiler
    range and never synchronises."""
    monkeypatch.setattr(torch.cuda, "synchronize", _forbid)
    monkeypatch.setattr(torch.profiler, "record_function", _forbid)
    harness = Spans()

    def nest(span):
        with span("a", step=1):
            with span("b"):
                pass
            with span("c"):
                with span("d"):
                    pass
        with span("e"):
            pass

    t0 = time.time_ns()
    with trace.recording() as rec:
        nest(trace.span)
    t1 = time.time_ns()
    nest(harness.span)
    ours, theirs = rec.spans(), harness.to_records()
    assert [sorted(r) for r in ours] == [sorted(r) for r in theirs]
    assert ([(r["name"], r["parent"]) for r in ours]
            == [(r["name"], r["parent"]) for r in theirs]
            == [("a", None), ("b", 0), ("c", 0), ("d", 2), ("e", None)])
    assert ours[0]["step"] == 1
    for r in ours:
        assert t0 <= r["start_ns"] <= r["end_ns"] <= t1
        if r["parent"] is not None:
            p = ours[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= p["end_ns"]
    d = ours[3]
    assert innermost(ours, (d["start_ns"] + d["end_ns"]) // 2) == "d"


def _trainer():
    cfg = Config(trainer="AE", model="autoencoder", batchsize=4,
                 outputWidth=32, outputHeight=32, zDim=16,
                 compute_dtype="float32", dropout_rate=0.2)
    t = get_trainer("AE")(cfg, device="cpu")
    t.init_state()
    return t


def _pool():
    x = np.random.default_rng(5).uniform(size=(12, 32, 32, 1))
    return {"x": torch.from_numpy(x.astype(np.float32))}


def test_a_training_step_divides_into_forward_backward_optimizer():
    """Two recorded epochs: each step's children are exactly forward,
    backward and optimizer, in that order, under the epoch span; one host
    sync an epoch (the index upload); the parameters equal those of the
    same epochs run with recording off, bit for bit."""
    pool = _pool()
    idxs = [epoch_indices(np.random.default_rng((1, e)), 12, 4)
            for e in range(2)]
    on, off = _trainer(), _trainer()
    with trace.recording() as rec:
        for i in idxs:
            on._run_epoch("TRAIN", pool, i)
    for i in idxs:
        off._run_epoch("TRAIN", pool, i)
    spans = rec.spans()
    epochs = [k for k, s in enumerate(spans) if s["name"] == "train.epoch"]
    assert len(epochs) == 2
    assert all(spans[k]["phase"] == "TRAIN" for k in epochs)
    steps = [k for k, s in enumerate(spans) if s["name"] == "train.step"]
    assert [spans[k]["step"] for k in steps] == [1, 2, 3, 4, 5, 6]
    assert all(spans[k]["parent"] in epochs for k in steps)
    uploads = [s for s in spans if s["name"] == "train.indices"]
    assert [s["parent"] for s in uploads] == epochs
    for k in steps:
        kids = [s for s in spans if s["parent"] == k]
        assert [s["name"] for s in kids] == [
            "train.forward", "train.backward", "train.optimizer"]
        ends = [spans[k]["start_ns"]] + [
            t for s in kids for t in (s["start_ns"], s["end_ns"])] + [
            spans[k]["end_ns"]]
        assert ends == sorted(ends)
    assert rec.counters() == {"host_syncs": 2}
    for (name, a), b in zip(on.model.state_dict().items(),
                            off.model.state_dict().values()):
        assert torch.equal(a, b), name


def _detector():
    t = _trainer()
    return AnomalyDetector(t, t.config, Options(erosionIterations=1,
                                                minLesionSize=2), 0.05)


def test_detect_records_its_stages_in_order_and_counts_rounds(monkeypatch):
    """One request at 48x48 (so the zoom runs): one ``serve.request`` whose
    stages are its direct children in the table's order, with no overlap;
    ``cc_rounds`` equals the labelling rounds run (4 min-pool sweeps
    each); the outputs equal an unrecorded request's bit for bit."""
    det = _detector()
    vol = make_phantom(np.random.default_rng(0), 48, 12, True)["volume"]
    sweeps = []
    pool = P._min_pool_3x3x3
    monkeypatch.setattr(P, "_min_pool_3x3x3",
                        lambda x: sweeps.append(1) or pool(x))
    with trace.recording() as rec:
        got = det.detect(vol)
    rounds = len(sweeps) // 4
    want = det.detect(vol)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert got["mask"].any() and rounds >= 2
    spans = rec.spans()
    assert [s["name"] for s in spans if s["parent"] is None] == [
        "serve.request"]
    assert spans[0]["request"] == 1
    kids = [s for s in spans if s["parent"] == 0]
    assert [s["name"] for s in kids] == STAGES
    bounds = [t for s in kids for t in (s["start_ns"], s["end_ns"])]
    assert bounds == sorted(bounds)
    assert spans[0]["start_ns"] <= bounds[0] <= bounds[-1] \
        <= spans[0]["end_ns"]
    counters = rec.counters()
    assert counters["cc_rounds"] == rounds
    # uploads 2, the prior's scalar 1, downloads 2 + 1 (the mask), one per
    # labelling round, the final convergence test 1, the sizes' bincount 2
    assert counters["host_syncs"] == rounds + 9
    assert counters["serve.requests"] == 1


# ---------------------------------------------------------------------------
# the adversarial trainers' substeps


def _wgan_trainer(monkeypatch, epoch=0):
    from test_torch_fanogan_schlegl_reference import small_schlegl

    small_schlegl(monkeypatch)
    cfg = Config(trainer="fAnoGAN", model="fanogan_schlegl", batchsize=2,
                 outputWidth=32, outputHeight=32, zDim=8,
                 intermediateResolutions=(4, 4), learningrate=1e-3,
                 compute_dtype="float32", seed=3)
    t = get_trainer("fAnoGAN")(cfg, device="cpu")
    t.init_state()
    t.optimizer = t.make_optimizer()
    t.epoch = epoch
    return t


def _substeps(spans):
    """Each ``train.substep`` span's group and its children's names."""
    return [(s["group"], [c["name"] for c in spans if c["parent"] == k])
            for k, s in enumerate(spans) if s["name"] == "train.substep"]


def test_a_wgan_step_records_its_substeps(monkeypatch):
    """One WGAN step of ``fAnoGAN_schlegl``: a generator substep, then five
    critic substeps, all under the step's span; each critic substep holds
    its penalty before its backward; ``critic_updates`` counts 5."""
    t = _wgan_trainer(monkeypatch)
    pool = {"x": _pool()["x"][:4]}
    with trace.recording() as rec:
        t._run_epoch("TRAIN", pool, np.array([[0, 1]]))
    spans = rec.spans()
    (step,) = [k for k, s in enumerate(spans) if s["name"] == "train.step"]
    subs = [k for k, s in enumerate(spans) if s["name"] == "train.substep"]
    assert all(spans[k]["parent"] == step for k in subs)
    critic = ["train.forward", "train.penalty", "train.backward",
              "train.optimizer"]
    assert _substeps(spans) == [
        ("gen", ["train.forward", "train.backward", "train.optimizer"])] + [
        ("disc", critic)] * 5
    for k in subs:
        kids = [s for s in spans if s["parent"] == k]
        ends = [t_ for s in kids for t_ in (s["start_ns"], s["end_ns"])]
        assert ends == sorted(ends)
    assert rec.counters()["critic_updates"] == 5


def test_an_encoder_step_records_one_substep_and_no_penalty(monkeypatch):
    t = _wgan_trainer(monkeypatch, epoch=1)  # numEpochs 1: the izif phase
    pool = {"x": _pool()["x"][:4]}
    with trace.recording() as rec:
        t._run_epoch("TRAIN", pool, np.array([[0, 1]]))
    assert _substeps(rec.spans()) == [
        ("enc", ["train.forward", "train.backward", "train.optimizer"])]
    assert "critic_updates" not in rec.counters()
    assert not [s for s in rec.spans() if s["name"] == "train.penalty"]


def test_recording_changes_no_wgan_step(monkeypatch):
    """A WGAN step's losses and parameters with a recording open equal
    those without, bit for bit."""
    pool = {"x": _pool()["x"][:4]}
    on, off = _wgan_trainer(monkeypatch), _wgan_trainer(monkeypatch)
    with trace.recording():
        got = on._run_epoch("TRAIN", pool, np.array([[0, 1], [2, 3]]))
    want = off._run_epoch("TRAIN", pool, np.array([[0, 1], [2, 3]]))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for (name, a), b in zip(on.model.state_dict().items(),
                            off.model.state_dict().values()):
        assert torch.equal(a, b), name
