"""The metric readers and the trace arithmetic on synthetic records."""

import pytest

from benchmark.common import manifest as M
from benchmark.common import trace as T

MS = 1_000_000


def test_union_gaps_and_the_span_open_at_a_time():
    busy = T.union([(0, 10), (5, 20), (30, 40), (40, 45), (50, 55)])
    assert busy == [(0, 20), (30, 45), (50, 55)]
    assert T.gaps(busy, -5, 60) == [(-5, 0), (20, 30), (45, 50), (55, 60)]
    spans = [{"name": "outer", "start_ns": 0, "end_ns": 100},
             {"name": "inner", "start_ns": 20, "end_ns": 40}]
    assert T.innermost(spans, 25) == "inner"
    assert T.innermost(spans, 50) == "outer"
    assert T.innermost(spans, 150) is None


def test_summary_counts_overlap_once_and_names_idle_time():
    events = [("k1", 0, 4 * MS), ("k2", 2 * MS, 6 * MS),
              ("k1", 8 * MS, 9 * MS), ("early", -5 * MS, -1 * MS)]
    spans = [{"name": "step", "start_ns": 0, "end_ns": 8 * MS},
             {"name": "sync", "start_ns": 8 * MS, "end_ns": 10 * MS}]
    tr = T.summarize(events, 0, 10 * MS, spans)
    assert tr["window_s"] == pytest.approx(0.010)
    assert tr["busy_s"] == pytest.approx(0.007)
    assert tr["ops"]["k1"] == {"seconds": pytest.approx(0.005), "count": 2}
    assert "early" not in tr["ops"]
    assert tr["idle_by_span"] == {"step": pytest.approx(0.002),
                                  "sync": pytest.approx(0.001)}
    b = T.breakdown(tr)
    assert b["device_ops"][0][0] == "k1"
    assert b["idle_gaps"][0] == ["step", pytest.approx(0.002)]


def _train_record():
    spans = [{"name": "train_step", "start_ns": i * 10 * MS,
              "end_ns": i * 10 * MS + 4 * MS, "parent": None}
             for i in range(10)]
    return {"kind": "train", "setup_s": 12.5, "units": 10,
            "slices_per_unit": 128, "window_s": 0.1, "spans": spans,
            "flops_per_unit": 2e9, "peaks": (1e12, 1e12),
            "trace": {"window_s": 0.1, "busy_s": 0.06, "ops": {},
                      "idle_by_span": {}}}


def test_train_readers():
    rec = _train_record()
    read = {n: M.reader(n)(rec) for n in (
        "host_ms_per_step.train", "kernel_ms_per_step.train",
        "device_idle_pct.train", "mfu_pct.train", "setup_s")}
    assert read == {"host_ms_per_step.train": pytest.approx(4.0),
                    "kernel_ms_per_step.train": pytest.approx(6.0),
                    "device_idle_pct.train": pytest.approx(40.0),
                    "mfu_pct.train": pytest.approx(20.0),
                    "setup_s": 12.5}
    # a traced record carries no throughput; an untraced one no layers
    assert M.reader("train_slices_per_s")(rec) is None
    plain = {"kind": "train", "units": 30, "slices_per_unit": 8,
             "window_s": 2.0, "setup_s": 1.0}
    assert M.reader("train_slices_per_s")(plain) == pytest.approx(120.0)
    assert M.reader("device_idle_pct.train")(plain) is None
    assert M.reader("volumes_per_s")(plain) is None


def _serve_record():
    spans, t = [], 0
    for _ in range(4):
        spans.append({"name": "detect", "start_ns": t, "end_ns": t + 100 * MS})
        spans.append({"name": "_reconstruct_volume",
                      "start_ns": t + 60 * MS, "end_ns": t + 80 * MS})
        spans.append({"name": "_postprocess", "start_ns": t + 80 * MS,
                      "end_ns": t + 85 * MS})
        spans.append({"name": "median", "start_ns": t + 82 * MS,
                      "end_ns": t + 84 * MS, "shape": [10, 100, 100]})
        spans.append({"name": "filter_small_components",
                      "start_ns": t + 85 * MS, "end_ns": t + 95 * MS})
        t += 100 * MS
    return {"kind": "serve", "units": 4, "window_s": 0.4, "spans": spans,
            "flops_per_unit": 1e9, "peaks": (1e12, 8e11),
            "trace": {"window_s": 0.4, "busy_s": 0.1, "idle_by_span": {},
                      "ops": {"void median5_kernel(float const*)":
                              {"seconds": 0.004, "count": 4},
                              "gemm": {"seconds": 0.05, "count": 40}}}}


def test_serve_readers():
    rec = _serve_record()
    read = {n: M.reader(n)(rec) for n in (
        "prep_ms.serve", "reconstruct_ms.serve", "postprocess_ms.serve",
        "components_ms.serve", "device_idle_pct.serve", "mfu_pct.serve",
        "median5_roofline.serve")}
    # bound: 4 calls x 2 x 4 B x 1e5 voxels at 8e11 B/s = 4 us, of 4 ms
    assert read == {"prep_ms.serve": pytest.approx(60.0),
                    "reconstruct_ms.serve": pytest.approx(20.0),
                    "postprocess_ms.serve": pytest.approx(5.0),
                    "components_ms.serve": pytest.approx(10.0),
                    "device_idle_pct.serve": pytest.approx(75.0),
                    "mfu_pct.serve": pytest.approx(1.0),
                    "median5_roofline.serve": pytest.approx(0.1)}


def test_serve_end_to_end_readers():
    rec = {"kind": "serve", "units": 10, "window_s": 5.0, "setup_s": 3.0,
           "latencies_s": [0.1 * i for i in range(1, 11)]}
    assert M.reader("volumes_per_s")(rec) == pytest.approx(2.0)
    # inclusive quantiles of 0.1 .. 1.0: the 90th lies at 0.91
    assert M.reader("volume_p90_ms")(rec) == pytest.approx(910.0)
    assert M.reader("train_slices_per_s")(rec) is None


def test_a_reader_with_nothing_to_read_returns_none():
    empty = {"kind": "serve", "units": 1, "window_s": 1.0,
             "trace": {"window_s": 1.0, "busy_s": 0.0, "ops": {},
                       "idle_by_span": {}}}
    for name in ("median5_roofline.serve", "mfu_pct.serve",
                 "device_idle_pct.serve", "prep_ms.serve"):
        assert M.reader(name)(empty) is None
