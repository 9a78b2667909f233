"""The benchmark's cell ``fAnoGAN_schlegl.train`` run whole on the CPU at a
small size (ResNet ``dim`` 8, 32 x 32, batch 2, zDim 8, float32; the look
for a card skipped by passing the device): the run is correct, with each
group's numbers under its limits; with a fault of the critic planted under
the port (the gradient penalty left out, its double backward dropped, the
critic's optimizer never stepping) it is not; and the cell's per-layer
metric readers read numbers from a traced record, the two that read the
port's spans nothing from a record without them."""

import math

import pytest
import torch

from benchmark import adversarial_faults
from benchmark import run as R
from benchmark.common import manifest as M
from test_torch_fanogan_schlegl_reference import small_schlegl

CELL = "fAnoGAN_schlegl.train"
SMALL = {"config": {"outputWidth": 32, "outputHeight": 32, "zDim": 8,
                    "batchsize": 2, "dim": 8, "intermediateResolutions": [4, 4],
                    "compute_dtype": "float32"},
         "mix": {"pool_volumes": 1, "slices": 12, "block_steps": 2,
                 "trace_steps": 4}}
SHARED = ["host_ms_per_step.train", "kernel_ms_per_step.train",
          "device_idle_pct.train", "mfu_pct.train"]  # every training cell's
OWN = ["critic_ms_per_step.wgan_train", "penalty_ms_per_step.wgan_train"]


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    small_schlegl(monkeypatch)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(trace=0, seed=2 ** 33 + 5):
    args = R.parse(["--workload", CELL, "--seed", str(seed), "--seconds",
                    "0.5", "--trace", str(trace)])
    return R.run(args, device=torch.device("cpu"), overrides=SMALL)[0]


def test_the_cell_is_correct_with_each_group_under_its_limits():
    out = _run()
    assert out["correct"] is True, out["checks"]
    assert {k.split(".")[0] for k in out["checks"]} == {"gen", "disc"}
    for name, c in out["checks"].items():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"], name
    assert set(out["metrics"]) == {"train_slices_per_s", "setup_s"}
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_the_penalty_left_out_is_not_correct():
    with adversarial_faults.no_penalty():
        out = _run()
    assert out["correct"] is False
    assert any(math.isfinite(c["value"]) and c["value"] > c["limit"]
               for n, c in out["checks"].items()
               if n.startswith("disc.")), out["checks"]


@pytest.mark.parametrize("fault", ["no_double_backward",
                                   "unstepped_critic"])
def test_a_fault_that_keeps_the_critic_loss_is_not_correct(fault):
    """Both keep the critic's loss as it was, so only the critic's first
    gradient on the port's own state tells them apart."""
    with adversarial_faults.FAULTS[fault]():
        out = _run()
    assert out["correct"] is False
    assert out["checks"]["disc.loss_rel"]["value"] <= \
        out["checks"]["disc.loss_rel"]["limit"]
    assert any(math.isfinite(c["value"]) and c["value"] > c["limit"]
               for n, c in out["checks"].items()
               if n.startswith("disc.grad1_own")), out["checks"]


def test_a_traced_run_records_the_port_spans():
    """On the CPU the profiler sees no device operations, so only the
    host's span is read; the run is correct all the same."""
    out = _run(trace=1)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"host_ms_per_step.train"}
    allowed = {m["name"] for m in M.metrics_of_cell(M.load_manifest(), CELL,
                                                    True)}
    assert allowed == set(SHARED + OWN)


def _record(with_port_spans=True):
    """A traced record of two steps: 10 ms of window, the device busy 8 ms;
    device work launched inside the port's generator substep (1 ms), the
    critic's forward (1 ms), its penalty (2 ms) and its backward (3 ms), and
    1 ms launched outside every span."""
    ms = 1_000_000
    spans = [{"name": "train.substep", "start_ns": 0, "end_ns": 2 * ms,
              "parent": None, "group": "gen"},
             {"name": "train.substep", "start_ns": 2 * ms, "end_ns": 9 * ms,
              "parent": None, "group": "disc"},
             {"name": "train.forward", "start_ns": 2 * ms, "end_ns": 3 * ms,
              "parent": 1},
             {"name": "train.penalty", "start_ns": 3 * ms, "end_ns": 5 * ms,
              "parent": 1},
             {"name": "train.backward", "start_ns": 5 * ms, "end_ns": 8 * ms,
              "parent": 1},
             {"name": "train.backward", "start_ns": 1 * ms,
              "end_ns": 1 * ms + 10, "parent": 0}]
    launches = [(int(0.5 * ms), 1e-3), (int(2.5 * ms), 1e-3),
                (int(3.5 * ms), 2e-3), (int(6 * ms), 3e-3),
                (int(9.5 * ms), 1e-3)]
    return {"kind": "train", "mix": "wgan_train", "units": 2,
            "slices_per_unit": 2, "window_s": 0.01,
            "spans": [{"name": "train_step", "start_ns": 0,
                       "end_ns": 4 * ms, "parent": None},
                      {"name": "train_step", "start_ns": 4 * ms,
                       "end_ns": 10 * ms, "parent": None}],
            "trace": {"window_s": 0.01, "busy_s": 0.008, "ops": {},
                      "idle_by_span": {}},
            "peaks": (989e12, 3.35e12), "flops_per_unit": 1e9,
            "launches": launches,
            "program_spans": spans if with_port_spans else []}


def test_the_cell_readers_read_a_traced_record():
    rec = _record()
    got = {m: M.reader(m)(rec) for m in SHARED + OWN}
    assert got["host_ms_per_step.train"] == pytest.approx(5.0)
    assert got["kernel_ms_per_step.train"] == pytest.approx(4.0)
    assert got["critic_ms_per_step.wgan_train"] == pytest.approx(3.0)
    assert got["penalty_ms_per_step.wgan_train"] == pytest.approx(2.5)
    assert got["device_idle_pct.train"] == pytest.approx(20.0)
    assert got["mfu_pct.train"] == pytest.approx(
        100 * 2e9 / 0.01 / 989e12)
    assert got["critic_ms_per_step.wgan_train"] \
        < got["kernel_ms_per_step.train"]


def test_the_cell_readers_read_nothing_without_the_port_spans():
    """A port without the adversarial spans (the parent of this cell)
    leaves the two launch-attributed metrics unread, not 0, and the
    training metrics read; a record of another mix leaves the two
    unread."""
    rec = _record(with_port_spans=False)
    assert M.reader("critic_ms_per_step.wgan_train")(rec) is None
    assert M.reader("penalty_ms_per_step.wgan_train")(rec) is None
    assert all(M.reader(m)(rec) is not None for m in SHARED)
    other = {**_record(), "mix": None}
    assert all(M.reader(m)(other) is None for m in OWN)
