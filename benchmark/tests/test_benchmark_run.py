"""Whole runs of the harness on the CPU at small sizes (the look for a card
skipped), the faults that must turn ``correct`` false, the control, the
check that no JAX is loaded, and the runs that must fail."""

import json
import math
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from benchmark import faults, run as R
from benchmark.common import manifest as M
from benchmark.common import nojax

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
FLOAT32 = {"compute_dtype": "float32"}
SMALL = {
    "train": {"config": {"outputWidth": 32, "outputHeight": 32, "zDim": 16,
                         "batchsize": 8, **FLOAT32},
              "mix": {"pool_volumes": 2, "slices": 16, "trace_steps": 4}},
    "serve": {"config": {"zDim": 16, "restore_steps": 3, **FLOAT32},
              "mix": {"shape": [181, 217, 24], "statistics_slices": 16,
                      "compared_requests": 1, "compared_steps": 3,
                      "lesions": [3, 1], "trace_requests": 2}},
}


# a window long enough to serve the compared requests on one CPU thread
SECONDS = {"AE.train": 1.0, "AE.serve": 6.0, "VAE_You.serve": 12.0}


def _run(cell, trace=0, seconds=None, seed=2 ** 34 + 3, manifest=None):
    kind = M.mix_file(M.cell(manifest or M.load_manifest(), cell))["kind"]
    seconds = SECONDS.get(cell, 1.0) if seconds is None else seconds
    args = R.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                    str(seconds), "--trace", str(trace)])
    return R.run(args, manifest=manifest, device=CPU,
                 overrides=SMALL[kind])[0]


@pytest.mark.parametrize("cell", list(SECONDS))
def test_a_sound_run_is_correct_and_prints_the_contract(cell):
    out = _run(cell)
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out) == {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert out["attempted"] > 0 and out["failed"] == 0
    manifest = M.load_manifest()
    want = {m["name"] for m in M.metrics_of_cell(manifest, cell, False)}
    assert set(out["metrics"]) == want
    assert out["metrics"]["setup_s"]["value"] > 0
    assert set(out["checks"]) == set(json.load(open(
        M.BENCH / "limits" / f"{cell}.json"))["limits"])


@pytest.mark.parametrize("cell", ["AE.train", "AE.serve"])
def test_a_traced_run_gives_layers_and_a_breakdown(cell):
    out = _run(cell, trace=1)
    assert out["correct"] is True
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    manifest = M.load_manifest()
    allowed = {m["name"] for m in M.metrics_of_cell(manifest, cell, True)}
    # the CPU trace holds no device operations: only the span readers read
    assert out["metrics"] and set(out["metrics"]) <= allowed


@pytest.mark.parametrize("cell,fault", [
    ("AE.train", "unchanged"), ("AE.train", "half_batch"),
    ("AE.serve", "altered_map"), ("AE.serve", "altered_mask"),
    ("VAE_You.serve", "unchanged_restoration"),
    ("VAE_You.serve", "altered_map"), ("VAE_You.serve", "altered_mask")])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    with faults.FAULTS[fault]():
        out = _run(cell)
    assert out["correct"] is False, out["checks"]
    # seen by a number that was read, not by requests left unserved
    assert any(math.isfinite(c["value"]) and c["value"] > c["limit"]
               for c in out["checks"].values()), out["checks"]


@pytest.mark.parametrize("cell", ["AE.train", "AE.serve", "VAE_You.serve"])
def test_the_control_fails_a_limit(cell):
    from benchmark import calibrate
    from benchmark.common.compare import judge, passed
    from benchmark.common.context import limits_of

    kind = cell.split(".")[1]
    small = {k: dict(v) for k, v in SMALL[kind].items()}
    small["config"]["compute_dtype"] = "bfloat16"
    (row,) = calibrate.readings(cell, [17], True, CPU, small)
    numbers = {k: v for k, v in row.items()
               if k not in ("seed", "control", "fault", "seconds")}
    assert not passed(judge(numbers, limits_of(cell))), numbers


def test_a_new_config_and_mix_are_found_without_an_edit(tmp_path):
    """A cell of a configuration and a mix that exist only as new files
    and new entries runs, and nothing of the harness was edited."""
    manifest = M.load_manifest()
    cfg = M.read_json(M.BENCH / "configs" / "AE.json")
    cfg["name"] = "AE_tmp_test"
    mix = M.read_json(M.BENCH / "traffic" / "train.json")
    mix["pool_volumes"] = 1
    new = {M.BENCH / "configs" / "AE_tmp_test.json": cfg,
           M.BENCH / "traffic" / "train_tmp_test.json": mix,
           M.BENCH / "limits" / "AE_tmp_test.train_tmp_test.json":
               M.read_json(M.BENCH / "limits" / "AE.train.json")}
    manifest["configs"].append({"name": "AE_tmp_test", "source": "x",
                                "file": "benchmark/configs/AE_tmp_test.json",
                                "reduced": [], "why": "a test"})
    manifest["workloads"].append({"name": "AE_tmp_test.train_tmp_test",
                                  "config": "AE_tmp_test",
                                  "traffic": "train_tmp_test", "chips": 1,
                                  "why": "a test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "AE.train" in m.get("workloads", []):
            m["workloads"].append("AE_tmp_test.train_tmp_test")
    try:
        for path, data in new.items():
            path.write_text(json.dumps(data))
        out = _run("AE_tmp_test.train_tmp_test", manifest=manifest)
    finally:
        for path in new:
            path.unlink()
    assert out["correct"] is True
    assert {"train_slices_per_s", "setup_s"} == set(out["metrics"])


def test_forbidden_modules_are_compared_by_whole_top_level_name(monkeypatch):
    assert nojax.forbidden_loaded(
        ["jax.numpy", "flax.linen", "optax", "jaxlib.xla_client",
         "unsupervised_anomaly_detection_brain_mri_tpu_torch.models",
         "jaxtyping", "numpy"]) == ["flax", "jax", "jaxlib", "optax"]
    assert nojax.forbidden_loaded(
        ["unsupervised_anomaly_detection_brain_mri_tpu.config"]) == [
        "unsupervised_anomaly_detection_brain_mri_tpu"]
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    with pytest.raises(RuntimeError, match="jaxlib"):
        nojax.check_no_jax()


def test_a_run_loads_no_jax():
    """A whole run in a fresh process leaves no module of JAX or of the
    JAX package loaded."""
    code = (
        "import json, sys, torch\n"
        "from benchmark import calibrate, run as R\n"
        "from benchmark.common import nojax\n"
        f"small = json.loads({json.dumps(json.dumps(SMALL))})\n"
        "for cell in ('AE.train', 'VAE_You.serve'):\n"
        "    args = R.parse(['--workload', cell, '--seed', '5',\n"
        "                    '--seconds', '3'])\n"
        "    R.run(args, device=torch.device('cpu'),\n"
        "          overrides=small[cell.split('.')[1]])\n"
        "print(json.dumps(nojax.forbidden_loaded()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_measurement_path_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = R.parse(["--workload", "AE.train", "--seed", "1", "--seconds",
                    "1", "--trace", "0"])
    with pytest.raises(RuntimeError, match="cuda"):
        R.run(args)
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "AE.train", "--seed", "1", "--seconds", "1"],
                          cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "AE.train", "--seed", "1", "--seconds", "1"],
                          cwd=tmp_path, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
