"""The paper's protocol through the port's CLI without ``--synthetic``, on
the real-format fixture cohorts of `tests/test_torch_realdata.py`
(BrainWeb from the fake server through the port's downloader, MSLUB and
MSISBI2015 as NIfTI; 40^3): train on BRAINWEB healthy, the best-Dice
upper bound without and with the prior on BRAINWEB, MSLUB and MSISBI2015,
the threshold fitted on BRAINWEB VAL into ``calibration.json``, and the
three evaluations at it.  Against the JAX CLI on the same argv and its own
copy of the tree: the same metric rows in the same order, each within the
quality tables' tolerances (training trajectories are not compared
element by element).  Then ``infer`` of an MSISBI2015 scan with the JAX
run's weights and calibration in both packages."""

import contextlib
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from test_torch_realdata import N, make_tree
from test_torch_serving import _load_tool
from unsupervised_anomaly_detection_brain_mri_tpu import cli as jax_cli
from unsupervised_anomaly_detection_brain_mri_tpu.data.volume import (
    open_volume,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import trace

ARGV = ["--preset", "AE", "-w", "32", "-g", "32", "-z", "16", "-b", "8",
        "-E", "1", "-s", "0", "-e", str(N), "--precision", "float32"]
# the quality tables' tolerances (`examples/scoreboard_expected.json`)
TOL = {"AUROC": 0.05, "AUPRC": 0.08, "bestDice": 0.08}
SURFACE = 1e-4  # the card-vs-CPU rule of chip_smoke.py phase 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paths_file(root, tree):
    path = os.path.join(root, "paths.json")
    with open(path, "w") as f:
        json.dump({"BRAINWEBDIR": os.path.join(tree, "brainweb"),
                   "MSLUBDIR": os.path.join(tree, "mslub"),
                   "MSISBI2015DIR": os.path.join(tree, "msisbi2015"),
                   "MSSEG2008DIR": os.path.join(tree, "msseg2008"),
                   "SAMPLEDIR": os.path.join(root, "samples"),
                   "CHECKPOINTDIR": os.path.join(root, "checkpoints")}, f)
    return path


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    """The port's CLI and the JAX CLI on the same argv, each on its own
    copy of the fixture tree; the median launches of the port's run."""
    base = tmp_path_factory.mktemp("realdata_cli")
    make_tree(str(base / "src"))
    runs = {}
    for pkg, main, extra in (("port", cli.main, ["--device", "cpu"]),
                             ("jax", jax_cli.main, [])):
        root = str(base / pkg)
        tree = os.path.join(root, "data")
        shutil.copytree(base / "src", tree)
        wd, metrics = os.path.join(root, "wd"), os.path.join(root, "m.jsonl")
        with (trace.recording() if pkg == "port"
              else contextlib.nullcontext()) as rec:
            rc = main(ARGV + extra + ["-c", _paths_file(root, tree),
                                      "--workdir", wd, "--metrics-out",
                                      metrics])
        with open(metrics) as f:
            rows = [json.loads(line) for line in f]
        runs[pkg] = dict(rc=rc, wd=wd, rows=rows, tree=tree, launches=(
            rec.counters().get("median_kernel", 0) if rec else None))
    return runs


def _key(row):
    """(dataset, description) with the fitted threshold's digits left out
    of the description (each run fits its own)."""
    return row["dataset"], re.sub(r"VALthresh_[-0-9.e]+$", "VALthresh_",
                                  row["description"])


def test_protocol_rows_match_the_jax_cli(protocol):
    ours, theirs = protocol["port"], protocol["jax"]
    assert ours["rc"] == theirs["rc"] == 0
    calib = json.loads(open(os.path.join(ours["wd"],
                                         "calibration.json")).read())
    assert calib["dataset"] == "Brainweb" and np.isfinite(calib["threshold"])
    assert calib["options"]["erosionIterations"] == 3
    keys = [_key(r) for r in ours["rows"]]
    assert keys == [_key(r) for r in theirs["rows"]]
    assert keys == [(d, f"{d}{s}") for s in ("_upperbound",
                                             "_upperbound_wPrior",
                                             "-VALthresh_")
                    for d in ("Brainweb", "MSLUB", "MSISBI2015")]
    assert ours["rows"][-1]["description"].endswith(
        f"VALthresh_{calib['threshold']:.5f}")
    for got, ref in zip(ours["rows"], theirs["rows"]):
        for k, tol in TOL.items():
            assert np.isfinite(got[k]), (got["description"], k)
            assert abs(got[k] - ref[k]) <= tol, (got["description"], k,
                                                 got[k], ref[k])
        assert np.isfinite(got["finalTrainLoss"])


def test_protocol_launches_one_median_per_evaluated_volume(protocol):
    """3 x TEST of each cohort (BRAINWEB 3, MSLUB 2, MSISBI2015 1) and the
    BRAINWEB VAL volume of the threshold fit; on the CPU the plain median
    runs, so the kernel's count stays 0."""
    ours = protocol["port"]
    assert ours["launches"] == 0
    evals = [d for d, _, files in os.walk(os.path.join(
        os.path.dirname(ours["wd"]), "samples")) if "evalPC.json" in files]
    assert len(evals) == 9


def test_infer_on_an_msisbi2015_scan_matches_the_jax_cli(protocol, tmp_path):
    """The JAX run's workdir, converted (``tools/jax_workdir_to_torch.py``),
    served by both CLIs on the CPU with its ``calibration.json``: anomaly
    maps within 1e-4, binary masks equal except within 1e-4 of the
    threshold."""
    theirs = protocol["jax"]
    wd = str(tmp_path / "wd")
    shutil.copytree(theirs["wd"], wd)
    _load_tool().convert(wd)
    scan = os.path.join(theirs["tree"], "msisbi2015", "training01",
                        "preprocessed", "training01_01_flair_pp.nii")
    out = {}
    for pkg, main, extra in (("port", cli.main, ["--device", "cpu"]),
                             ("jax", jax_cli.main, [])):
        d = str(tmp_path / pkg)
        assert main(["infer", "--workdir", wd, "-i", scan, "-o", d]
                    + extra) == 0
        stem = "training01_01_flair_pp"
        out[pkg] = [np.asarray(open_volume(os.path.join(
            d, f"{stem}.{k}.nii.gz")).data)
            for k in ("anomaly", "anomaly.binary")]
        out[pkg].append(json.loads(open(os.path.join(
            d, f"{stem}.report.json")).read()))
    (amap, mask, report), (ref_amap, ref_mask, ref_report) = (out["port"],
                                                              out["jax"])
    t = json.loads(open(os.path.join(wd, "calibration.json")).read())[
        "threshold"]
    assert report["threshold"] == ref_report["threshold"] == t
    assert amap.shape == ref_amap.shape == (N, N, N)
    np.testing.assert_allclose(amap, ref_amap, atol=SURFACE, rtol=0)
    near = np.abs(ref_amap - t) <= SURFACE
    assert not ((mask != ref_mask) & ~near).any()
    assert mask.any()
    np.testing.assert_allclose(report["slice_scores"],
                               ref_report["slice_scores"], atol=SURFACE)
