"""The port's quickstart notebook (`examples/quickstart_torch.ipynb`) on
the CPU at a small size: its code cells run in order in one namespace,
read from the ``.ipynb`` JSON (no notebook runner needed), with a first
cell of this test's in place of the notebook's that picks ``cpu`` and
shrinks the cohort.  The notebook's own first cell picks ``cuda``."""

import json
import os

import numpy as np
import pytest
import torch

from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTEBOOK = os.path.join(ROOT, "examples", "quickstart_torch.ipynb")
SMALL = 'import torch\n\nDEVICE = "cpu"\nSIZE, SLICES, EPOCHS = 32, 8, 1\n'


def code_cells(path=NOTEBOOK):
    with open(path) as f:
        nb = json.load(f)
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_first_cell_picks_the_card():
    first = code_cells()[0]
    assert 'DEVICE = "cuda"' in first and "SIZE, SLICES, EPOCHS" in first


def test_notebook_runs_on_the_cpu(tmp_path, monkeypatch):
    import matplotlib

    matplotlib.use("Agg")
    monkeypatch.chdir(tmp_path)
    cells = code_cells()
    ns = {}
    with trace.recording() as rec:
        for src in [SMALL] + cells[1:]:
            exec(compile(src, NOTEBOOK, "exec"), ns)
    assert ns["DEVICE"] == "cpu" and ns["trainer"].device.type == "cpu"
    assert ns["model"] is ns["trainer"].model
    for k in ("diff_AUC", "diff_AUPRC", "bestDiceScore"):
        assert np.isfinite(ns["results"][k]), k
    assert np.isfinite(ns["thresh"]) and np.isfinite(ns["fixed"]["DiceScore"])
    assert ns["prior"].shape == (4, 32, 32, 1)
    assert len(ns["roc"]["fpr"]) == 256
    # the plain median on the CPU
    assert "median_kernel" not in rec.counters()
