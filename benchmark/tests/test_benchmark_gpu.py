"""The benchmark's own run on the card (marked ``gpu``; it skips where
``torch.cuda.is_available()`` is false):

    python -m pytest -m gpu benchmark/tests/test_benchmark_gpu.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
def test_ae_train_runs_for_ten_seconds_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "AE.train",
         "--seed", "2147483651", "--seconds", "10", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["kind"] == torch.cuda.get_device_name(0)
    assert out["metrics"]["train_slices_per_s"]["value"] > 0
    assert list(out)[-1] == "checks"
