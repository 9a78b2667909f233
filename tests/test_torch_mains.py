"""The port's preset entry points (``…_torch/mains/main_<preset>.py``): one
per preset of ``config.EXPERIMENT_PRESETS`` and of the JAX package's
``mains/``, each forwarding ``--preset <name>`` and its own arguments to
the port's ``cli.main`` and exiting with its return code."""

import os
import runpy
import sys

import pytest

from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
    EXPERIMENT_PRESETS,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "unsupervised_anomaly_detection_brain_mri_tpu_torch"


def test_one_main_per_preset_and_per_jax_main():
    ours = sorted(n for n in os.listdir(os.path.join(ROOT, PORT, "mains"))
                  if n.startswith("main_"))
    assert ours == sorted(f"main_{p}.py" for p in EXPERIMENT_PRESETS)
    assert ours == sorted(n for n in os.listdir(os.path.join(ROOT, "mains"))
                          if n.startswith("main_"))


@pytest.mark.parametrize("name", list(EXPERIMENT_PRESETS))
def test_main_forwards_its_preset_and_flags(name, monkeypatch):
    seen = []
    monkeypatch.setattr(cli, "main", lambda argv: seen.append(argv) or 3)
    monkeypatch.setattr(sys, "argv", [f"main_{name}.py", "--synthetic",
                                      "-E", "1", "--device", "cpu"])
    with pytest.raises(SystemExit) as exit_info:
        runpy.run_module(f"{PORT}.mains.main_{name}", run_name="__main__")
    assert exit_info.value.code == 3
    assert seen == [["--preset", name, "--synthetic", "-E", "1", "--device",
                     "cpu"]]
