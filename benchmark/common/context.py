"""What a kind's code gets to run a cell: the device, the seeds, the
window, and the cell's configuration, mix and limits."""

from __future__ import annotations

import dataclasses
import importlib
import os
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from benchmark.common import manifest as M

PORT = "unsupervised_anomaly_detection_brain_mri_tpu_torch"


def _boot_clock() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start() -> float:
    """When this process started, on the boot clock (from
    ``/proc/self/stat``); now, where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _boot_clock()


@dataclasses.dataclass
class Run:
    device: torch.device
    seed: int
    seconds: float
    trace: bool
    cell: Dict[str, Any]
    config: Dict[str, Any]
    mix: Dict[str, Any]
    limits: Dict[str, float]
    started: float = dataclasses.field(default_factory=process_start)

    def setup_seconds(self) -> float:
        return _boot_clock() - self.started

    def mark(self, stage: str) -> None:
        """Print on standard error the seconds since the process started,
        at the end of a stage of set-up."""
        print(f"setup {stage}: {self.setup_seconds():.3f} s",
              file=sys.stderr, flush=True)

    def seeds(self, n: int):
        """``n`` 31-bit seeds derived from the run's seed."""
        state = np.random.SeedSequence(self.seed % 2 ** 64).generate_state(
            n, np.uint32)
        return [int(s) % (2 ** 31 - 16) for s in state]

    def reference_model(self):
        return importlib.import_module(
            f"benchmark.reference.{self.config['reference']}")


def port(module: str):
    """A module of the port, by its path inside the package."""
    return importlib.import_module(f"{PORT}.{module}")


def port_config(cfg: Dict[str, Any], seed: int):
    """The port's ``Config`` of a configuration file, with ``seed``."""
    config_mod = port("config")
    known = {f.name for f in dataclasses.fields(config_mod.Config)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in cfg.items() if k in known}
    if "optimizer" in kw:
        kw["optimizer"] = config_mod.Optimizer(kw["optimizer"])
    return config_mod.Config(**kw, seed=seed)


def limits_of(cell_name: str) -> Dict[str, float]:
    path = M.BENCH / "limits" / f"{cell_name}.json"
    return {k: float(v) for k, v in M.read_json(path)["limits"].items()}
