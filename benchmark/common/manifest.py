"""``BENCHMARK.json`` and the files it names.

A cell names a configuration and a traffic mix; the configuration's file
is ``configs/<name>.json`` (the path the manifest gives), the mix's is
``traffic/<mix>.json`` and its ``kind`` names the code that runs it,
``kinds/<kind>.py``; every metric is read by ``metrics/<name>.py``.  So a
later cell, mix or metric is a new file and a new entry, never an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_manifest(path: Path = MANIFEST) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _by_name(entries: List[Dict[str, Any]], name: str, what: str
             ) -> Dict[str, Any]:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}; known: "
                   f"{sorted(e['name'] for e in entries)}")


def cell(manifest: Dict[str, Any], name: str) -> Dict[str, Any]:
    return _by_name(manifest["workloads"], name, "workload")


def config_entry(manifest: Dict[str, Any], cell_: Dict[str, Any]
                 ) -> Dict[str, Any]:
    return _by_name(manifest["configs"], cell_["config"], "config")


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def config_file(manifest: Dict[str, Any], cell_: Dict[str, Any]
                ) -> Dict[str, Any]:
    """The configuration as it is run (the file the manifest names)."""
    return read_json(ROOT / config_entry(manifest, cell_)["file"])


def mix_file(cell_: Dict[str, Any]) -> Dict[str, Any]:
    return read_json(BENCH / "traffic" / f"{cell_['traffic']}.json")


def _load(path: Path, tag: str) -> ModuleType:
    """Import the file at ``path`` as a module of its own (metric files
    carry dots in their names, so they are loaded by path)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    mod_name = "benchmark._loaded_" + tag + "_" + re.sub(r"\W", "_",
                                                         path.stem)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def kind_module(kind: str) -> ModuleType:
    return importlib.import_module(f"benchmark.kinds.{kind}")


def reader(metric: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    """``read(record)`` of ``metrics/<metric>.py``: the metric's value from
    a run's record, or None where the record holds nothing to read."""
    return _load(BENCH / "metrics" / f"{metric}.py", "metric").read


def metrics_of_cell(manifest: Dict[str, Any], cell_name: str, trace: bool
                    ) -> List[Dict[str, Any]]:
    """The metrics a run of the cell reports: its end-to-end metrics with
    ``--trace 0``, its per-layer ones with ``--trace 1``.  A metric with a
    ``workloads`` key applies to those cells; a per-layer metric without
    one applies wherever the end-to-end metric it moves is reported."""
    e2e = [m for m in manifest["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}

    def applies(m: Dict[str, Any]) -> bool:
        if "workloads" in m:
            return cell_name in m["workloads"]
        return m["moves"] in moved

    return [m for m in manifest["per_layer"] if applies(m)]
