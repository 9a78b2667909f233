"""The port stands alone: no module of it, and not ``chip_smoke.py``,
imports JAX or anything of the JAX package, and with those names blocked
every module of the port imports and the CLI builds its synthetic cohort."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "unsupervised_anomaly_detection_brain_mri_tpu_torch"
BANNED = ("unsupervised_anomaly_detection_brain_mri_tpu", "jax", "jaxlib",
          "flax", "optax", "orbax")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "bench_torch.py"),
           os.path.join(ROOT, "tests", "_torch_realdata.py"),
           os.path.join(ROOT, "tests", "_torch_ccl.py")]
    # the tools written for the port; jax_workdir_to_torch.py reads a JAX
    # workdir with the JAX package, by design
    out += sorted(p for p in glob.glob(os.path.join(ROOT, "tools",
                                                    "*_torch.py"))
                  if os.path.basename(p) != "jax_workdir_to_torch.py")
    for dirpath, dirnames, names in os.walk(os.path.join(ROOT, PORT)):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        out += [os.path.join(dirpath, n) for n in sorted(names)
                if n.endswith(".py")]
    return [os.path.relpath(p, ROOT) for p in out]


def _imported_names(tree):
    """Every module name the file imports: import statements, and
    ``importlib.import_module`` / ``__import__`` with a literal name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            if name in ("import_module", "__import__"):
                yield node.args[0].value


@pytest.mark.parametrize("path", _sources())
def test_source_imports_nothing_of_jax_or_the_jax_package(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = sorted(n for n in _imported_names(tree)
                 if n.split(".")[0] in BANNED)
    assert not bad, f"{path} imports {bad}"


def test_quickstart_notebook_imports_nothing_of_jax_or_the_jax_package():
    """The code cells of `examples/quickstart_torch.ipynb`, each parsed."""
    with open(os.path.join(ROOT, "examples", "quickstart_torch.ipynb")) as f:
        cells = [c for c in json.load(f)["cells"] if c["cell_type"] == "code"]
    assert cells
    names = [n for c in cells
             for n in _imported_names(ast.parse("".join(c["source"])))]
    assert PORT in {n.split(".")[0] for n in names}
    bad = sorted(n for n in names if n.split(".")[0] in BANNED)
    assert not bad, f"quickstart_torch.ipynb imports {bad}"


def test_sources_cover_the_mains_and_this_slice():
    """The scan reaches the preset mains, the downloader and the shared
    real-format fixture that chip_smoke.py uses."""
    sources = set(_sources())
    assert {os.path.join(PORT, "mains", "main_AE.py"),
            os.path.join(PORT, "data", "download.py"),
            os.path.join("tests", "_torch_realdata.py")} <= sources


def test_sources_cover_the_whole_model_zoo():
    """The scan reaches every network module of the port, the ResNet stack
    and the image critics included."""
    models = {os.path.basename(p) for p in _sources()
              if os.path.dirname(p) == os.path.join(PORT, "models")}
    assert {"ae.py", "vae.py", "cevae.py", "gmvae.py", "aae.py", "resnet.py",
            "chen.py", "fanogan.py", "anovaegan.py"} <= models


def test_sources_cover_the_measurement_layer():
    """The scan reaches the benchmark and both roofline tools."""
    assert {"bench_torch.py", os.path.join("tools", "hbm_roofline_torch.py"),
            os.path.join("tools", "parity_stage_roofline_torch.py")} <= set(
        _sources())


_BLOCKER = """
import sys


class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {banned!r}:
            raise ImportError(f"blocked import of {{name}}")
        return None


sys.meta_path.insert(0, _Blocked())
"""

_IMPORT_ALL = """
import importlib
import pkgutil

import {port} as port

names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                               port.__name__ + ".")]
for name in names:
    try:
        importlib.import_module(name)
    except ModuleNotFoundError as e:
        # the plots of eval/artifacts.py need matplotlib and imageio
        if e.name not in ("matplotlib", "imageio"):
            raise
print("IMPORTED", len(names))
"""

_BUILD_DATASET = """
from {port}.cli import build_dataset
from {port}.config import Config, Dataset, Options

options = Options(sliceStart=0, sliceEnd=8, cache=False)
config = Config(outputWidth=32, outputHeight=32)
healthy = build_dataset(options, config, Dataset.SYNTH, "healthy")
lesioned = build_dataset(options, config, Dataset.SYNTH, "pathological")
train = healthy.slices("TRAIN")
assert train.shape[1:] == (32, 32, 1) and len(train) > 0, train.shape
assert len(lesioned.patients_of("TEST")) == 3
vol, gt = lesioned.load_volume_and_groundtruth(
    lesioned.patients_of("TEST")[0])[:2]
assert vol.shape == gt.shape and gt.any()
print("BUILT", train.shape)
"""


def _run_blocked(body):
    code = _BLOCKER.format(banned=BANNED) + body.format(port=PORT)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_every_module_imports_with_jax_and_the_jax_package_blocked():
    proc = _run_blocked(_IMPORT_ALL)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED" in proc.stdout


_IMPORT_MEASUREMENT = """
import importlib.util
import os

import bench_torch

for rel in ("tools/hbm_roofline_torch.py",
            "tools/parity_stage_roofline_torch.py"):
    spec = importlib.util.spec_from_file_location(
        os.path.basename(rel)[:-3], rel)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print("IMPORTED", bench_torch.METRIC)
"""


def test_the_measurement_layer_imports_with_jax_blocked():
    proc = _run_blocked(_IMPORT_MEASUREMENT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED brainweb_ae_train_throughput" in proc.stdout


def test_cli_builds_the_synthetic_cohort_with_jax_blocked():
    proc = _run_blocked(_BUILD_DATASET)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BUILT" in proc.stdout


def test_blocker_blocks():
    """The blocked names really are blocked in the subprocess."""
    proc = _run_blocked("import unsupervised_anomaly_detection_brain_mri_tpu"
                        ".config\n")
    assert proc.returncode != 0 and "blocked import" in proc.stderr
