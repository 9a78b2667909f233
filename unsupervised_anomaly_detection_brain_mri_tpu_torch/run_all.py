"""Train and evaluate every preset through the port's CLI, and check the
sweep's quality against a committed table.

Counterpart of `examples/run_all.py`: the same flags (``--presets``,
``--scoreboard``, ``--check``; every other flag goes to the port's CLI, one
preset at a time, in this process) and the same scoreboard and comparison
(``METRIC_KEYS``, ``_flag_aliases``, ``_comparable_settings`` and
``compare_scoreboard`` are copies of that module's).  The port's tables,
one per backend and profile, at the JAX tables' recipe and tolerances:

  * ``scoreboards/expected_cpu.json``: the port on the CPU, float32;
  * ``scoreboards/expected_h100.json``: on an H100, parity architecture;
  * ``scoreboards/expected_h100_fast.json``: on an H100, ``--tpu-fast``.

    python -m unsupervised_anomaly_detection_brain_mri_tpu_torch.run_all \\
        --synthetic -E 1 -w 32 -g 32 -s 0 -e 8 -z 16 -b 8 -O 0.5 \\
        --precision float32 --device cpu \\
        --check unsupervised_anomaly_detection_brain_mri_tpu_torch/scoreboards/expected_cpu.json

The scoreboard is stamped with ``_backend`` (the torch device type that
``--device`` names: ``cuda`` unless ``--device cpu``), ``_profile``
(``parity`` or ``tpu-fast``), ``_settings`` (the flags passed on) and
``_device`` (the card's name and power limit; metadata, not compared);
``_wall_s`` holds each preset's wall time.  ``--device`` is left out of the
settings comparison, as ``-c`` is: the backend is compared on its own.

A sweep's numbers repeat (``reproducible``): on CUDA it runs cuDNN's and
PyTorch's deterministic algorithms, on the CPU one intra-op thread.  At
the recipe, one epoch of the critics' schedules at lr 1e-3 amplifies
rounding: two default sweeps on one H100 moved ``constrainedAAE_Chen``'s
AUROC by 0.057 and its final loss fourfold, and on the CPU its AUPRC moved
by 0.12 between 2 and 8 threads, beyond the tables' tolerances.

``--download`` first downloads BrainWeb (``data/download.py``) into the
``BRAINWEBDIR`` of the ``-c``/``--config`` paths file (default
``config.default.json``), as `examples/run_all.py` does, then runs the sweep;
``main(argv, opener=...)`` hands the downloader another opener than
``urllib``'s.  An unknown preset exits 2.  A preset that raises is reported,
listed under FAILED, and the exit code is 1.  Asking for a card that is
not there raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from typing import List, Optional

from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
    EXPERIMENT_PRESETS,
)

METRIC_KEYS = ("AUROC", "AUPRC", "bestDice", "finalTrainLoss")
SCOREBOARDS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "scoreboards")


def _flag_aliases() -> dict:
    """Map every CLI flag spelling to its canonical form (``--numEpochs``
    -> ``-E``), from the parser's own registrations."""
    aliases = {}
    for action in cli.make_train_parser()._actions:
        for s in action.option_strings:
            aliases[s] = action.option_strings[0]
    return aliases


def _device_spellings(aliases: dict) -> set:
    """``--device`` and every abbreviation argparse resolves to it."""
    longs = [s for s in aliases if s.startswith("--")]
    return {"--device"[:n] for n in range(3, len("--device") + 1)
            if [s for s in longs if s.startswith("--device"[:n])]
            == ["--device"]}


def _comparable_settings(tokens) -> dict:
    """Canonicalize a recipe-flag list to a {flag: values} map.

    Order-independent but pairing-preserving (so ``-E 1 -w 32`` never
    equals ``-E 32 -w 1``); short/long spellings of the same flag compare
    equal (``-E 1`` == ``--numEpochs 1``); machine-local config paths are
    dropped in all argparse spellings (``-c PATH``, ``-cPATH``,
    ``--config PATH``, ``--config=PATH``), and so is the device
    (``--device X``, ``--device=X`` and its abbreviations): the backend is
    compared on its own.
    """
    aliases = _flag_aliases()
    device = _device_spellings(aliases)
    pairs, flag, skip_value = {}, None, False
    for tok in (str(t) for t in tokens):
        if tok.startswith("-") and not tok[1:2].isdigit():
            base = aliases.get(tok.split("=", 1)[0], tok.split("=", 1)[0])
            if base in ("--tpu-fast", "--parity"):
                # the execution profile is compared explicitly (the
                # scoreboard's _profile vs the table's "profile")
                flag, skip_value = None, False
                continue
            if tok.split("=", 1)[0] in device:
                flag, skip_value = None, "=" not in tok
                continue
            if base == "--config" or base == "-c" or (
                    tok.startswith("-c") and not tok.startswith("--")
                    and len(tok) > 2):
                flag, skip_value = None, ("=" not in tok and tok in
                                          ("-c", "--config"))
                continue
            flag, skip_value = base, False
            entry = pairs.setdefault(flag, [])
            if "=" in tok:
                entry.append(tok.split("=", 1)[1])
        elif skip_value:
            skip_value = False
        elif flag is not None:
            pairs[flag].append(tok)
        else:  # positional with no preceding flag
            pairs.setdefault("", []).append(tok)
    return pairs


def tolerance_band(lo: float, hi: float, key: str, tolerances: dict
                   ) -> tuple:
    """[lo, hi] of ``key`` widened by a table's tolerance: absolute for
    the curve metrics, which live in [0, 1]; relative for the loss."""
    if key == "finalTrainLoss":
        tol = float(tolerances.get(key, 0.5))
        return lo - tol * abs(lo), hi + tol * abs(hi)
    tol = float(tolerances.get(key, 0.1))
    return lo - tol, hi + tol


def compare_scoreboard(scoreboard: dict, expected: dict) -> list:
    """Compare a scoreboard run against a committed expected table.

    Returns a list of human-readable regression strings (empty == pass).
    A preset regresses when any metric leaves ``expected value ±
    tolerance`` (``tolerance_band``).  A table of another backend, profile or recipe
    is refused outright.
    """
    exp_backend = expected.get("backend")
    got_backend = scoreboard.get("_backend")
    if exp_backend and got_backend and exp_backend != got_backend:
        # metric values are backend-dependent (default matmul and conv
        # precision differ), so comparing across backends produces
        # spurious "regressions"
        return [f"backend mismatch: scoreboard ran on {got_backend!r} but "
                f"the expected table was recorded on {exp_backend!r} — "
                f"regenerate the table with --scoreboard on this backend"]
    exp_profile = expected.get("profile")
    got_profile = scoreboard.get("_profile")
    if exp_profile and got_profile and exp_profile != got_profile:
        # the fast profile is a different architecture (s2d stem + d2s
        # head); its metrics have their own expected table
        return [f"profile mismatch: scoreboard ran the {got_profile!r} "
                f"profile but the expected table was recorded with "
                f"{exp_profile!r} — check against the matching table "
                f"(or pass --parity/--tpu-fast)"]
    exp_settings = expected.get("settings")
    got_settings = scoreboard.get("_settings")
    if exp_settings and got_settings is not None and (
            _comparable_settings(exp_settings)
            != _comparable_settings(got_settings)):
        # metric values depend on the run recipe (epochs, image size,
        # threshold, precision)
        return [f"settings mismatch: scoreboard ran with {got_settings} "
                f"but the expected table was recorded with {exp_settings} "
                f"— pass the table's flags (or regenerate it)"]
    tol = expected.get("tolerances", {})
    problems = []
    for name, exp_row in expected.get("presets", {}).items():
        rows = scoreboard.get(name)
        if not rows:
            problems.append(f"{name}: no scoreboard rows (preset failed?)")
            continue
        got = rows[0]
        for key in METRIC_KEYS:
            e, g = exp_row.get(key), got.get(key)
            if e is None:
                continue
            if g is None or not (g == g):  # missing or NaN
                problems.append(f"{name}: {key} missing/NaN (expected {e})")
                continue
            lo, hi = tolerance_band(e, e, key, tol)
            if not lo <= g <= hi:
                problems.append(
                    f"{name}: {key} = {g:.4f}, expected {e:.4f} "
                    f"(±{(hi - lo) / 2:.4f})")
    return problems


def _backend(passthrough: List[str]) -> str:
    """The torch device type ``--device`` names; raises when that is a
    card this machine does not have."""
    import torch

    ns, _ = cli.make_train_parser().parse_known_args(list(passthrough))
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {ns.device!r} requested but no CUDA "
                           "device is available")
    return device.type


def _device(backend: str) -> Optional[dict]:
    """The card's name and power limit (``nvidia-smi``), on CUDA."""
    if backend != "cuda":
        return None
    import torch

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    return {"name": torch.cuda.get_device_name(0),
            "nvidia_smi": smi[0] if smi else None}


@contextlib.contextmanager
def reproducible(backend: str):
    """Run the block with deterministic kernels: on CUDA cuDNN's and
    PyTorch's deterministic algorithms (a kernel that has none warns), on
    the CPU one intra-op thread (oneDNN splits its reductions by the
    thread count).  The previous settings come back afterwards."""
    import torch

    if backend == "cuda":
        saved = (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark,
                 torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled())
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = saved[:2]
            torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])
    else:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            yield
        finally:
            torch.set_num_threads(threads)


def _download(passthrough: List[str], opener=None) -> None:
    """Download BrainWeb into the ``BRAINWEBDIR`` of the paths file that
    ``-c``/``--config`` names (default ``config.default.json``)."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.download import (
        download_brainweb_dataset,
    )

    cfg_path = "config.default.json"
    for i, a in enumerate(passthrough):
        if a in ("-c", "--config"):
            cfg_path = passthrough[i + 1]
    with open(cfg_path) as f:
        target = json.load(f)["BRAINWEBDIR"]
    print(f"Downloading BrainWeb into {target} ...")
    download_brainweb_dataset(target, opener=opener)


def main(argv: Optional[List[str]] = None, opener=None) -> int:
    """The sweep; ``opener`` goes to the BrainWeb downloader
    (``--download``; default ``urllib.request.urlopen``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--download", action="store_true",
                    help="download BrainWeb into the BRAINWEBDIR of -c "
                         "first")
    ap.add_argument("--presets", default=None,
                    help="comma-separated subset (default: all)")
    ap.add_argument("--scoreboard", default=None,
                    help="write per-preset quality metrics (JSON) here")
    ap.add_argument("--check", default=None,
                    help="expected-scoreboard JSON; exit 1 when any "
                         "preset's metrics regress beyond tolerance")
    args, passthrough = ap.parse_known_args(argv)

    presets = (args.presets.split(",") if args.presets
               else list(EXPERIMENT_PRESETS))
    unknown = [p for p in presets if p not in EXPERIMENT_PRESETS]
    if unknown:
        print(f"unknown preset(s) {unknown}; known: "
              f"{sorted(EXPERIMENT_PRESETS)}", file=sys.stderr)
        return 2
    if args.download:
        _download(passthrough, opener)
    # cuBLAS is deterministic with a fixed workspace, read when its
    # handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    backend = _backend(passthrough)
    collect = bool(args.scoreboard or args.check)
    scoreboard: dict = {}
    if collect:
        ns, _ = cli.make_train_parser().parse_known_args(list(passthrough))
        scoreboard["_backend"] = backend
        scoreboard["_settings"] = list(passthrough)
        scoreboard["_profile"] = ("tpu-fast" if cli.resolve_tpu_fast(
            ns.tpu_fast, ns.parity) else "parity")
        scoreboard["_device"] = _device(backend)
        scoreboard["_wall_s"] = {}
    failed = []
    with tempfile.TemporaryDirectory(prefix="uad_scoreboard_") as tmp:
        for name in presets:
            print(f"\n===== {name} =====", flush=True)
            metrics_path = os.path.join(tmp, f"{name}.jsonl")
            extra = ["--metrics-out", metrics_path] if collect else []
            t0 = time.perf_counter()
            try:
                with reproducible(backend):
                    rc = cli.main(["--preset", name] + passthrough + extra)
                if rc != 0:
                    failed.append(name)
            except Exception:
                traceback.print_exc()
                failed.append(name)
            if collect and os.path.exists(metrics_path):
                with open(metrics_path) as f:
                    scoreboard[name] = [json.loads(line) for line in f
                                        if line.strip()]
            if collect:
                scoreboard["_wall_s"][name] = time.perf_counter() - t0
            if args.scoreboard:
                # flush after every preset: a sweep that dies mid-run
                # still leaves the completed presets on disk
                with open(args.scoreboard, "w") as f:
                    json.dump(scoreboard, f, indent=2)
    if args.scoreboard:
        print(f"\nScoreboard written to {args.scoreboard}")
    if args.check:
        with open(args.check) as f:
            expected = json.load(f)
        if args.presets:
            # a subset run is only checked against the rows it ran
            expected = dict(expected, presets={
                k: v for k, v in expected.get("presets", {}).items()
                if k in presets})
        problems = compare_scoreboard(scoreboard, expected)
        if problems:
            print("\nQUALITY REGRESSIONS:")
            for p in problems:
                print(f"  {p}")
            return 1
        print(f"\nQuality check passed for "
              f"{len(expected.get('presets', {}))} presets.")
    if failed:
        print(f"\nFAILED presets: {failed}")
        return 1
    print(f"\nAll {len(presets)} presets completed.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
