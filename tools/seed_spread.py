#!/usr/bin/env python
"""Run presets of the quality scoreboard from several init seeds.

``Config.seed`` (the init and shuffling seed) has no CLI flag, so this
patches the package's ``preset`` lookup to add ``seed=S`` and calls the
package's own CLI in process, one run per (preset, seed), each in a fresh
working directory, at the scoreboard recipe of ``examples/run_all.py``
(``--synthetic -E 1 -w 32 -g 32 -s 0 -e 8 -z 16 -b 8 -O 0.5 --precision
float32``).  It writes the first metrics row of every run (at the
recipe's ``-O 0.5`` the TEST cohort's evaluation at that threshold, the row
the scoreboards compare) and the wall of each run as JSON:

    python tools/seed_spread.py --package jax --presets AAE,constrainedAAE \\
        --seeds 42,1,2,3,4 --out spread_jax.json
    python tools/seed_spread.py --package torch --presets AAE \\
        --seeds 42,1,2,3,4 --out spread_torch.json

``--package jax`` runs the JAX package, ``--package torch`` the PyTorch
port, both on the CPU.  ``--summarize A.json B.log
--out S.json`` merges runs of one package (their JSON, or the lines a run
prints, for a run cut short) into the per-metric min, median and max that
``scoreboards/jax_cpu_seeds.json`` holds.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RECIPE = ["--synthetic", "-E", "1", "-w", "32", "-g", "32", "-s", "0",
          "-e", "8", "-z", "16", "-b", "8", "-O", "0.5",
          "--precision", "float32"]
METRIC_KEYS = ("AUROC", "AUPRC", "bestDice", "finalTrainLoss")


def _package(name: str):
    """(the module whose ``preset`` the CLI calls, CLI main, extra CLI
    flags) of one package."""
    if name == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from unsupervised_anomaly_detection_brain_mri_tpu import cli, config

        return config, cli.main, []
    from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli

    return cli, cli.main, ["--device", "cpu"]


def run(package: str, presets, seeds) -> dict:
    holder, cli_main, extra = _package(package)
    original = holder.preset
    out = {"package": package, "recipe": RECIPE + extra,
           "commit": _commit(), "seeds": list(seeds), "presets": {}}
    cwd = os.getcwd()
    try:
        for name in presets:
            rows = out["presets"].setdefault(name, {})
            for seed in seeds:
                holder.preset = (lambda n, s=seed, **kw:
                                 original(n, **dict(kw, seed=s)))
                work = tempfile.mkdtemp(prefix=f"spread_{name}_{seed}_")
                os.chdir(work)
                metrics = os.path.join(work, "metrics.jsonl")
                t0 = time.perf_counter()
                rc = cli_main(["--preset", name, *RECIPE, *extra,
                               "--workdir", os.path.join(work, "w"),
                               "--metrics-out", metrics])
                wall = time.perf_counter() - t0
                with open(metrics) as f:
                    first = json.loads(f.readline())
                rows[str(seed)] = dict(
                    {k: first.get(k) for k in METRIC_KEYS},
                    rc=rc, wall_s=round(wall, 1))
                print(json.dumps({"preset": name, "seed": seed,
                                  **rows[str(seed)]}), flush=True)
    finally:
        holder.preset = original
        os.chdir(cwd)
    return out


def _commit():
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=ROOT, text=True,
            stderr=subprocess.DEVNULL).strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def _load(path: str) -> dict:
    """A run's JSON, or its printed lines ({"preset", "seed", ...})."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        presets = {}
        for line in text.splitlines():
            if line.startswith('{"preset"'):
                row = json.loads(line)
                presets.setdefault(row.pop("preset"), {})[
                    str(row.pop("seed"))] = row
        return {"presets": presets}


def summarize(runs) -> dict:
    """Merge runs of one package into min / median / max per metric."""
    merged = {}
    for r in runs:
        for name, by_seed in r["presets"].items():
            merged.setdefault(name, {}).update(by_seed)
    presets = {}
    for name, by_seed in sorted(merged.items()):
        row = {"seeds": sorted(int(s) for s in by_seed)}
        for key in METRIC_KEYS:
            vals = [v[key] for v in by_seed.values() if v.get(key) is not None]
            row[key] = (None if not vals else
                        {"min": min(vals), "median": statistics.median(vals),
                         "max": max(vals),
                         "values": [by_seed[str(s)][key]
                                    for s in row["seeds"]]})
        presets[name] = row
    first = next(r for r in runs if "package" in r)
    return {"package": first["package"], "commit": first["commit"],
            "recipe": first["recipe"], "presets": presets}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), default="torch")
    ap.add_argument("--presets", default="")
    ap.add_argument("--seeds", default="42,1,2,3,4")
    ap.add_argument("--summarize", nargs="*", default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.summarize:
        result = summarize([_load(p) for p in args.summarize])
    else:
        result = run(args.package, [p for p in args.presets.split(",") if p],
                     [int(s) for s in args.seeds.split(",")])
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
