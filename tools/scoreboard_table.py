#!/usr/bin/env python
"""Turn scoreboards of the port's ``run_all`` into an expected table.

Each run is a ``--scoreboard`` JSON of one sweep on one backend and
profile.  The table holds, per preset, the mean of the runs' first rows
(the row that ``compare_scoreboard`` reads), rounded
to 4 decimals, with the runs' settings, backend and profile and the
tolerances of the JAX CPU table.  With two or more runs it prints, per
metric, the largest spread between the runs over the presets and where it
is:

    python tools/scoreboard_table.py --runs sb1.json sb2.json \\
        --comment "..." --out unsupervised_anomaly_detection_brain_mri_tpu_torch/scoreboards/expected_h100.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_KEYS = ("AUROC", "AUPRC", "bestDice", "finalTrainLoss")


def _without_config(tokens):
    """The flags without the machine-local ``-c``/``--config`` path."""
    out, skip = [], False
    for tok in tokens:
        if skip:
            skip = False
        elif tok in ("-c", "--config"):
            skip = True
        elif not (tok.startswith("--config=") or (
                tok.startswith("-c") and not tok.startswith("--"))):
            out.append(tok)
    return out


def build(runs, comment):
    first = runs[0]
    for r in runs[1:]:
        for key in ("_backend", "_profile", "_settings"):
            a, b = r.get(key), first.get(key)
            if key == "_settings":
                a, b = _without_config(a), _without_config(b)
            if a != b:
                raise SystemExit(f"runs differ in {key}: {a} vs {b}")
    with open(os.path.join(ROOT, "examples",
                           "scoreboard_expected.json")) as f:
        tolerances = json.load(f)["tolerances"]
    names = sorted(k for k in first if not k.startswith("_"))
    presets, spread = {}, {}
    for name in names:
        rows = [r[name][0] for r in runs]
        presets[name], spread[name] = {}, {}
        for key in METRIC_KEYS:
            vals = [row.get(key) for row in rows]
            if any(v is None for v in vals):
                presets[name][key] = None
                continue
            presets[name][key] = round(sum(vals) / len(vals), 4)
            spread[name][key] = max(vals) - min(vals)
    table = {"comment": comment,
             "settings": _without_config(first["_settings"]),
             "backend": first["_backend"], "profile": first["_profile"],
             "tolerances": tolerances, "presets": presets}
    return table, spread


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", nargs="+", required=True)
    ap.add_argument("--comment", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    runs = []
    for path in args.runs:
        with open(path) as f:
            runs.append(json.load(f))
    table, spread = build(runs, args.comment)
    with open(args.out, "w") as f:
        json.dump(table, f, indent=2)
        f.write("\n")
    if len(runs) > 1:
        for key in METRIC_KEYS:
            have = {n: s[key] for n, s in spread.items() if key in s}
            if have:
                worst = max(have, key=have.get)
                print(f"{key}: largest spread between the runs "
                      f"{have[worst]:.6g} ({worst}); median "
                      f"{sorted(have.values())[len(have) // 2]:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
