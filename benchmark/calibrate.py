"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload AE.train --seeds 1,2,...,12 \
        --control-seeds 101,102,103 [--faults unchanged --fault-seeds 7,8,9] \
        [--seconds 10] [--out chiprun_out/AE.train.json]

With ``--seeds`` it runs the cell as ``run.py`` does, with a window of
``--seconds`` (long enough to serve the compared requests), and keeps the
compared numbers: the port against the reference (the lower reading is the
largest over them).  With ``--control-seeds`` it runs the cell's set-up
and the control, the reference one precision step lower in the port's
place, without a window (``kinds/<kind>.py::control``; the upper reading
is the smallest over them).  With ``--faults`` it runs the cell as for
``--seeds`` with each fault of ``faults.py`` planted under the port.  The
benchmark's own runs never run it.  It prints one JSON line per seed and a
summary, and writes them to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.common import context as C  # noqa: E402
from benchmark.common import manifest as M  # noqa: E402
from benchmark.common.device import power_limit, require_cuda  # noqa: E402
from benchmark.faults import FAULTS  # noqa: E402


def seeds(text: str):
    return [int(s) for s in text.split(",") if s.strip()]


def readings(cell_name: str, seed_list, control: bool, device=None,
             overrides=None, fault=None, seconds: float = 10.0):
    """One row of numbers per seed, with ``fault`` (``faults.py``) planted
    under the port; ``device`` and ``overrides`` (config and mix entries)
    serve the CPU tests."""
    manifest = M.load_manifest()
    cell = M.cell(manifest, cell_name)
    device = device or require_cuda(int(cell["chips"]))
    overrides = overrides or {}
    rows = []
    for seed in seed_list:
        ctx = C.Run(device=device, seed=seed, seconds=seconds, trace=False,
                    cell=cell,
                    config={**M.config_file(manifest, cell),
                            **overrides.get("config", {})},
                    mix={**M.mix_file(cell), **overrides.get("mix", {})},
                    limits=C.limits_of(cell_name))
        kind = M.kind_module(ctx.mix["kind"])
        t0 = time.perf_counter()
        if control:
            numbers = kind.control(ctx)
        else:
            with (FAULTS[fault]() if fault else contextlib.nullcontext()):
                numbers = kind.run(ctx)[1]
        rows.append({"seed": seed, "control": control, "fault": fault,
                     "seconds": time.perf_counter() - t0, **numbers})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--faults", default="",
                   help="comma-separated names of faults.py, each read on "
                        "--fault-seeds")
    p.add_argument("--seconds", type=float, default=10.0,
                   help="the window of a run of --seeds or --fault-seeds")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    print(f"card: {power_limit()}", flush=True)
    rows = (readings(args.workload, args.seeds, False,
                     seconds=args.seconds)
            + readings(args.workload, args.control_seeds, True))
    for fault in filter(None, args.faults.split(",")):
        rows += readings(args.workload, args.fault_seeds, False, fault=fault,
                         seconds=args.seconds)
    keys = [k for k in rows[0]
            if k not in ("seed", "control", "fault", "seconds")]
    summary = {"workload": args.workload, "card": power_limit()}
    for k in keys:
        prog = [r[k] for r in rows if not r["control"] and not r["fault"]]
        ctrl = [r[k] for r in rows if r["control"]]
        summary[k] = {"lower": max(prog) if prog else None,
                      "upper": min(ctrl) if ctrl else None,
                      "program": prog, "control": ctrl}
        for fault in {r["fault"] for r in rows if r["fault"]}:
            summary[k][fault] = [r[k] for r in rows if r["fault"] == fault]
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
