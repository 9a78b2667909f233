"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 benchmark/run.py --workload AE.train --seed 7 --seconds 51 --trace 0

The cell's configuration, traffic mix, kind, limits and metrics are found
by name (``common/manifest.py``).  The run needs as many CUDA cards as the
cell asks for and exits with code 1, printing no result, without them.
With ``--trace 0`` the result's metrics are the cell's end-to-end ones,
with ``--trace 1`` its per-layer ones, read from a profiled window.  The
last lines on standard error, and the result's last key ``checks``, give
each number compared with the reference beside its limit.  The last line
of standard output is the result, one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# every cache of the program inside the checkout, at fixed paths
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.common.context import process_start  # noqa: E402

STARTED = process_start()


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result(manifest, cell, rec, checks, device, trace: bool):
    from benchmark.common import device as D
    from benchmark.common import manifest as M
    from benchmark.common.compare import passed
    from benchmark.common.trace import breakdown

    rec["peaks"] = (D.peaks(torch_device_name(device))
                    if device.type == "cuda" else None)
    metrics = {}
    for m in M.metrics_of_cell(manifest, cell["name"], trace):
        value = M.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = D.describe(device, int(cell["chips"]))
    if "memory_peak_bytes" in rec:
        dev["memory_peak_bytes"] = rec["memory_peak_bytes"]
    out = {"correct": bool(passed(checks) and rec["failed"] == 0),
           "attempted": int(rec["units"]), "failed": int(rec["failed"]),
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = breakdown(rec["trace"])
    out["checks"] = checks
    return out


def torch_device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device)


def run(args, manifest=None, device=None, overrides=None):
    """The result of one run and every number compared with the
    reference.  The tests give a ``device`` (the CPU) and ``overrides``
    (configuration and mix entries that shrink the cell)."""
    from benchmark.common import context as C
    from benchmark.common import manifest as M
    from benchmark.common.compare import judge
    from benchmark.common.device import require_cuda

    manifest = manifest or M.load_manifest()
    cell = M.cell(manifest, args.workload)
    device = device or require_cuda(int(cell["chips"]))
    overrides = overrides or {}
    mix = {**M.mix_file(cell), **overrides.get("mix", {})}
    ctx = C.Run(device=device, seed=args.seed, seconds=args.seconds,
                trace=bool(args.trace), cell=cell,
                config={**M.config_file(manifest, cell),
                        **overrides.get("config", {})},
                mix=mix, limits=C.limits_of(cell["name"]), started=STARTED)
    kind = M.kind_module(mix["kind"])
    ctx.mark("imports")
    rec, numbers = kind.run(ctx)
    return result(manifest, cell, rec, judge(numbers, ctx.limits), device,
                  ctx.trace), numbers


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.common.device import power_limit
    from benchmark.common.nojax import check_no_jax

    out, numbers = run(args)
    check_no_jax()
    print(f"card: {power_limit()}", file=sys.stderr)
    for name, value in numbers.items():
        if name not in out["checks"]:
            print(f"reading {name}: {value!r} (no limit: not compared)",
                  file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
