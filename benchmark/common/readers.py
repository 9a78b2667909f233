"""What the metric files read from a run's record.

A record (built by a kind's ``run``) holds ``kind``, ``setup_s``,
``window_s``, ``units`` (steps or requests), and as the kind provides them
``slices_per_unit``, ``latencies_s``, ``spans`` (the harness's span
records), ``trace`` (``common/trace.py::summarize``), ``flops_per_unit``
and ``peaks`` (the card's bf16 FLOP/s and bytes/s).  Each helper returns
None where the record holds nothing to read, and the metric is then left
out of the result.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List, Optional

Record = Dict[str, Any]


def of_kind(rec: Record, kind: str) -> bool:
    return rec.get("kind") == kind


def spans(rec: Record, name: str) -> List[Dict[str, Any]]:
    return [s for s in rec.get("spans") or [] if s["name"] == name]


def mean_span_ms(rec: Record, name: str) -> Optional[float]:
    found = spans(rec, name)
    if not found:
        return None
    return statistics.fmean((s["end_ns"] - s["start_ns"]) / 1e6
                            for s in found)


def traced(rec: Record) -> Optional[Dict[str, Any]]:
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return tr


def idle_pct(rec: Record) -> Optional[float]:
    tr = traced(rec)
    if tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu_pct(rec: Record) -> Optional[float]:
    """The reference's FLOPs of the traced work over the traced window,
    as a share of the card's dense bf16 peak."""
    tr = traced(rec)
    if tr is None or not rec.get("peaks") or not rec.get("flops_per_unit"):
        return None
    done = rec["flops_per_unit"] * rec["units"]
    return 100.0 * done / tr["window_s"] / rec["peaks"][0]


def kernel_seconds(rec: Record, needle: str) -> Optional[Dict[str, float]]:
    """Total seconds and launches of the device operations whose name
    contains ``needle``."""
    tr = traced(rec)
    if tr is None:
        return None
    found = [v for n, v in tr["ops"].items() if needle in n]
    if not found:
        return None
    return {"seconds": sum(v["seconds"] for v in found),
            "count": sum(v["count"] for v in found)}
