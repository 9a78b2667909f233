"""The device's activity over a traced window, from ``torch.profiler``.

Only device activity is traced (``ProfilerActivity.CUDA``): tracing host
operators too doubles a launch-bound loop's time.  Every device event
(kernel, copy, set) becomes an interval; the device is busy in the union of
the intervals, not their sum, so work that overlaps is counted once.  The
profiler's clock is aligned to the host's by a marker launched right after
a synchronisation at the window's start.  The idle gaps are named by the
harness's span that was open on the host at the time.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

Interval = Tuple[int, int]
TOP = 10


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """Sorted, merged intervals covering the same points."""
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def gaps(busy: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The idle intervals of [lo, hi) around the merged ``busy`` ones."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(spans: Sequence[Dict[str, Any]], t: int) -> Optional[str]:
    """Name of the innermost (latest begun) span open at time ``t``."""
    best = None
    for s in spans:
        if s["start_ns"] <= t < s["end_ns"]:
            if best is None or s["start_ns"] >= best["start_ns"]:
                best = s
    return None if best is None else best["name"]


def summarize(events: Sequence[Tuple[str, int, int]], start_ns: int,
              end_ns: int, spans: Sequence[Dict[str, Any]] = ()
              ) -> Dict[str, Any]:
    """The record's ``trace``: device events ``(name, start, end)`` (host
    clock, ns) within the window [start_ns, end_ns)."""
    clipped = [(n, max(s, start_ns), min(e, end_ns)) for n, s, e in events
               if min(e, end_ns) > max(s, start_ns)]
    busy = union([(s, e) for _, s, e in clipped])
    busy_ns = sum(e - s for s, e in busy)
    per_op: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for n, s, e in clipped:
        per_op[n][0] += (e - s) / 1e9
        per_op[n][1] += 1
    idle: Dict[str, float] = defaultdict(float)
    for s, e in gaps(busy, start_ns, end_ns):
        name = innermost(spans, (s + e) // 2) or "(no span open)"
        idle[name] += (e - s) / 1e9
    return {
        "window_s": (end_ns - start_ns) / 1e9,
        "busy_s": busy_ns / 1e9,
        "ops": {n: {"seconds": v[0], "count": int(v[1])}
                for n, v in per_op.items()},
        "idle_by_span": dict(idle),
    }


def breakdown(trace: Dict[str, Any]) -> Dict[str, List[List[Any]]]:
    """The result's ``breakdown``: the device operations that took most
    time, and the idle time by the span the host had open, 10 each."""
    ops = sorted(trace["ops"].items(), key=lambda kv: -kv[1]["seconds"])
    idle = sorted(trace["idle_by_span"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:200], v["seconds"]] for n, v in ops[:TOP]],
            "idle_gaps": [[n[:200], s] for n, s in idle[:TOP]]}


def _event_times(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        s = int(e.start_ns())
        return s, s + int(e.duration_ns())
    s = int(e.start_us()) * 1000
    return s, s + int(e.duration_us()) * 1000


class DeviceTrace:
    """``with DeviceTrace(device) as tr: ...`` profiles the device over
    the block; then ``tr.events`` holds (name, start_ns, end_ns) on the
    host's clock and ``tr.start_ns``/``tr.end_ns`` the window."""

    def __init__(self, device: torch.device):
        self.device = device
        self.events: List[Tuple[str, int, int]] = []
        self.start_ns = self.end_ns = 0

    def __enter__(self) -> "DeviceTrace":
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        self._prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                         else ProfilerActivity.CPU])
        self._prof.__enter__()
        if cuda:
            torch.cuda.synchronize(self.device)
        marker = torch.empty(1, device=self.device)
        self._mark_ns = time.time_ns()
        marker.fill_(0.0)
        if cuda:
            torch.cuda.synchronize(self.device)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.end_ns = time.time_ns()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.events = self._device_events()
        return False

    def _device_events(self) -> List[Tuple[str, int, int]]:
        from torch.autograd import DeviceType

        raw = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            s, end = _event_times(e)
            raw.append((e.name(), s, end))
        if not raw:
            return []
        raw.sort(key=lambda r: r[1])
        # the first device event is the marker, launched at _mark_ns; the
        # two clocks agree to its launch latency where the profiler
        # converts to the host's epoch, and are aligned by it otherwise
        offset = raw[0][1] - self._mark_ns
        if abs(offset) < 5_000_000:
            offset = 0
        return [(n, s - offset, e - offset) for n, s, e in raw]
