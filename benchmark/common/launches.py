"""Device time by the port's span that launched it.

A kernel launched inside one of the port's spans (``utils/trace.py``) runs
on the device after the host has moved on, so device time cannot be given
to a span by when it ran.  ``LaunchTrace`` is ``DeviceTrace``
(``common/trace.py``) that also keeps, for every device event, the time of
the runtime call that launched it: the profiler gives both the CUDA
runtime call and the device event one correlation id.  Launch times are
put on the host's clock (``time.time_ns``, the spans' clock) by the
marker's launch, which ``DeviceTrace`` makes right after reading that
clock.  The device events themselves are ``DeviceTrace``'s.

``launched_ms_per_unit`` then sums the device time of the events launched
inside a set of spans, per unit of the window.  Where the profiler gives
no runtime calls, or the record holds none of the spans, it reads None.
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, List, Optional, Sequence, Tuple

from benchmark.common.trace import DeviceTrace, _event_times, union

Launch = Tuple[int, float]  # (launch time ns on the host clock, device s)


class LaunchTrace(DeviceTrace):
    """``DeviceTrace`` with ``launches``: (launch time, device seconds) of
    every device event whose launch the profiler recorded."""

    def __init__(self, device):
        super().__init__(device)
        self.launches: List[Launch] = []

    def _device_events(self) -> List[Tuple[str, int, int]]:
        from torch.autograd import DeviceType

        calls: Dict[int, int] = {}
        device: List[Tuple[str, int, int, int]] = []
        for e in self._prof.profiler.kineto_results.events():
            s, end = _event_times(e)
            if e.device_type() == DeviceType.CUDA:
                device.append((e.name(), s, end, e.correlation_id()))
            elif e.correlation_id():
                calls[e.correlation_id()] = s
        if not device:
            return []
        device.sort(key=lambda r: r[1])
        # as DeviceTrace: the first device event is the marker
        offset = device[0][1] - self._mark_ns
        if abs(offset) < 5_000_000:
            offset = 0
        mark_call = calls.get(device[0][3])
        if mark_call is not None:
            shift = mark_call - self._mark_ns
            self.launches = [(calls[c] - shift, (e - s) / 1e9)
                             for _, s, e, c in device if c in calls]
        return [(n, s - offset, e - offset) for n, s, e, _ in device]


def launched_seconds(launches: Sequence[Launch],
                     spans: Sequence[Dict[str, Any]]) -> float:
    """Device seconds of the events launched inside any of ``spans``."""
    covered = union([(s["start_ns"], s["end_ns"]) for s in spans])
    starts = [s for s, _ in covered]
    total = 0.0
    for t, seconds in launches:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < covered[i][1]:
            total += seconds
    return total


def launched_ms_per_unit(rec: Dict[str, Any],
                         spans: Sequence[Dict[str, Any]]) -> Optional[float]:
    if not spans or not rec.get("launches") or not rec.get("units"):
        return None
    return 1e3 * launched_seconds(rec["launches"], spans) / rec["units"]


def program_spans(rec: Dict[str, Any], name: str,
                  **attrs: Any) -> List[Dict[str, Any]]:
    """The port's spans ``name`` in the record with the given attributes."""
    return [s for s in rec.get("program_spans") or [] if s["name"] == name
            and all(s.get(k) == v for k, v in attrs.items())]
