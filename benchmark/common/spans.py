"""Spans recorded by the harness around the calls into the port's layers.

The port has no spans of its own, so the traced run wraps names it calls
(``wrap``): each call becomes a span with its name, start and end on the
host's clock (``time.time_ns``, the clock the profiler's trace uses) and
the span that was open when it began.  With ``sync`` the wrapper waits for
the device at both ends, so a span covers its layer's device work too;
that is for the traced run only.  Spans are kept in memory.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int = 0
    parent: Optional[int] = None  # index of the enclosing span
    attrs: Dict[str, Any] = field(default_factory=dict)


class Spans:
    """A recorder: ``with spans.span(name):`` or ``spans.wrap(obj, attr,
    name)``; ``restore()`` puts every wrapped attribute back."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.items: List[Span] = []
        self._open: List[int] = []
        self._sync = sync
        self._wrapped: List[Tuple[Any, str, Any]] = []

    def begin(self, name: str, **attrs: Any) -> int:
        if self._sync is not None:
            self._sync()
        parent = self._open[-1] if self._open else None
        self.items.append(Span(name, time.time_ns(), parent=parent,
                               attrs=dict(attrs)))
        self._open.append(len(self.items) - 1)
        return self._open[-1]

    def end(self, index: int) -> None:
        if self._sync is not None:
            self._sync()
        self.items[index].end_ns = time.time_ns()
        self._open.remove(index)

    def span(self, name: str, **attrs: Any):
        spans = self

        class _Ctx:
            def __enter__(self):
                self.i = spans.begin(name, **attrs)
                return spans.items[self.i]

            def __exit__(self, *exc):
                spans.end(self.i)
                return False

        return _Ctx()

    def wrap(self, obj: Any, attr: str, name: str,
             attrs_of: Optional[Callable[..., Dict[str, Any]]] = None
             ) -> None:
        """Replace ``obj.attr`` by a wrapper that records a span ``name``
        per call (``attrs_of(*args, **kwargs)`` adds attributes)."""
        original = getattr(obj, attr)

        @functools.wraps(original)
        def wrapper(*args, **kwargs):
            attrs = attrs_of(*args, **kwargs) if attrs_of else {}
            i = self.begin(name, **attrs)
            try:
                return original(*args, **kwargs)
            finally:
                self.end(i)

        self._wrapped.append((obj, attr, original))
        setattr(obj, attr, wrapper)

    def restore(self) -> None:
        for obj, attr, original in reversed(self._wrapped):
            setattr(obj, attr, original)
        self._wrapped.clear()

    def to_records(self) -> List[Dict[str, Any]]:
        return [{"name": s.name, "start_ns": s.start_ns, "end_ns": s.end_ns,
                 "parent": s.parent, **s.attrs} for s in self.items]
