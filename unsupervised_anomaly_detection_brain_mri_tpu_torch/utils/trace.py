"""Spans and counters of the port's own layers, kept in memory.

    with recording() as rec:
        trainer._run_epoch("TRAIN", pool, idxs)
    rec.spans()      # [{"name", "start_ns", "end_ns", "parent", **attrs}]
    rec.counters()   # {"host_syncs": 1}

The port opens ``span(name, **attrs)`` at the boundaries of its layers and
calls ``count(name, n)`` where the work happens.  Off (the default, no
recording open), ``span`` tests one module global and returns one shared
no-op context, and ``count`` tests it and returns: no lock, no clock
read, no ``synchronize``, nothing kept.

On, a span records its name, start and end on ``time.time_ns`` (the clock
a ``torch.profiler`` trace converts its device events to), the index of the
enclosing span (``parent``, None at the top) and its attributes.  A span
never waits for the device: it times the host's own time in its layer,
with the device work it enqueues running on behind it.  With
``recording(annotate=True)`` each span also opens a
``torch.profiler.record_function`` range of its name, so a profile names
the spans beside the kernels they launch; without it (the default) the
recording adds no event to a profile.  Spans are opened from one thread;
one recording is open at a time.

Names are dotted by layer (``train.*``, ``serve.*``).  An adversarial
trainer's step (``train/gan.py``) is a sequence of ``train.substep`` spans,
one an update of one parameter group (attribute ``group``: ``gen``,
``disc``, ``enc``, ``ae`` or ``vae``), each holding ``train.forward`` (the
forward and the loss), for a critic ``train.penalty`` (the critic on the
interpolate and its input gradient taken with ``create_graph``), then
``train.backward`` (the group's ``autograd.grad``, for a critic the double
backward through the penalty) and ``train.optimizer`` (the zero fill, the
mesh's gradient mean and the step).  Counters:

  * ``critic_updates``: the critic substeps (``group`` ``disc``) of the
    adversarial trainers: 5 a ``fAnoGAN`` WGAN step, 0 in its encoder
    phase;
  * ``host_syncs``: the points where the host waits for a CUDA device (a
    pageable host-to-device copy, a copy to the host, a tensor read as a
    Python number, a library call that reads a result back) in an epoch
    (``BaseTrainer._run_epoch``), ``fit``'s read-back of an epoch's means
    and ``detect``.  They are counted on every device, the CPU's too.
    Checkpoints, TensorBoard and ``evaluate()`` are not counted;
  * ``cc_rounds``: the rounds of ``ops/postprocess.py::
    connected_components_3d_plain``, the propagation that labels a CPU
    tensor (one convergence test each);
  * ``cc_kernel``: the calls labelled by ``ops/ccl.py``'s kernel chain,
    which labels a CUDA tensor with no round and no sync;
  * ``median_kernel``: the launches of ``ops/median.py``'s 5^3 median
    kernel, which filters a CUDA tensor;
  * ``stem_dgrad_kernel``: the launches of ``ops/stem_dgrad.py``'s kernel,
    the input gradient of the encoder's 1-channel stem on a CUDA tensor
    (one a restoration step);
  * ``serve.requests``: the requests ``detect`` served (the ``request``
    attribute of each ``serve.request`` span is its running total).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["Recording", "count", "recording", "span"]


class Recording:
    """The spans and counters of one ``recording()``."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        # [name, start_ns, end_ns, parent, attrs]
        self._items: List[list] = []
        self._open: List[int] = []
        self._counters: Dict[str, int] = {}

    def spans(self) -> List[Dict[str, Any]]:
        """Every span in the order begun, as
        ``{"name", "start_ns", "end_ns", "parent", **attrs}``."""
        return [{"name": n, "start_ns": s, "end_ns": e, "parent": p, **a}
                for n, s, e, p, a in self._items]

    def counters(self) -> Dict[str, int]:
        return dict(self._counters)


class _Noop:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> bool:
        return False


_NOOP = _Noop()
_ACTIVE: Optional[Recording] = None


class _Span:
    __slots__ = ("_rec", "_name", "_attrs", "_index", "_range")

    def __init__(self, rec: Recording, name: str, attrs: Dict[str, Any]):
        self._rec, self._name, self._attrs = rec, name, attrs
        self._range = None

    def __enter__(self) -> None:
        rec = self._rec
        if rec.annotate:
            import torch

            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()
        self._index = len(rec._items)
        rec._items.append([self._name, time.time_ns(), 0,
                           rec._open[-1] if rec._open else None,
                           self._attrs])
        rec._open.append(self._index)

    def __exit__(self, *exc: Any) -> bool:
        rec = self._rec
        rec._items[self._index][2] = time.time_ns()
        rec._open.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str, **attrs: Any):
    """A context that records a span ``name`` while a recording is open,
    and the shared no-op context otherwise."""
    rec = _ACTIVE
    if rec is None:
        return _NOOP
    return _Span(rec, name, attrs)


def count(name: str, n: int = 1) -> Optional[int]:
    """Add ``n`` to the counter ``name`` while a recording is open and
    return its total; None otherwise."""
    rec = _ACTIVE
    if rec is None:
        return None
    total = rec._counters.get(name, 0) + n
    rec._counters[name] = total
    return total


@contextmanager
def recording(annotate: bool = False) -> Iterator[Recording]:
    """Record the port's spans and counters over the block.  Raises where
    a recording is already open."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a recording is already open")
    rec = _ACTIVE = Recording(annotate)
    try:
        yield rec
    finally:
        _ACTIVE = None
