"""FLOPs of a call, counted from what it dispatches.

A copy of ``bench_torch.py::count_flops``: ``torch.utils.flop_counter``'s
formula of every dispatched operator that has one (convolutions and matrix
products, forward and backward, double backwards included), added up by a
dispatch mode, since ``FlopCounterMode``'s module hooks refuse
``autograd.grad`` of a gradient.  The harness counts the plain reference's
work, not the port's, so that a port that computes more does not read as
busier.
"""

from __future__ import annotations

from typing import Any, Callable

from torch.utils._python_dispatch import TorchDispatchMode


class _FlopCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = self.registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def count_flops(fn: Callable, *args: Any, **kwargs: Any) -> int:
    """The FLOPs of ``fn(*args, **kwargs)``."""
    with _FlopCounter() as counter:
        fn(*args, **kwargs)
    return int(counter.total)
