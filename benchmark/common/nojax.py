"""The check that no JAX is loaded in the process that prints a result.

The port's package name begins with the JAX package's, so modules are
compared by their whole top-level name (the part before the first dot),
never by prefix.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax",
                       "unsupervised_anomaly_detection_brain_mri_tpu"})


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: every
    loaded module), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & FORBIDDEN)


def check_no_jax() -> None:
    """Raise, naming what was found, if a forbidden module is loaded."""
    found = forbidden_loaded()
    if found:
        raise RuntimeError("modules of JAX or of the JAX package are loaded "
                           f"in the measured process: {', '.join(found)}")
