"""Flax parameter trees and optax states -> the port's ``state_dict``s.

Takes the JAX package's nested trees of arrays (``TrainState.params`` and
``TrainState.batch_stats``, as numpy) and returns a ``state_dict`` for the
module of the same name in this package.  Mappings:

  * Conv kernel HWIO -> weight OIHW;
  * Dense kernel (in, out) -> weight (out, in);
  * ConvTranspose kernel (kh, kw, in, out) -> ``ConvTranspose2d`` weight
    (in, out, kh, kw), flipped on both spatial axes (``lax.conv_transpose``
    correlates the dilated input with the kernel as stored; torch's
    transposed convolution is the adjoint of a correlation);
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
    (the Flax ``BatchNorm_0`` level is dropped), with
    ``num_batches_tracked`` set to 0.

Transposed-convolution modules are recognised by ``convT`` in their name,
as every one in the JAX zoo is named.

``adam_state_from_optax`` carries an ``optax.adam`` state across the same
way (moments with the parameters' layout transforms), so a JAX run taken
after k steps continues in the port.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _tensor(a: Any) -> torch.Tensor:
    """A float32 tensor owning a C-contiguous copy of ``a``."""
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _module_path(path: Tuple[str, ...]) -> Tuple[Tuple[str, ...], bool]:
    """(torch module path, is_batchnorm) for a Flax leaf path."""
    mods = path[:-1]
    is_bn = bool(mods) and mods[-1].startswith("BatchNorm")
    return (mods[:-1] if is_bn else mods), is_bn


def params_from_flax(params: Mapping, batch_stats: Mapping
                     ) -> Dict[str, torch.Tensor]:
    """Convert Flax ``params`` + ``batch_stats`` trees to a state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        mods, is_bn = _module_path(path)
        prefix = ".".join(mods)
        a = np.asarray(leaf, np.float32)
        name = path[-1]
        if name == "kernel":
            if a.ndim == 4 and "convT" in mods[-1]:
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
            elif a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"unexpected kernel rank at {path}: {a.shape}")
            key = "weight"
        elif name == "scale" and is_bn:
            key = "weight"
        elif name == "bias":
            key = "bias"
        else:
            raise ValueError(f"unmapped Flax parameter {'/'.join(path)}")
        sd[f"{prefix}.{key}"] = _tensor(a)
    for path, leaf in _flatten(batch_stats):
        mods, is_bn = _module_path(path)
        if not is_bn or path[-1] not in ("mean", "var"):
            raise ValueError(f"unmapped Flax batch stat {'/'.join(path)}")
        prefix = ".".join(mods)
        key = "running_mean" if path[-1] == "mean" else "running_var"
        sd[f"{prefix}.{key}"] = _tensor(leaf)
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return sd


def _find_adam_state(opt_state: Any) -> Any:
    """The ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside an optax
    state, which ``optax.adam`` nests in a chain tuple."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _find_adam_state(sub)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state: Any, model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer
                          ) -> Dict[str, Any]:
    """Convert an ``optax.adam`` state into a ``state_dict`` for
    ``optimizer`` (a ``torch.optim.Adam`` over ``model.parameters()``).

    ``mu``/``nu`` are parameter trees: they take the parameters' layout
    transforms (HWIO -> OIHW, Dense transposed, ConvTranspose flipped) and
    become ``exp_avg``/``exp_avg_sq``; ``count`` becomes every parameter's
    ``step``.  The update that follows then equals optax's."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no optax Adam state (count, mu, nu) found")
    mu = params_from_flax(adam.mu, {})
    nu = params_from_flax(adam.nu, {})
    names = [n for n, _ in model.named_parameters()]
    if set(names) != set(mu):
        raise ValueError(f"optax moments cover {sorted(mu)}, the model has "
                         f"{sorted(names)}")
    step = float(np.asarray(adam.count))
    sd = optimizer.state_dict()
    sd["state"] = {i: {"step": torch.tensor(step, dtype=torch.float32),
                       "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                   for i, n in enumerate(names)}
    return sd
