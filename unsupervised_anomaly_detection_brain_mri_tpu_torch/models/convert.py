"""Flax parameter trees and optax states -> the port's ``state_dict``s.

Takes the JAX package's nested trees of arrays (``TrainState.params`` and
``TrainState.batch_stats``, as numpy) and the torch module they are for,
and returns a ``state_dict`` for that module (its submodules carry the
Flax names).  Each leaf's layout follows the type of the torch module at
its path:

  * ``nn.Conv2d``: kernel HWIO -> weight OIHW;
  * ``nn.ConvTranspose2d``: kernel (kh, kw, in, out) -> weight (in, out,
    kh, kw), flipped on both spatial axes (``lax.conv_transpose``
    correlates the dilated input with the kernel as stored; torch's
    transposed convolution is the adjoint of a correlation);
  * ``nn.Linear``: kernel (in, out) -> weight (out, in);
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var,
    with ``num_batches_tracked`` set to 0, and LayerNorm scale/bias ->
    weight/bias (the Flax ``BatchNorm_0`` or ``LayerNorm_0`` level of the
    JAX package's ``Norm`` is dropped);
  * a bare parameter of a module (``self.param``, such as the GMVAEs'
    ``z_wc_log_sigma_inv_bias``) -> the torch parameter of the same path.

The module's type, not its name, decides: the ResNets' transposed
convolutions are named ``conv2`` and ``shortcut``, and a 3x3 f -> f kernel
has the same shape in either layout.  The non-parity ``enc_conv_0_s2d``
and ``dec_conv_d2s_head`` are plain ``Conv2d``s, so a JAX ``--tpu-fast``
checkpoint converts the same way.

``adam_state_from_optax`` carries an ``optax.adam`` state across the same
way (moments with the parameters' layout transforms), so a JAX run taken
after k steps continues in the port.  It finds the Adam state inside
``optax.masked`` chains too (the adversarial trainers' per-group
optimizers), and fills the torch optimizer over the group's parameters.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    SpatialLayerNorm,
)

# bare Flax parameters (not kernel, scale or bias of a layer)
BARE_PARAMETERS = ("z_wc_log_sigma_inv_bias",)
# modules whose Flax ``scale`` is the torch ``weight``
NORMS = (nn.BatchNorm2d, SpatialLayerNorm)


def _masked(leaf: Any) -> bool:
    """An ``optax.MaskedNode``: the place of a parameter outside a masked
    optimizer's group (an empty named tuple)."""
    return type(leaf).__name__ == "MaskedNode"


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        elif not _masked(v):
            yield prefix + (str(k),), v


def _tensor(a: Any) -> torch.Tensor:
    """A float32 tensor owning a C-contiguous copy of ``a``."""
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _module_prefix(path: Tuple[str, ...]) -> str:
    """The torch module path of a Flax leaf path: the leaf's name and a
    norm's auto-named ``BatchNorm_0``/``LayerNorm_0`` level dropped."""
    mods = path[:-1]
    if mods and mods[-1].startswith(("BatchNorm", "LayerNorm")):
        mods = mods[:-1]
    return ".".join(mods)


def _kernel(a: np.ndarray, module: nn.Module, path: Tuple[str, ...]
            ) -> np.ndarray:
    """A Flax kernel in the layout of the torch ``module`` it is for."""
    if isinstance(module, nn.ConvTranspose2d) and a.ndim == 4:
        return a[::-1, ::-1].transpose(2, 3, 0, 1)
    if isinstance(module, nn.Conv2d) and a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if isinstance(module, nn.Linear) and a.ndim == 2:
        return a.T
    raise ValueError(f"kernel {'/'.join(path)} of shape {a.shape} for a "
                     f"{type(module).__name__}")


def params_from_flax(params: Mapping, batch_stats: Mapping,
                     model: nn.Module) -> Dict[str, torch.Tensor]:
    """Convert Flax ``params`` + ``batch_stats`` trees to a state_dict for
    ``model``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        prefix = _module_prefix(path)
        a = np.asarray(leaf, np.float32)
        name = path[-1]
        if name in BARE_PARAMETERS:
            sd[".".join(path)] = _tensor(a)
            continue
        try:
            module = model.get_submodule(prefix)
        except AttributeError:
            raise ValueError(f"unmapped Flax parameter {'/'.join(path)}: "
                             f"no module {prefix!r}") from None
        if name == "kernel":
            a, key = _kernel(a, module, path), "weight"
        elif name == "scale" and isinstance(module, NORMS):
            key = "weight"
        elif name == "bias":
            key = "bias"
        else:
            raise ValueError(f"unmapped Flax parameter {'/'.join(path)}")
        sd[f"{prefix}.{key}"] = _tensor(a)
    for path, leaf in _flatten(batch_stats):
        prefix = _module_prefix(path)
        if path[-1] not in ("mean", "var") or not isinstance(
                model.get_submodule(prefix), nn.BatchNorm2d):
            raise ValueError(f"unmapped Flax batch stat {'/'.join(path)}")
        key = "running_mean" if path[-1] == "mean" else "running_var"
        sd[f"{prefix}.{key}"] = _tensor(leaf)
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return sd


def _find_adam_state(opt_state: Any) -> Any:
    """The ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside an optax
    state, which ``optax.adam`` nests in a chain tuple (and
    ``optax.masked`` in a ``MaskedState``, itself a named tuple)."""
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
    ``optimizer`` (a ``torch.optim.Adam`` over parameters of ``model``:
    all of them, or, for a masked optax state, the group it covers).

    ``mu``/``nu`` are parameter trees: they take the parameters' layout
    transforms (HWIO -> OIHW, Dense transposed, ConvTranspose flipped) and
    become ``exp_avg``/``exp_avg_sq``; ``count`` becomes every parameter's
    ``step``.  The update that follows then equals optax's."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no optax Adam state (count, mu, nu) found")
    mu = params_from_flax(adam.mu, {}, model)
    nu = params_from_flax(adam.nu, {}, model)
    by_id = {id(p): n for n, p in model.named_parameters()}
    names = [by_id[id(p)] for group in optimizer.param_groups
             for p in group["params"]]
    if set(names) != set(mu):
        raise ValueError(f"optax moments cover {sorted(mu)}, the optimizer "
                         f"has {sorted(names)}")
    step = float(np.asarray(adam.count))
    sd = optimizer.state_dict()
    sd["state"] = {i: {"step": torch.tensor(step, dtype=torch.float32),
                       "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                   for i, n in enumerate(names)}
    return sd
