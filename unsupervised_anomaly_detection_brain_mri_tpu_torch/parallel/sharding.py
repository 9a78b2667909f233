"""Tensor parallelism: column-parallel layers over the mesh's model axis.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/parallel/
sharding.py`.  There GSPMD shards every ``kernel`` whose last (out) axis
divides by the model axis, keeps biases, norms, batch statistics and any
indivisible kernel replicated, lets optimizer moments follow their
parameter when their shapes match, and inserts the collectives.  torch has
no GSPMD, so the port shards explicitly, by the same rule:

  * ``shard_model`` marks each ``Conv2d``, ``ConvTranspose2d`` and
    ``Linear`` of ``models/layers.py`` whose out-channel count divides by
    ``n_model`` and cuts its weight to this rank's rows of the out axis
    (dim 0 of a ``Conv2d`` or ``Linear`` weight, dim 1 of a
    ``ConvTranspose2d`` weight, which is (in, out, kh, kw)); its forward
    then computes its shard of the output without the bias, gathers the
    model group's shards and adds the replicated bias
    (``layers._ColumnParallel``);
  * ``shard_params`` cuts a whole ``state_dict`` to this rank's shards and
    ``gather_params`` puts the shards back together;
  * ``shard_like_params`` and ``gather_like_params`` do the same to an
    optimizer's ``state_dict``: a moment (``exp_avg``, ``exp_avg_sq``)
    follows its parameter when its shape matches the parameter's, and
    anything else (``step``, a moment of another shape) stays replicated.

A checkpoint always holds whole tensors (``train/base.py`` gathers before
the writer saves and cuts after loading), so a tensor-parallel run's
checkpoint loads in one process and the reverse.  The numbers equal the
unsharded layer's up to the order in which the bias is added.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    Linear,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.mesh import (
    MeshContext,
)

COLUMN_PARALLEL = (Conv2d, ConvTranspose2d, Linear)


def _out_dim(module: nn.Module) -> int:
    return 1 if isinstance(module, ConvTranspose2d) else 0


def shard_model(model: nn.Module, ctx: MeshContext) -> nn.Module:
    """Make every layer of ``COLUMN_PARALLEL`` whose out-channel count
    divides by ``ctx.n_model`` column parallel, in place: its weight
    becomes this rank's rows of the out axis.  A no-op without a model
    axis."""
    if not ctx.tensor_parallel:
        return model
    for module in model.modules():
        if not isinstance(module, COLUMN_PARALLEL):
            continue
        dim = _out_dim(module)
        if module.weight.shape[dim] % ctx.n_model:
            continue
        module.tp, module.tp_dim = ctx, dim
        module.weight = nn.Parameter(cut(ctx, module.weight.detach(), dim))
    return model


def sharded(model: nn.Module) -> Dict[str, Tuple[int, MeshContext]]:
    """``{weight name: (out axis, mesh)}`` of the model's column-parallel
    layers."""
    return {f"{name}.weight" if name else "weight": (module.tp_dim,
                                                     module.tp)
            for name, module in model.named_modules()
            if getattr(module, "tp", None) is not None}


def cut(ctx: MeshContext, t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's rows of ``t`` along ``dim``."""
    per = t.shape[dim] // ctx.n_model
    return t.narrow(dim, ctx.model_index * per, per).clone()


def _gather(ctx: MeshContext, t: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's shards of ``t`` concatenated along ``dim``."""
    y = t.detach().contiguous()
    parts = [torch.empty_like(y) for _ in range(ctx.n_model)]
    dist.all_gather(parts, y, group=ctx.model_group)
    return torch.cat(parts, dim)


def whole_weight_shape(module: nn.Module) -> torch.Size:
    """The shape of ``module``'s weight before sharding."""
    shape = list(module.weight.shape)
    if getattr(module, "tp", None) is not None:
        shape[module.tp_dim] *= module.tp.n_model
    return torch.Size(shape)


def count_full_params(model: nn.Module) -> int:
    """The number of parameters of the unsharded model."""
    return sum(p.numel() for p in model.parameters()) + sum(
        whole_weight_shape(m).numel() - m.weight.numel()
        for m in model.modules() if getattr(m, "tp", None) is not None)


def shard_params(ctx: MeshContext, model: nn.Module,
                 state: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """A whole ``state_dict`` cut to this rank's shards of ``model``'s
    column-parallel weights; every other entry as it is."""
    specs = sharded(model)
    return {k: cut(ctx, v, specs[k][0]) if k in specs else v
            for k, v in state.items()}


def gather_params(ctx: MeshContext, model: nn.Module,
                  state: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """The whole tensors of a sharded ``state_dict`` (collective over the
    model group: every rank calls it)."""
    specs = sharded(model)
    return {k: _gather(ctx, v, specs[k][0]) if k in specs else v
            for k, v in state.items()}


def _moments(model: nn.Module, optimizer: torch.optim.Optimizer,
             state: Dict[str, Any]
             ) -> Iterator[Tuple[Dict[str, Any], str, Optional[Tuple]]]:
    """(per-parameter state, key, (out axis, local shape) of a sharded
    parameter or None) of every tensor entry of an optimizer
    ``state_dict``, whose ``state`` is keyed by the parameter's index in
    ``optimizer.param_groups``."""
    names = {id(p): n for n, p in model.named_parameters()}
    order = [names[id(p)] for group in optimizer.param_groups
             for p in group["params"]]
    specs = sharded(model)
    params = dict(model.named_parameters())
    for index, entry in state["state"].items():
        name = order[int(index)]
        spec = (specs[name][0], params[name].shape) if name in specs \
            else None
        for key, value in entry.items():
            if isinstance(value, torch.Tensor):
                yield entry, key, spec


def _copy(state: Dict[str, Any]) -> Dict[str, Any]:
    """An optimizer ``state_dict`` whose per-parameter dicts are new
    (``Optimizer.state_dict`` hands out the live ones)."""
    return {**state, "state": {i: dict(entry)
                               for i, entry in state["state"].items()}}


def shard_like_params(ctx: MeshContext, model: nn.Module,
                      optimizer: torch.optim.Optimizer,
                      state: Dict[str, Any]) -> Dict[str, Any]:
    """An optimizer ``state_dict`` of whole tensors cut like the
    parameters: a sharded parameter's moment whose shape equals the whole
    parameter's is cut to this rank's rows, and every other entry stays
    replicated."""
    state = _copy(state)
    for entry, key, spec in _moments(model, optimizer, state):
        if spec is None:
            continue
        dim, local = spec
        whole = list(local)
        whole[dim] *= ctx.n_model
        if tuple(entry[key].shape) == tuple(whole):
            entry[key] = cut(ctx, entry[key], dim)
    return state


def gather_like_params(ctx: MeshContext, model: nn.Module,
                       optimizer: torch.optim.Optimizer,
                       state: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``shard_like_params`` (collective over the model
    group): a moment shaped like its sharded parameter is gathered into
    the whole tensor."""
    state = _copy(state)
    for entry, key, spec in _moments(model, optimizer, state):
        if spec is not None and tuple(entry[key].shape) == tuple(spec[1]):
            entry[key] = _gather(ctx, entry[key], spec[0])
    return state
