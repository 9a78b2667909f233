"""Process-group bring-up and the collectives of the data-parallel layer.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/parallel/
collectives.py`.  ``initialize_multihost`` maps the JAX package's
``jax.distributed.initialize`` arguments onto ``init_process_group``;
``psum_mean``, ``all_gather_batch`` and the ring shifts ``shift_right`` and
``shift_left`` are the JAX package's ``psum``/``all_gather``/``ppermute``
helpers over the default process group, built on ``all_reduce`` and
``all_gather``: a ring shift is an ``all_gather`` from which each rank keeps
its neighbour's part, the one form that both backends take for tensors on
either device.

Each function takes the ``MeshContext`` first and works over its data
group (the ranks of one model index, ordered by data index); on a one-rank
data axis it returns its input without a collective.  NCCL takes CUDA
tensors in every collective.  gloo takes CPU tensors, and CUDA tensors in
``all_reduce``, ``all_gather`` and ``broadcast`` (checked on an H100 by
``chip_smoke.py`` phase 9i, whose two ranks share one card over gloo).
These collectives are not differentiable: ``models/layers.py::Norm`` wraps
its own in an ``autograd.Function``.

The tensor-parallel layers' pair works over the model group and is
differentiable: ``copy_to_model`` (identity forward; the input gradient is
summed over the model group, since each shard contributes its part) and
``gather_from_model`` (the shards' outputs concatenated along a dimension
in model-index order; backward keeps this rank's slice of the replicated
output gradient).  Each backward is itself the other pair's forward
(sum <-> identity, slice <-> gather), so a gradient taken with
``create_graph`` (the critics' gradient penalty) differentiates again
correctly.
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.mesh import (
    MeshContext,
    local_rank,
)

# how long an explicit bring-up waits for its peers, and every collective
# for the slowest rank, before it raises
DEFAULT_TIMEOUT_S = 300.0
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

Tensor = torch.Tensor


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: str = "nccl",
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group.

    ``num_processes`` <= 1 is a no-op, and so is a second call.  With no
    arguments the group comes from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; a world of one is
    joined too); without that environment the call prints one line and
    the process runs alone.  Explicit arguments name the coordinator as
    ``host:port`` (or an ``init_method`` URL such as ``file://...``), the
    world size and this process's rank; if the group cannot form within
    ``timeout_s`` the call raises: it never carries on as a single
    process.  ``backend`` is ``nccl`` for ranks on CUDA devices, ``gloo``
    for ranks on the CPU; it is never chosen for the caller."""
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        return
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    timeout = datetime.timedelta(seconds=timeout_s)
    if not explicit:
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            print(f"[multihost] single-process run (no torchrun "
                  f"environment: {', '.join(missing)} unset)")
            return
        rank = int(os.environ["RANK"])
        _set_device(backend, rank)
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("an explicit multi-process bring-up needs "
                         "coordinator_address, num_processes and process_id")
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    _set_device(backend, int(process_id))
    dist.init_process_group(backend, init_method=init,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)


def _set_device(backend: str, rank: int) -> None:
    """NCCL works on the current CUDA device: make it this rank's."""
    if backend == "nccl":
        torch.cuda.set_device(local_rank(rank))


def psum(ctx: MeshContext, x: Tensor) -> Tensor:
    """Sum over the data group."""
    if not ctx.parallel:
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=ctx.data_group)
    return y


def psum_mean(ctx: MeshContext, x: Tensor) -> Tensor:
    """Mean over the data group (gradient and metric averaging)."""
    if not ctx.parallel:
        return x
    return psum(ctx, x) / ctx.n_data


def all_gather_batch(ctx: MeshContext, x: Tensor) -> Tensor:
    """Every rank's ``x`` concatenated along axis 0 in rank order (the
    shards of a batch back into the batch), on every rank."""
    if not ctx.parallel:
        return x
    y = x.detach().contiguous()
    parts = [torch.empty_like(y) for _ in range(ctx.n_data)]
    dist.all_gather(parts, y, group=ctx.data_group)
    return torch.cat(parts)


def _shift(ctx: MeshContext, x: Tensor, step: int) -> Tensor:
    """Data index i receives data index (i - step)'s ``x``."""
    if not ctx.parallel:
        return x
    return all_gather_batch(ctx, x[None])[(ctx.data_index - step)
                                          % ctx.n_data]


def shift_right(ctx: MeshContext, x: Tensor) -> Tensor:
    """Ring shift: each rank receives its LEFT neighbour's x
    (wraparound)."""
    return _shift(ctx, x, 1)


def shift_left(ctx: MeshContext, x: Tensor) -> Tensor:
    """Ring shift: each rank receives its RIGHT neighbour's x."""
    return _shift(ctx, x, -1)


def broadcast_(ctx: MeshContext, t: Tensor, src: int = 0) -> Tensor:
    """Overwrite ``t`` in place with data index ``src``'s."""
    if ctx.parallel:
        dist.broadcast(t.data, ctx.data_rank(src), group=ctx.data_group)
    return t


def psum_mean_grads(ctx: MeshContext, params: Iterable[Tensor]) -> None:
    """Replace each parameter's ``.grad`` by its mean over the data group,
    in one flat buffer.  Parameters without a gradient are left out (every
    rank runs the same graph, so they are the same on every rank)."""
    if not ctx.parallel:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = psum_mean(ctx, torch.cat([g.reshape(-1) for g in grads]))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the model
    group."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _ReduceFromModel.apply(grad, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward; identity backward (the output is
    used alike on every rank of the group)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=mesh.model_group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _CopyToModel.apply(grad, ctx.mesh), None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along ``dim`` over the model group; backward keeps this
    rank's slice."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        y = x.contiguous()
        parts = [torch.empty_like(y) for _ in range(mesh.n_model)]
        dist.all_gather(parts, y, group=mesh.model_group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return _SplitToModel.apply(grad, ctx.mesh, ctx.dim), None, None


class _SplitToModel(torch.autograd.Function):
    """This rank's slice along ``dim`` forward; all-gather backward."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        per = x.shape[dim] // mesh.n_model
        return x.narrow(dim, mesh.model_index * per, per).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _GatherFromModel.apply(grad, ctx.mesh, ctx.dim), None, None


def copy_to_model(ctx: MeshContext, x: Tensor) -> Tensor:
    """A column-parallel layer's input: ``x`` itself, whose gradient is
    summed over the model group."""
    return _CopyToModel.apply(x, ctx)


def gather_from_model(ctx: MeshContext, x: Tensor, dim: int) -> Tensor:
    """A column-parallel layer's output: the model group's shards ``x``
    concatenated along ``dim`` in model-index order."""
    return _GatherFromModel.apply(x, ctx, dim)
