"""The (data, model) mesh: one process per device in a
``torch.distributed`` process group.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/parallel/
mesh.py`.  The JAX package builds a ``(data, model)`` device mesh inside one
program and lets XLA insert the collectives; here each rank is a process
(started by ``torchrun``, or by ``collectives.initialize_multihost`` with
explicit arguments) that owns one device.  World rank r sits at data index
``r // n_model`` and model index ``r % n_model``: the row-major
``(data, model)`` reshape of the JAX package's device list.

  * The ranks of one model index form a *data group*: each takes its
    contiguous share of every global batch by its data index, and they
    average gradients and metrics, share BatchNorm statistics and exchange
    the median's halos.
  * The ranks of one data index form a *model group*: they see the same
    rows, and each holds its shard of the column-parallel layers
    (``parallel/sharding.py``); their activations are replicated after
    each layer's all-gather.

Every rank creates every group, in the same order (``torch.distributed.
new_group`` is collective over the world).  With ``n_model`` 1 the data
group is the default group.  A one-rank mesh is valid and issues no
collective, so ``--mesh-data 1`` runs exactly the one-process path.
``pad_batch_to`` is the JAX module's numpy function, copied.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
    MeshConfig,
)

@dataclasses.dataclass
class MeshContext:
    """This rank's place in the mesh: its world ``rank``, the mesh's
    ``n_data`` x ``n_model`` shape, its device, its ``data_index`` and
    ``model_index``, and the process groups it is in (``None`` for the
    default group; unused on a one-rank axis)."""

    rank: int
    n_data: int
    device: torch.device
    n_model: int = 1
    data_index: Optional[int] = None
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None

    def __post_init__(self) -> None:
        if self.data_index is None:
            self.data_index = self.rank // self.n_model

    @property
    def parallel(self) -> bool:
        """True when the data axis has more than one rank, i.e. the data
        group's collectives run."""
        return self.n_data > 1

    @property
    def tensor_parallel(self) -> bool:
        """True when the model axis has more than one rank."""
        return self.n_model > 1

    @property
    def is_writer(self) -> bool:
        """World rank 0 writes the files (checkpoints, history,
        artifacts, TensorBoard events)."""
        return self.rank == 0

    @property
    def backend(self) -> Optional[str]:
        return (dist.get_backend() if self.parallel or self.tensor_parallel
                else None)

    def data_rank(self, data_index: int) -> int:
        """The world rank of ``data_index`` in this rank's data group."""
        return data_index * self.n_model + self.model_index

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n`` rows, by
        its data index."""
        if n % self.n_data:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{self.n_data} ranks")
        per = n // self.n_data
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def shard_batch(self, batch: Any) -> Any:
        """This rank's rows of a global batch (a tensor, an array or a dict
        of them), on the rank's device."""
        if isinstance(batch, dict):
            return {k: self.shard_batch(v) for k, v in batch.items()}
        return torch.as_tensor(batch)[self.rows(len(batch))].to(self.device)

    def replicate(self, module: torch.nn.Module) -> torch.nn.Module:
        """Broadcast ``module``'s parameters and buffers from data index 0
        over the data group, in place (a model group's shards differ, so
        each is broadcast within its own data group)."""
        if self.parallel:
            from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.collectives import (
                broadcast_,
            )

            with torch.no_grad():
                for t in list(module.parameters()) + list(module.buffers()):
                    broadcast_(self, t)
        return module

    def barrier(self) -> None:
        """Wait for every rank of the world."""
        if not (self.parallel or self.tensor_parallel):
            return
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def local_rank(rank: int = 0) -> int:
    """The rank on this host: ``torchrun``'s ``LOCAL_RANK``, else
    ``rank`` (one host)."""
    return int(os.environ.get("LOCAL_RANK", rank))


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence[Any]] = None) -> MeshContext:
    """The ``(data, model)`` mesh of the initialised process group (or of
    this process alone when none is initialised).

    ``config.model`` is the model axis (tensor parallelism; 1 by default)
    and ``config.data`` the data axis (``None``: the world size over
    ``model``); their product must equal the world size.  With
    ``model`` > 1 every rank creates the data and model groups, in the
    same order.  ``devices`` lists a device per local rank (two ranks may
    share one); the default puts local rank r on ``cuda:r``, which needs a
    card."""
    config = config or MeshConfig()
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    n_model = max(1, int(config.model))
    if world % n_model:
        raise ValueError(f"mesh model={n_model} does not divide the "
                         f"process group's {world} rank(s)")
    n_data = world // n_model if config.data is None else int(config.data)
    if n_data * n_model != world:
        raise ValueError(f"mesh data={n_data} x model={n_model} but the "
                         f"process group has {world} rank(s); start one "
                         "process per rank (torchrun --nproc_per_node N)")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "to run the ranks on the CPU")
        device = torch.device("cuda", local_rank(rank))
    else:
        devices = list(devices)
        if local_rank(rank) >= len(devices):
            raise ValueError(f"local rank {local_rank(rank)} but only "
                             f"{len(devices)} device(s) given")
        device = torch.device(devices[local_rank(rank)])
    data_group = model_group = None
    if n_model > 1:
        # new_group is collective over the world: every rank creates every
        # group, data groups first, each in index order
        for m in range(n_model):
            group = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == rank % n_model:
                data_group = group
        for d in range(n_data):
            group = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == rank // n_model:
                model_group = group
    return MeshContext(rank=rank, n_data=n_data, device=device,
                       n_model=n_model, data_index=rank // n_model,
                       model_index=rank % n_model, data_group=data_group,
                       model_group=model_group)


def global_batch_from_local(ctx: MeshContext, local_batch: Any) -> Any:
    """The multi-host input path: each process passes its own rows (a
    tensor, an array or a dict of them) and gets them back as its shard on
    its device."""
    if isinstance(local_batch, dict):
        return {k: global_batch_from_local(ctx, v)
                for k, v in local_batch.items()}
    return torch.as_tensor(np.asarray(local_batch)).to(ctx.device)


def pad_batch_to(batch: np.ndarray, multiple: int) -> np.ndarray:
    """Pad the batch axis up to a multiple (for even sharding).

    The pad can exceed the batch size (e.g. 3 rows on an 8-way data mesh
    needs 5 pad rows), so the source is tiled as many times as needed."""
    b = batch.shape[0]
    rem = b % multiple
    if rem == 0:
        return batch
    pad = multiple - rem
    reps = -(-pad // b)  # ceil: enough copies to cover the pad
    filler = np.concatenate([batch] * reps, axis=0)[:pad]
    return np.concatenate([batch, filler], axis=0)
