"""Data-parallel mesh: one process per device in a ``torch.distributed``
process group.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/parallel/
mesh.py`.  The JAX package builds a ``(data, model)`` device mesh inside one
program and lets XLA insert the collectives; here each rank is a process
(started by ``torchrun``, or by ``collectives.initialize_multihost`` with
explicit arguments) that owns one device, holds the whole model, and takes
its contiguous share of every global batch.  The ``data`` axis is the
process group; the ``model`` axis (tensor parallelism) is not ported yet
and ``make_mesh`` refuses ``model > 1``.

A one-rank mesh is valid and issues no collective, so ``--mesh-data 1``
runs exactly the one-process path.  ``pad_batch_to`` is the JAX module's
numpy function, copied.
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

TENSOR_PARALLEL_TODO = ("tensor parallelism (MeshConfig.model > 1) is not "
                        "ported yet: ROADMAP.md queue item 5")


@dataclasses.dataclass
class MeshContext:
    """This rank's place in the data-parallel group, which is the default
    process group (or this process alone): its rank, the group's size
    ``n_data`` and the rank's device."""

    rank: int
    n_data: int
    device: torch.device
    n_model: int = 1

    @property
    def parallel(self) -> bool:
        """True when there is more than one rank, i.e. collectives run."""
        return self.n_data > 1

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes the files (checkpoints, history, artifacts)."""
        return self.rank == 0

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend() if self.parallel else None

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n`` rows."""
        if n % self.n_data:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{self.n_data} ranks")
        per = n // self.n_data
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard_batch(self, batch: Any) -> Any:
        """This rank's rows of a global batch (a tensor, an array or a dict
        of them), on the rank's device."""
        if isinstance(batch, dict):
            return {k: self.shard_batch(v) for k, v in batch.items()}
        return torch.as_tensor(batch)[self.rows(len(batch))].to(self.device)

    def replicate(self, module: torch.nn.Module) -> torch.nn.Module:
        """Broadcast ``module``'s parameters and buffers from rank 0, in
        place."""
        if self.parallel:
            from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.collectives import (
                broadcast_,
            )

            with torch.no_grad():
                for t in list(module.parameters()) + list(module.buffers()):
                    broadcast_(self, t)
        return module

    def barrier(self) -> None:
        if not self.parallel:
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
    """The data-parallel mesh of the initialised process group (or of this
    process alone when none is initialised).

    ``config.data`` is the number of ranks (``None``: the whole world) and
    must equal the world size.  ``devices`` lists a device per local rank;
    the default puts local rank r on ``cuda:r``, which needs a card."""
    config = config or MeshConfig()
    if int(config.model) > 1:
        raise NotImplementedError(TENSOR_PARALLEL_TODO)
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    n_data = world if config.data is None else int(config.data)
    if n_data != world:
        raise ValueError(f"mesh data={n_data} but the process group has "
                         f"{world} rank(s); start one process per rank "
                         "(torchrun --nproc_per_node N)")
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
    return MeshContext(rank=rank, n_data=n_data, device=device)


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
