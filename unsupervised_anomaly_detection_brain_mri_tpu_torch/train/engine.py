"""Epoch engine: batch order, early stopping, and the epoch loop.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/train/
engine.py`.  ``epoch_indices`` and ``early_stopping_update`` are the JAX
module's numpy functions, copied (that module imports JAX), so both
packages draw the same batches.  ``run_epoch`` takes the place of the
jitted ``lax.scan`` of ``EpochCompiler``: the slice pool is a device
tensor, the epoch's (num_batches, batchsize) index matrix is uploaded once,
each step gathers its batch with ``index_select``, and the per-batch scalar
metrics are summed on the device, so an epoch syncs with the host once
(plus once per logged batch; ``utils/trace.py`` counts them and spans the
upload and each step).  ``tb_every``/``tb_hook`` take the place of
``EpochCompiler``'s mid-epoch TensorBoard callback: the hook gets every
``tb_every``-th global step's number, metrics and batch.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import trace

Batch = Dict[str, torch.Tensor]
StepFn = Callable[[Batch], Dict[str, torch.Tensor]]


def epoch_indices(rng: np.random.Generator, n: int, batchsize: int,
                  shuffle: bool = True) -> np.ndarray:
    """Per-epoch (num_batches, batchsize) int32 index matrix:
    ``n // batchsize`` batches of a permutation (or of ``arange`` without
    shuffling); the remainder slices are dropped."""
    num_batches = n // batchsize
    idx = rng.permutation(n) if shuffle else np.arange(n)
    idx = idx[: num_batches * batchsize]
    return idx.reshape(num_batches, batchsize).astype(np.int32)


def early_stopping_update(val_loss: float, best_cost: float,
                          last_improvement: int, patience: int = 5
                          ) -> Tuple[float, int, bool]:
    """(best_cost, epochs without improvement, stop) after one VAL loss."""
    if val_loss < best_cost:
        return val_loss, 0, False
    last_improvement += 1
    return best_cost, last_improvement, last_improvement >= patience


def run_epoch(step: StepFn, pool: Batch, idxs: np.ndarray,
              sums: Optional[Dict[str, torch.Tensor]] = None,
              log_every_n: int = 0, first_step: int = 0,
              tb_every: int = 0, tb_hook: Optional[Callable] = None
              ) -> Dict[str, torch.Tensor]:
    """Run ``step`` on each batch ``pool[idxs[b]]``, in order.

    Returns the per-metric sums over the batches, as device tensors, added
    to ``sums`` when given (a streamed epoch threads one running sum
    through its chunks, so its sums equal the resident pool's bit for
    bit).  With ``log_every_n`` > 0, global steps ``first_step + b + 1``
    that are multiples of it print their metrics (one host sync each); with
    ``tb_every`` > 0 those that are multiples of it call
    ``tb_hook(step, metrics, batch)``."""
    device = next(iter(pool.values())).device
    with trace.span("train.indices"):
        rows = torch.as_tensor(np.asarray(idxs), dtype=torch.int64).to(device)
        trace.count("host_syncs")
    for b in range(rows.shape[0]):
        step_no = first_step + b + 1
        with trace.span("train.step", step=step_no):
            batch = {k: v.index_select(0, rows[b]) for k, v in pool.items()}
            metrics = step(batch)
            sums = (dict(metrics) if sums is None
                    else {k: sums[k] + v for k, v in metrics.items()})
        if log_every_n > 0 and step_no % log_every_n == 0:
            trace.count("host_syncs", len(metrics))
            msg = " ".join(f"{k}: {float(v):.6f}"
                           for k, v in sorted(metrics.items()))
            print(f"  batch [{step_no:6d}] {msg}", flush=True)
        if tb_every > 0 and tb_hook is not None \
                and step_no % tb_every == 0:
            tb_hook(step_no, metrics, batch)
    return sums
