"""The numbers compared with the reference, and their limits.

Training (the first three steps of the window's own call, from the
benchmark's weights and batches):

  * ``loss_rel``: the worst step's |loss - reference loss| / |reference|;
  * ``grad1_rel``: by the worst leaf, the gap between the norms of the
    program's first gradient (Adam's first moment after one step over
    1 - beta1) and the reference's, over the larger of the reference's
    norm of that leaf and of the median leaf;
  * ``update3_rel``: the same of the parameters' change over the three
    steps;
  * ``grad1_dir`` and ``grad1_dir_med``: 1 - cos between the program's
    and the reference's first gradient, of the worst leaf and of the
    median leaf.  A norm gap is a sum of roundings that partly cancel and
    swings from seed to seed; the direction's gap grows as the square of
    the error and parts bfloat16 from float8 steadily.

Both leave out the leaves whose reference gradient is under a thousandth
of the median leaf's: the biases of the convolutions that feed a
BatchNorm, whose gradient is nought but for rounding (the normalisation
takes their effect away) and which Adam moves by round-off alone.

Serving (``kinds/serve.py`` judges each stage on the port's own state):
``rec_rel_l1`` of a single-forward reconstruction, sum |reconstruction -
reference's| / sum |reference's| for the same prepared scan.

A run is correct when every number that has a limit is finite and at most
it; the others are printed beside them as readings.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

Tensor = torch.Tensor
SKIP_GRAD = 1e-3  # leaves under this share of the median leaf's gradient


def _norms(leaves: Dict[str, Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            leaves.items()}


def worst_leaf_gap(program: Dict[str, Tensor], reference: Dict[str, Tensor],
                   keep: Sequence[str] = None) -> float:
    keys = list(reference) if keep is None else list(keep)
    pn, rn = _norms({k: program[k] for k in keys}), \
        _norms({k: reference[k] for k in keys})
    median = float(np.median([rn[k] for k in keys]))
    return max(abs(pn[k] - rn[k]) / max(rn[k], median, 1e-30) for k in keys)


def misalignment(a: Tensor, b: Tensor) -> float:
    """1 - cos(a, b) of two tensors taken as vectors."""
    a, b = a.double().flatten(), b.double().flatten()
    den = float(torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b))
    return 1.0 - float(a @ b) / den if den > 0 else 1.0


def leaf_misalignments(program: Dict[str, Tensor],
                       reference: Dict[str, Tensor], keys: Sequence[str]
                       ) -> List[float]:
    return [misalignment(program[k], reference[k]) for k in keys]


def train_numbers(prog_losses: Sequence[float], ref_losses: Sequence[float],
                  prog_grad1: Dict[str, Tensor], ref_grad1: Dict[str, Tensor],
                  start: Dict[str, Tensor], prog_after: Dict[str, Tensor],
                  ref_after: Dict[str, Tensor]) -> Dict[str, float]:
    loss_rel = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog_losses, ref_losses))
    if len(prog_losses) != len(ref_losses) or not all(
            math.isfinite(p) for p in prog_losses):
        loss_rel = math.inf
    gn = _norms(ref_grad1)
    median = float(np.median(list(gn.values())))
    moved = [k for k in ref_grad1 if gn[k] >= SKIP_GRAD * median]
    dp = {k: prog_after[k] - start[k] for k in moved}
    dr = {k: ref_after[k] - start[k] for k in moved}
    return {"loss_rel": loss_rel,
            "grad1_rel": worst_leaf_gap(prog_grad1, ref_grad1, moved),
            "update3_rel": worst_leaf_gap(dp, dr),
            "grad1_dir": max(leaf_misalignments(prog_grad1, ref_grad1,
                                                moved)),
            "grad1_dir_med": float(np.median(leaf_misalignments(
                prog_grad1, ref_grad1, moved)))}


def rel_l1(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no number for the limits {sorted(missing)}")
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
