"""The reference's training steps: the trainer's loss, its gradients and
``torch.optim.Adam``'s update (as published: bias-corrected moments, eps
outside the square root), written out, from the same initial weights and
batches and the same random streams as the port's first steps."""

from __future__ import annotations

from types import ModuleType
from typing import Dict, List

import torch

from benchmark.reference import backbone as B

Tensor = torch.Tensor


def follow(model: ModuleType, cfg: Dict, params: Dict[str, Tensor],
           buffers: Dict[str, Tensor], batches: List[Tensor],
           streams: Dict[str, torch.Generator], precision: str = "float32"
           ) -> Dict[str, object]:
    """Train ``len(batches)`` steps.  Returns each step's loss, the first
    step's gradient by leaf, and the parameters after the last step."""
    p = {k: v.detach().clone() for k, v in params.items()}
    b = {k: v.detach().clone() for k, v in buffers.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, lr = cfg["beta1"], cfg["beta2"], cfg["learningrate"]
    losses, grad1 = [], None
    for t, x in enumerate(batches, start=1):
        leaves = {k: t_.requires_grad_(True) for k, t_ in
                  ((k, v.detach().clone()) for k, v in p.items())}
        with torch.enable_grad():
            loss = model.train_loss(B.Net(leaves, b, True, precision), x,
                                    cfg, streams)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = {k: (torch.zeros_like(p[k]) if g is None else g.detach())
                 for k, g in zip(leaves, grads)}
        if t == 1:
            grad1 = grads
        with torch.no_grad():
            for k, g in grads.items():
                m[k] = b1 * m[k] + (1.0 - b1) * g
                v2[k] = b2 * v2[k] + (1.0 - b2) * g * g
                denom = (v2[k].sqrt() / (1.0 - b2 ** t) ** 0.5) + 1e-8
                p[k] = p[k] - (lr / (1.0 - b1 ** t)) * m[k] / denom
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad1": grad1, "params": p}
