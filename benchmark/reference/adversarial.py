"""The reference's adversarial training steps: a model's schedule of
updates, each group with its own Adam (as ``reference/training.py`` writes
Adam out: bias-corrected moments, eps outside the square root, here with
the configuration's ``adam_betas``), from the same initial weights and
batches and the same random streams as the port's first steps.

Every update draws, in the port's order, a prior z ~ N(0, 1) of (B, zDim)
from ``streams["generator"]`` and then alpha ~ U[0, 1) of (B, 1, 1, 1)
from ``streams["gp"]`` (the port draws alpha in every forward, whether
the loss reads it or not); the draws are float32, cast to the batch's
dtype (a float64 reference takes the same numbers).  A parameter of the
group that the loss does not reach gets a zero gradient, so its moments
decay.

``first_gradients`` takes each group's first gradient again at a state
that a program held there (its parameters before the group's first
update), with the same draws: a gradient judged on the program's own
state, clear of where the earlier updates took the two trajectories.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict, List, Tuple

import torch

Tensor = torch.Tensor


def draw(cfg: Dict, x: Tensor, streams: Dict[str, torch.Generator]
         ) -> Tuple[Tensor, Tensor]:
    """One update's prior z and alpha, in the port's order."""
    z = torch.randn((x.shape[0], cfg["zDim"]), generator=streams["generator"],
                    device=x.device).to(x.dtype)
    alpha = torch.rand((x.shape[0], 1, 1, 1), generator=streams["gp"],
                       device=x.device).to(x.dtype)
    return z, alpha


def gradient(model: ModuleType, cfg: Dict, p: Dict[str, Tensor], group: str,
             x: Tensor, z: Tensor, alpha: Tensor, precision: str
             ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """(loss, d loss / d group by leaf) of ``group``'s loss at ``p``."""
    own = model.groups(list(p))[group]
    leaves = dict(p)
    leaves.update({k: p[k].clone().requires_grad_(True) for k in own})
    with torch.enable_grad():
        loss = model.LOSSES[group](leaves, x, z, alpha, cfg, precision)
        grads = torch.autograd.grad(loss, [leaves[k] for k in own],
                                    allow_unused=True)
    return loss.detach(), {
        k: (torch.zeros_like(p[k]) if g is None else g.detach())
        for k, g in zip(own, grads)}


def follow(model: ModuleType, cfg: Dict, params: Dict[str, Tensor],
           batches: List[Tensor], streams: Dict[str, torch.Generator],
           precision: str = "float32") -> Dict[str, object]:
    """Run ``model.schedule(cfg)`` on each batch.  Returns every update's
    (group, loss), each group's first gradient by leaf, the parameters
    before each group's first update (``before``), after the first batch's
    schedule (``params1``) and after the last update (``params``)."""
    p = {k: v.detach().clone() for k, v in params.items()}
    b1, b2 = cfg["adam_betas"]
    lr = cfg["learningrate"]
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    steps: Dict[str, int] = {}
    losses, grad1, before, params1 = [], {}, {}, None
    for x in batches:
        for group in model.schedule(cfg):
            z, alpha = draw(cfg, x, streams)
            before.setdefault(group, dict(p))
            loss, grads = gradient(model, cfg, p, group, x, z, alpha,
                                   precision)
            grad1.setdefault(group, grads)
            steps[group] = t = steps.get(group, 0) + 1
            with torch.no_grad():
                for k, g in grads.items():
                    m[k] = b1 * m[k] + (1.0 - b1) * g
                    v2[k] = b2 * v2[k] + (1.0 - b2) * g * g
                    denom = (v2[k].sqrt() / (1.0 - b2 ** t) ** 0.5) + 1e-8
                    p[k] = p[k] - (lr / (1.0 - b1 ** t)) * m[k] / denom
            losses.append((group, float(loss)))
        if params1 is None:
            params1 = dict(p)
    return {"losses": losses, "grad1": grad1, "before": before,
            "params1": params1, "params": p}


def first_gradients(model: ModuleType, cfg: Dict,
                    states: Dict[str, Dict[str, Tensor]], x: Tensor,
                    streams: Dict[str, torch.Generator],
                    precision: str = "float32") -> Dict[str, Dict[str, Tensor]]:
    """Each group of ``states`` at its first update of the first batch's
    schedule: its gradient at ``states[group]``, with that update's draws
    (every earlier update's draws taken and passed over)."""
    out = {}
    for group in model.schedule(cfg):
        z, alpha = draw(cfg, x, streams)
        if group in states and group not in out:
            out[group] = gradient(model, cfg, states[group], group, x, z,
                                  alpha, precision)[1]
    return out
