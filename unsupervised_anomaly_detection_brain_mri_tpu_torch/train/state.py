"""Optimizer factory.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/train/state.py`
(``make_optimizer``, ``gan_adam``): the same update rules as the optax
transforms, as ``torch.optim`` optimizers over a parameter list.

  * ADAM: ``torch.optim.Adam(lr, betas, eps=1e-8)``; optax's eps sits
    outside the square root, as torch's does.
  * SGD and MOMENTUM (0.9): ``torch.optim.SGD``; torch's first momentum
    buffer is the first gradient, optax's trace is ``g + 0.9 * 0``.
  * RMS: ``optax.rmsprop(lr, momentum=0.9)`` decays at 0.9, adds eps inside
    the square root and starts its accumulator at 0; ``torch.optim.RMSprop``
    does not, so ``OptaxRMSprop`` writes optax's update out.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import Config, Optimizer


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay, eps, momentum)`` (not centered, no bias
    correction): ``nu = decay * nu + (1 - decay) * g^2``;
    ``u = -lr * g / sqrt(nu + eps)``; with momentum the applied update is
    the trace ``t = u + momentum * t``."""

    def __init__(self, params: Iterable, lr: float, decay: float = 0.9,
                 eps: float = 1e-8, momentum: Optional[float] = None):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, decay, eps = group["lr"], group["decay"], group["eps"]
            momentum = group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    if momentum is not None:
                        state["trace"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(decay).addcmul_(p.grad, p.grad, value=1.0 - decay)
                update = p.grad * torch.rsqrt(nu + eps) * -lr
                if momentum is not None:
                    update = state["trace"].mul_(momentum).add_(update)
                p.add_(update)
        return loss


def make_optimizer(config: Config, params: Iterable,
                   learningrate: Optional[float] = None,
                   beta1: Optional[float] = None,
                   beta2: Optional[float] = None) -> torch.optim.Optimizer:
    """The optimizer ``config.optimizer`` names, over ``params``."""
    lr = learningrate if learningrate is not None else config.learningrate
    b1 = beta1 if beta1 is not None else config.beta1
    b2 = beta2 if beta2 is not None else config.beta2
    opt = config.optimizer
    if opt == Optimizer.ADAM:
        return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8)
    if opt == Optimizer.SGD:
        return torch.optim.SGD(params, lr=lr)
    if opt == Optimizer.MOMENTUM:
        return torch.optim.SGD(params, lr=lr, momentum=0.9)
    if opt == Optimizer.RMSPROP:
        return OptaxRMSprop(params, lr, momentum=0.9)
    raise ValueError(f"unknown optimizer {opt}")


def gan_adam(config: Config, params: Iterable) -> torch.optim.Optimizer:
    """Adam(beta1=0.5, beta2=0.9) of every adversarial optimizer."""
    return torch.optim.Adam(params, lr=config.learningrate, betas=(0.5, 0.9),
                            eps=1e-8)
