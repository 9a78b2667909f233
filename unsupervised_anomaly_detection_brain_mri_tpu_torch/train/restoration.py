"""Input-gradient restoration and the gradient anomaly map.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/train/
restoration.py`:

  * ``restore_inputs``: ``restore_steps`` steps of gradient descent on the
    *input*, ``x <- x - lr * d(pixel_loss + tv_lambda * TV(x - x_hat))/dx``;
  * ``gradient_anomaly_map``: the ceVAE's ``L1_vae * |d loss_vae / dx|``.

Each step takes the pixel loss and the TV term from ONE model forward (the
reference graph shares one reconstruction between them), differentiated by
``torch.autograd.grad`` with respect to the input only, so no weight
gradient is computed.  The objective is a sum of per-sample terms, so each
slice restores exactly as it would alone: ``tv_lambda`` may be a per-sample
(B,) tensor, and zero-padded batch mates never change real slices.  Every
step draws from the generator anew: fresh ``eps`` and, with MC dropout,
fresh dropout masks.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    Sample,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.losses import (
    l1_elem,
    total_variation,
)

Tensor = torch.Tensor

# outputs_fn(x, generator) -> (pixel_loss (B,), x_hat (B, H, W, C)) from ONE
# model forward
RestorationFn = Callable[[Tensor, Sample], Tuple[Tensor, Tensor]]


def restoration_grads(outputs_fn: RestorationFn, x: Tensor,
                      tv_lambda: Union[float, Tensor],
                      generator: Sample) -> Tensor:
    """d(sum(pixel_loss + tv_lambda * TV(x - x_hat))) / dx."""
    with torch.enable_grad():
        xi = x.detach().requires_grad_(True)
        pixel, x_hat = outputs_fn(xi, generator)
        total = torch.sum(pixel + tv_lambda * total_variation(xi - x_hat))
        (grad,) = torch.autograd.grad(total, xi)
    return grad


def restore_inputs(outputs_fn: RestorationFn, x: Tensor,
                   tv_lambda: Union[float, Tensor], restore_lr: float,
                   restore_steps: int, generator: Sample) -> Tensor:
    """``x <- x - restore_lr * restoration_grads(x)``, ``restore_steps``
    times."""
    restored = x.detach()
    for _ in range(int(restore_steps)):
        restored = restored - restore_lr * restoration_grads(
            outputs_fn, restored, tv_lambda, generator)
    return restored


def gradient_anomaly_map(outputs_fn: Callable[[Tensor],
                                              Tuple[Tensor, Tensor]],
                         x: Tensor) -> Tuple[Tensor, Tensor]:
    """(``|x - x_hat| * |d sum(loss_vae) / dx|``, ``x_hat``) from ONE
    forward ``outputs_fn(x) -> (loss_vae (B,), x_hat)``: the anomaly map and
    the reconstruction share its noise and dropout."""
    with torch.enable_grad():
        xi = x.detach().requires_grad_(True)
        loss_vae, x_hat = outputs_fn(xi)
        (grad,) = torch.autograd.grad(torch.sum(loss_vae), xi)
    x_hat = x_hat.detach()
    return l1_elem(x, x_hat) * torch.abs(grad), x_hat
