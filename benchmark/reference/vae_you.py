"""The ``VAE_You`` preset (``mains/main_VAE_You.py``): the unified VAE,
trained on ``mean_b(sum |x - x_hat| + KL)``; its reconstruction restores
the input by ``restore_steps`` steps of gradient descent,

    x <- x - restore_lr * d/dx sum_b(|x - x_hat|_1 + KL + lambda * TV(x - x_hat)),

each step one evaluation forward (running BatchNorm statistics, no
dropout) with a fresh eps from the request's generator, differentiated
with respect to the input only.

``STEPWISE``: the restoration is chaotic.  The L1 term's gradient is the
sign of x - x_hat at every voxel, and the decoder spreads each input
voxel over the whole slice, so a rounding that flips one sign moves every
later step: two float32 implementations of the same steps differ by more
than 1e-4 on half the voxels after five steps.  So the check follows the
port step by step from its own state: the reference's forward and
gradient at the port's own input of a step, with that step's eps.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from benchmark.reference import backbone as B

Tensor = torch.Tensor
STEPWISE = True


def leaves(cfg: Dict):
    return B.leaves(cfg, variational=True)


def train_loss(net: B.Net, x: Tensor, cfg: Dict,
               streams: Dict[str, torch.Generator]) -> Tensor:
    """Draws: the mu and log-sigma heads' dropout from
    ``streams["generator"]``, eps from ``streams["sample_generator"]``,
    the dense-back dropout from ``streams["generator"]``."""
    out = net.vae(x, cfg["dropout_rate"], streams["generator"],
                  streams["sample_generator"])
    return (B.l1_per_sample(x, out["x_hat"])
            + B.kl_per_sample(out["z_mu"], out["z_sigma"])).mean()


def restoration_step(net: B.Net, x: Tensor, cfg: Dict,
                     generator: torch.Generator) -> Tuple[Tensor, Tensor]:
    """(the input gradient, the forward's output) of one restoration
    step."""
    with torch.enable_grad():
        xi = x.detach().requires_grad_(True)
        out = net.vae(xi, cfg["dropout_rate"], None, generator)
        pixel = (B.l1_per_sample(xi, out["x_hat"])
                 + B.kl_per_sample(out["z_mu"], out["z_sigma"]))
        lam = max(float(cfg["assumed"]["tv_lambda"]), 0.0)
        total = torch.sum(pixel + lam * B.total_variation(xi - out["x_hat"]))
        (grad,) = torch.autograd.grad(total, xi)
    return grad, out["x_hat"].detach()


def reconstruct(p: Dict[str, Tensor], b: Dict[str, Tensor], x: Tensor,
                cfg: Dict, generator: torch.Generator, precision: str,
                capture: Optional[Dict] = None) -> Tensor:
    """The restored input; ``capture`` ({"steps": set, "got": {}}) keeps
    each chosen step's (input, forward output, gradient) in
    ``got[step]``."""
    net = B.Net(p, b, False, precision)
    restored = x.detach()
    for k in range(int(cfg["restore_steps"])):
        grad, x_hat = restoration_step(net, restored, cfg, generator)
        if capture is not None and k in capture["steps"]:
            capture["got"][k] = (restored.clone(), x_hat, grad.clone())
        restored = (restored - cfg["restore_lr"] * grad).detach()
    return restored


def reconstruction_unit(p: Dict[str, Tensor], b: Dict[str, Tensor],
                        x: Tensor, cfg: Dict, generator: torch.Generator
                        ) -> None:
    """One repeated unit of a reconstruction (for counting its FLOPs)."""
    restoration_step(B.Net(p, b, False, "float32"), x, cfg, generator)


def reconstruction_units(cfg: Dict) -> int:
    """How many units a reconstruction makes: its restoration steps."""
    return int(cfg["restore_steps"])
