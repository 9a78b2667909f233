"""The ``AE`` preset (``mains/main_AE.py``): the dense autoencoder, trained
on ``mean_b(sum |x - x_hat|)``; its reconstruction is one evaluation
forward (no dropout)."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import backbone as B

Tensor = torch.Tensor
STEPWISE = False  # one forward: its answers are compared whole


def leaves(cfg: Dict):
    return B.leaves(cfg, variational=False)


def train_loss(net: B.Net, x: Tensor, cfg: Dict,
               streams: Dict[str, torch.Generator]) -> Tensor:
    """Draws: the z layer's dropout from ``streams["generator"]``."""
    out = net.autoencoder(x, cfg["dropout_rate"], streams["generator"])
    return B.l1_per_sample(x, out["x_hat"]).mean()


def reconstruct(p: Dict[str, Tensor], b: Dict[str, Tensor], x: Tensor,
                cfg: Dict, generator: torch.Generator, precision: str
                ) -> Tensor:
    with torch.no_grad():
        return B.Net(p, b, False, precision).autoencoder(
            x, cfg["dropout_rate"], None)["x_hat"]


def reconstruction_unit(p: Dict[str, Tensor], b: Dict[str, Tensor],
                        x: Tensor, cfg: Dict, generator: torch.Generator
                        ) -> None:
    """One repeated unit of a reconstruction (for counting its FLOPs)."""
    reconstruct(p, b, x, cfg, generator, "float32")


def reconstruction_units(cfg: Dict) -> int:
    """How many units a reconstruction makes: one forward."""
    return 1
