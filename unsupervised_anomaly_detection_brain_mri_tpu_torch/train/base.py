"""Trainer base, inference half: init, checkpoints, reconstruction.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/train/base.py`
for serving.  The trainer owns its model on an explicit ``device``; the
model's ``state_dict`` is the state.  Checkpoints are
``<workdir>/torch/model.pt`` (a ``state_dict`` saved by ``torch.save``,
loaded with ``weights_only=True``) plus the same ``config.json`` sidecar
the JAX package writes, so a JAX workdir converted by
``tools/jax_workdir_to_torch.py`` serves here unchanged.

``fit``, losses and optimizers are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
from torch import nn

from unsupervised_anomaly_detection_brain_mri_tpu.config import Config, Options
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.registry import (
    get_model,
)

CHECKPOINT = os.path.join("torch", "model.pt")


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def count_params(model: nn.Module) -> int:
    """Number of trainable parameters (BatchNorm statistics excluded, as in
    the JAX package's ``count_params`` over ``params``)."""
    return sum(p.numel() for p in model.parameters())


class BaseTrainer:
    """Model construction, seeded init, checkpoints and reconstruction."""

    def __init__(self, config: Config, options: Optional[Options] = None,
                 workdir: Optional[str] = None,
                 device: torch.device | str = "cpu") -> None:
        self.config = config
        self.options = options or Options()
        self.workdir = workdir
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available")
        self.dtype = dtype_of(config.compute_dtype)
        model, self.spec = get_model(config, self.dtype)
        self.model = model.to(self.device)

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> nn.Module:
        """Glorot-uniform weights, zero biases, BatchNorm at scale 1, bias
        0 and running statistics (0, 1), drawn on the CPU from
        ``generator`` (default: seeded with ``config.seed``)."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.config.seed)
        with torch.no_grad():
            for module in self.model.modules():
                if isinstance(module, nn.BatchNorm2d):
                    module.reset_parameters()
                elif isinstance(module, (nn.Conv2d, nn.ConvTranspose2d,
                                         nn.Linear)):
                    w = torch.empty(module.weight.shape)
                    nn.init.xavier_uniform_(w, generator=generator)
                    module.weight.copy_(w)
                    module.bias.zero_()
        print(f"[{self.__class__.__name__}] {self.config.model}: "
              f"{count_params(self.model):,} parameters")
        return self.model

    def save_checkpoint(self) -> str:
        """Write ``<workdir>/torch/model.pt`` and ``<workdir>/config.json``."""
        path = os.path.join(self.workdir, CHECKPOINT)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(self.model.state_dict(), path)
        with open(os.path.join(self.workdir, "config.json"), "w") as f:
            f.write(self.config.to_json())
        return path

    def load_checkpoint(self) -> Optional[nn.Module]:
        """Load ``<workdir>/torch/model.pt`` into the model; None if the
        workdir holds no port checkpoint."""
        if not self.workdir:
            return None
        path = os.path.join(self.workdir, CHECKPOINT)
        if not os.path.isfile(path):
            return None
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state)
        print(f"Restored checkpoint {path}")
        return self.model

    @torch.no_grad()
    def reconstruct_device(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Reconstruct a batch of (B, H, W, C) slices on the trainer's
        device in eval mode, without dropout, as one batch.  Returns
        ``reconstruction`` plus every model output."""
        if x.ndim < 4:
            x = x[None]
        self.model.eval()
        outputs = self.model(x.to(self.device, torch.float32))
        return {"reconstruction": outputs[self.spec.reconstruction_key],
                **outputs}


class AE(BaseTrainer):
    """L1 autoencoder (its loss and ``fit`` are not yet ported)."""
