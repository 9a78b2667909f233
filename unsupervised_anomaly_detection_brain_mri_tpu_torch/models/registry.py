"""Model registry: reference model names -> torch modules + metadata.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/models/
registry.py`, with its metadata: ``reconstruction_key`` (the output that is
the reconstruction), ``takes_context`` (a second, context-masked input) and
``rngs`` (the random streams the model draws: ``dropout``, and ``sample``
for the VAEs' ``eps``).  Ported, in their parity architecture: the AEs, the
VAEs and the ceVAEs.  Every other name of the JAX registry, and the
non-parity ``spaceToDepthStem``/``depthToSpaceHead`` options, raise
``NotImplementedError`` until their slice lands.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from unsupervised_anomaly_detection_brain_mri_tpu.config import Config
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import (
    ae,
    cevae,
    vae,
)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    build: Callable[[Config, torch.dtype], nn.Module]
    reconstruction_key: str = "x_hat"
    takes_context: bool = False
    rngs: Tuple[str, ...] = ("dropout",)


def _std(cls):
    def build(config: Config, dtype: torch.dtype) -> nn.Module:
        return cls(
            image_size=config.outputWidth,
            channels=config.numChannels,
            z_dim=config.zDim,
            intermediate_resolution=config.intermediateResolutions[0],
            dropout_rate=config.dropout_rate,
            dtype=dtype,
        )

    return build


_SAMPLE = ("dropout", "sample")

MODEL_REGISTRY: Dict[str, ModelSpec] = {
    "autoencoder": ModelSpec(_std(ae.Autoencoder)),
    "autoencoder_spatial": ModelSpec(_std(ae.AutoencoderSpatial)),
    "variational_autoencoder": ModelSpec(
        _std(vae.VariationalAutoencoder), rngs=_SAMPLE),
    "variational_autoencoder_Zimmerer": ModelSpec(
        _std(vae.VariationalAutoencoderZimmerer), rngs=_SAMPLE),
    "context_encoder_variational_autoencoder": ModelSpec(
        _std(cevae.ContextEncoderVAE), takes_context=True, rngs=_SAMPLE),
    "context_encoder_variational_autoencoder_Zimmerer": ModelSpec(
        _std(cevae.ContextEncoderVAEZimmerer), takes_context=True,
        rngs=_SAMPLE),
}

# the rest of the JAX registry, queued in ROADMAP.md
NOT_YET_PORTED = (
    "gaussian_mixture_variational_autoencoder",
    "gaussian_mixture_variational_autoencoder_spatial",
    "gaussian_mixture_variational_autoencoder_You",
    "adversarial_autoencoder",
    "constrained_autoencoder",
    "constrained_adversarial_autoencoder",
    "constrained_adversarial_autoencoder_Chen",
    "fanogan",
    "fanogan_schlegl",
    "anovaegan",
)


def get_model(config: Config, dtype: torch.dtype = torch.float32
              ) -> Tuple[nn.Module, ModelSpec]:
    """Build the module named by ``config.model`` (float32 parameters,
    compute in ``dtype``)."""
    if config.model in NOT_YET_PORTED:
        raise NotImplementedError(
            f"model {config.model!r} is not yet ported, see ROADMAP.md")
    if config.model not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model {config.model!r}; known: {sorted(MODEL_REGISTRY)}")
    for flag in ("spaceToDepthStem", "depthToSpaceHead"):
        if getattr(config, flag):
            raise NotImplementedError(
                f"{flag} is not yet ported, see ROADMAP.md")
    spec = MODEL_REGISTRY[config.model]
    return spec.build(config, dtype), spec
