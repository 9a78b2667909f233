"""Model registry: reference model names -> torch modules + metadata.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/models/
registry.py`, with its metadata: ``reconstruction_key`` (the output that is
the reconstruction: ``xz_mu`` for the GMVAEs), ``takes_prior_z`` (the
adversarial models, whose forward takes a prior latent), ``takes_context``
(a second, context-masked input) and ``rngs`` (the random streams the model
draws: ``dropout``; ``sample`` for the normals of the VAEs and GMVAEs;
``gp`` for the critic interpolate's eps).  Every network of the JAX
registry is ported (the ResNets at ``dim`` 64).  The non-parity options
``spaceToDepthStem`` and ``depthToSpaceHead`` reach only the models whose
constructor takes ``space_to_depth_stem``/``depth_to_space_head`` (the
unified-backbone AEs, ``VariationalAutoencoder``, the latent-critic AAEs,
``ConstrainedAutoencoder``, ``FAnoGAN`` and ``AnoVAEGAN``), as the JAX
package's ``_std`` passes them only to the classes that declare them;
every other model builds its parity architecture.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import Config
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import (
    aae,
    ae,
    anovaegan,
    cevae,
    chen,
    fanogan,
    gmvae,
    vae,
)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    build: Callable[[Config, torch.dtype], nn.Module]
    reconstruction_key: str = "x_hat"
    takes_prior_z: bool = False
    takes_context: bool = False
    rngs: Tuple[str, ...] = ("dropout",)


def _std(cls):
    def build(config: Config, dtype: torch.dtype) -> nn.Module:
        kwargs = dict(
            image_size=config.outputWidth,
            channels=config.numChannels,
            z_dim=config.zDim,
            intermediate_resolution=config.intermediateResolutions[0],
            dropout_rate=config.dropout_rate,
            dtype=dtype,
        )
        # the non-parity options, only for the models that take them
        takes = inspect.signature(cls).parameters
        if "space_to_depth_stem" in takes and config.spaceToDepthStem:
            kwargs["space_to_depth_stem"] = True
        if "depth_to_space_head" in takes and config.depthToSpaceHead:
            kwargs["depth_to_space_head"] = True
        return cls(**kwargs)

    return build


def _gmvae(cls):
    def build(config: Config, dtype: torch.dtype) -> nn.Module:
        return cls(
            image_size=config.outputWidth,
            channels=config.numChannels,
            intermediate_resolution=config.intermediateResolutions[0],
            dim_c=config.dim_c,
            dim_z=config.dim_z,
            dim_w=config.dim_w,
            dropout_rate=config.dropout_rate,
            dtype=dtype,
        )

    return build


_SAMPLE = ("dropout", "sample")
_GP = ("dropout", "gp")

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
    "gaussian_mixture_variational_autoencoder": ModelSpec(
        _gmvae(gmvae.GMVAE), reconstruction_key="xz_mu", rngs=_SAMPLE),
    "gaussian_mixture_variational_autoencoder_spatial": ModelSpec(
        _gmvae(gmvae.GMVAESpatial), reconstruction_key="xz_mu",
        rngs=_SAMPLE),
    "gaussian_mixture_variational_autoencoder_You": ModelSpec(
        _gmvae(gmvae.GMVAEYou), reconstruction_key="xz_mu", rngs=_SAMPLE),
    "adversarial_autoencoder": ModelSpec(
        _std(aae.AdversarialAutoencoder), takes_prior_z=True, rngs=_GP),
    "constrained_autoencoder": ModelSpec(_std(aae.ConstrainedAutoencoder)),
    "constrained_adversarial_autoencoder": ModelSpec(
        _std(aae.ConstrainedAAE), takes_prior_z=True, rngs=_GP),
    "constrained_adversarial_autoencoder_Chen": ModelSpec(
        _std(chen.ConstrainedAAEChen), takes_prior_z=True, rngs=_GP),
    "fanogan": ModelSpec(
        _std(fanogan.FAnoGAN), reconstruction_key="x_enc",
        takes_prior_z=True, rngs=_GP),
    "fanogan_schlegl": ModelSpec(
        _std(fanogan.FAnoGANSchlegl), reconstruction_key="x_enc",
        takes_prior_z=True, rngs=_GP),
    "anovaegan": ModelSpec(
        _std(anovaegan.AnoVAEGAN), reconstruction_key="out",
        rngs=("dropout", "sample", "gp")),
}


def get_model(config: Config, dtype: torch.dtype = torch.float32
              ) -> Tuple[nn.Module, ModelSpec]:
    """Build the module named by ``config.model`` (float32 parameters,
    compute in ``dtype``)."""
    if config.model not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model {config.model!r}; known: {sorted(MODEL_REGISTRY)}")
    spec = MODEL_REGISTRY[config.model]
    return spec.build(config, dtype), spec
