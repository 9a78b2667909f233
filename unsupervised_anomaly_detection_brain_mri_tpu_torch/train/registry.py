"""Trainer registry: reference trainer names -> trainer classes.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/train/
registry.py`, all 12 trainers: ``AE``, ``VAE``, ``VAE_You``, ``CE``,
``ceVAE``, ``GMVAE``, ``GMVAE_spatial``, ``ConstrainedAE``
(``train/base.py``), and the adversarial ``AAE``, ``ConstrainedAAE``,
``fAnoGAN`` and ``AnoVAEGAN`` (``train/gan.py``).
"""

from __future__ import annotations

from typing import Dict, Type

from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
    base,
    gan,
)

TRAINER_REGISTRY: Dict[str, Type[base.BaseTrainer]] = {
    "AE": base.AE,
    "VAE": base.VAE,
    "VAE_You": base.VAE_You,
    "CE": base.CE,
    "ceVAE": base.CeVAE,
    "GMVAE": base.GMVAE,
    "GMVAE_spatial": base.GMVAE_spatial,
    "ConstrainedAE": base.ConstrainedAE,
    "AAE": gan.AAE,
    "ConstrainedAAE": gan.ConstrainedAAE,
    "fAnoGAN": gan.FAnoGAN,
    "AnoVAEGAN": gan.AnoVAEGAN,
}


def get_trainer(name: str) -> Type[base.BaseTrainer]:
    if name not in TRAINER_REGISTRY:
        raise KeyError(
            f"unknown trainer {name!r}; known: {sorted(TRAINER_REGISTRY)}")
    return TRAINER_REGISTRY[name]
