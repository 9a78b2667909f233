"""Trainer registry: reference trainer names -> trainer classes.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/train/
registry.py`.  Ported: ``AE``, ``VAE``, ``VAE_You``, ``CE`` and ``ceVAE``.
"""

from __future__ import annotations

from typing import Dict, Type

from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import base

TRAINER_REGISTRY: Dict[str, Type[base.BaseTrainer]] = {
    "AE": base.AE,
    "VAE": base.VAE,
    "VAE_You": base.VAE_You,
    "CE": base.CE,
    "ceVAE": base.CeVAE,
}

NOT_YET_PORTED = ("GMVAE", "GMVAE_spatial", "ConstrainedAE", "AAE",
                  "ConstrainedAAE", "fAnoGAN", "AnoVAEGAN")


def get_trainer(name: str) -> Type[base.BaseTrainer]:
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"trainer {name!r} is not yet ported, see ROADMAP.md")
    if name not in TRAINER_REGISTRY:
        raise KeyError(
            f"unknown trainer {name!r}; known: {sorted(TRAINER_REGISTRY)}")
    return TRAINER_REGISTRY[name]
