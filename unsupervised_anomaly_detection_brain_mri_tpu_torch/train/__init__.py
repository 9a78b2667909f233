"""Trainers of the port (``train/registry.py`` lists them)."""

from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (  # noqa: F401
    TRAINER_REGISTRY,
    get_trainer,
)
