"""Models of the port (the parity paths of the JAX zoo)."""

from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.registry import (  # noqa: F401
    MODEL_REGISTRY,
    get_model,
)
