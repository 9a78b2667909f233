"""Evaluation and serving: reconstruction, post-processing, metrics,
threshold transfer, the detector."""

from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate import (  # noqa: F401
    determine_threshold_on_labeled_patients,
    evaluate,
)
