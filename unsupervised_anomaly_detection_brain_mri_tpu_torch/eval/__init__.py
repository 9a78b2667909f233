"""Evaluation and serving: reconstruction, post-processing, metrics,
threshold transfer, the detector."""
