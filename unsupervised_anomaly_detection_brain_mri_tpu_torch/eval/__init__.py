"""Serving: volume reconstruction, post-processing, the detector."""
