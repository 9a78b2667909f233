"""Ops of the port: post-processing, metrics and the hand-written kernels."""
