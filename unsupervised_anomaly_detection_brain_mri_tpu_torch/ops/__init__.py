"""Ops of the port: post-processing and the hand-written kernels."""
