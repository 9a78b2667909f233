"""PyTorch/CUDA port of the brain-MRI anomaly detection framework.

A second package beside the JAX one (`unsupervised_anomaly_detection_brain_
mri_tpu`, the reference), mirroring its module paths.  It imports ``torch``
and never ``jax``, ``flax``, ``optax`` or ``orbax``; from the JAX package it
uses only host-side modules (config, volume I/O, preprocessing, phantoms).
Every kernel the JAX package wrote in Pallas is a hand-written kernel here
(``csrc/``), and a CUDA tensor always reaches its kernel or raises.

Ported so far: the ``AE`` preset end to end: training (``train/``),
``evaluate()`` with threshold transfer (``eval/evaluate.py``), serving
(``eval/inference.py``) and the CLI
(``python -m unsupervised_anomaly_detection_brain_mri_tpu_torch --preset AE
--synthetic``; ``... infer``).
"""

__version__ = "0.1.0"

from unsupervised_anomaly_detection_brain_mri_tpu.config import (  # noqa: F401
    Config,
    Options,
    default_options,
)
