"""PyTorch/CUDA port of the brain-MRI anomaly detection framework.

A second package beside the JAX one (`unsupervised_anomaly_detection_brain_
mri_tpu`, the reference), mirroring its module paths.  It imports ``torch``
and never ``jax``, ``flax``, ``optax`` or ``orbax``, nor anything of the JAX
package: the host-side layer (config, volume I/O, preprocessing, phantoms,
dataset loaders, artifacts) is the port's own copy.
Every kernel the JAX package wrote in Pallas is a hand-written kernel here
(``csrc/``), and a CUDA tensor always reaches its kernel or raises.

Ported: all 18 presets end to end: training (``train/``), ``evaluate()``
with MC dropout and threshold transfer (``eval/evaluate.py``), serving
(``eval/inference.py``) and the CLI (``python -m
unsupervised_anomaly_detection_brain_mri_tpu_torch --preset AE
--synthetic``; without ``--synthetic`` the paper's protocol on BRAINWEB,
MSLUB and MSISBI2015 from ``-c paths.json``; ``... infer``; the preset
mains ``mains/main_<preset>.py``); the BrainWeb downloader
(``data/download.py``, ``run_all --download``); and the data-parallel
layer (``parallel/``, ``--mesh-data N`` under ``torchrun``).
"""

__version__ = "0.1.0"

from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (  # noqa: F401
    Config,
    Options,
    default_options,
)
