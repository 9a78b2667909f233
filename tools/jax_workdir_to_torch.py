#!/usr/bin/env python
"""Convert a JAX training workdir into one the PyTorch port can serve.

Restores the workdir's orbax checkpoint with the JAX package's own
``load_checkpoint`` and writes ``<workdir>/torch/model.pt`` (the port's
``state_dict``, via ``models/convert.py::params_from_flax``), for every
model the port has (the AEs, the VAEs and the ceVAEs).  The
``config.json``, any ``calibration.json`` and a swept ``tv_lambda.json``
already in the workdir are shared by both packages, so afterwards

    python -m unsupervised_anomaly_detection_brain_mri_tpu_torch infer \\
        --workdir W -i scan.nii.gz

serves the run trained with JAX.  Needs both packages installed (JAX to
restore, torch to save):

    python tools/jax_workdir_to_torch.py --workdir W
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(workdir: str) -> str:
    """Write ``<workdir>/torch/model.pt`` from the latest JAX checkpoint;
    returns its path."""
    import jax
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu.config import Config
    from unsupervised_anomaly_detection_brain_mri_tpu.train import get_trainer
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.convert import (
        params_from_flax,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.base import (
        CHECKPOINT,
    )

    with open(os.path.join(workdir, "config.json")) as f:
        config = Config.from_json(f.read())
    trainer = get_trainer(config.trainer)(config, workdir=workdir)
    restored = trainer.load_checkpoint(trainer.init_state())
    if restored is None:
        raise FileNotFoundError(f"no JAX checkpoint under {workdir}")
    state, _ = restored
    state_dict = params_from_flax(jax.device_get(state.params),
                                  jax.device_get(state.batch_stats))
    path = os.path.join(workdir, CHECKPOINT)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(state_dict, path)
    return path


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", required=True,
                   help="JAX workdir (config.json + ckpt/)")
    args = p.parse_args(argv)
    print(f"wrote {convert(args.workdir)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
