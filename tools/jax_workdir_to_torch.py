#!/usr/bin/env python
"""Convert a JAX training workdir into one the PyTorch port can serve and
resume.

Restores the workdir's orbax checkpoint with the JAX package's own
``load_checkpoint`` and writes, for every model of the registry (also with
the non-parity ``spaceToDepthStem``/``depthToSpaceHead`` layers):

  * ``<workdir>/torch/model.pt``, the port's ``state_dict``
    (``models/convert.py::params_from_flax``), which serving loads;
  * ``<workdir>/torch/ckpt/epoch_NNNNNN.pt``, the port's full checkpoint
    of the same epoch: the weights, every Adam state (``adam_state_from_
    optax``, also inside the adversarial trainers' masked chains), the
    global step and the epoch, so ``fit`` resumes the run where JAX left
    it.  JAX's threefry key has no torch counterpart: the port's random
    streams restart from their seeds.  A run whose optimizer is not Adam
    gets ``model.pt`` only.

The ``config.json``, ``curves.json``, any ``calibration.json`` and a swept
``tv_lambda.json`` already in the workdir are shared by both packages, so
afterwards

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
    """Write ``<workdir>/torch/model.pt`` and the full checkpoint of its
    epoch from the latest JAX checkpoint; returns the ``model.pt`` path."""
    import jax
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu.config import Config
    from unsupervised_anomaly_detection_brain_mri_tpu.train import get_trainer
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
        Config as PortConfig,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.convert import (
        adam_state_from_optax,
        params_from_flax,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.base import (
        CHECKPOINT,
        CHECKPOINT_DIR,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer as get_port_trainer,
    )

    with open(os.path.join(workdir, "config.json")) as f:
        config = Config.from_json(f.read())
    trainer = get_trainer(config.trainer)(config, workdir=workdir)
    restored = trainer.load_checkpoint(trainer.init_state())
    if restored is None:
        raise FileNotFoundError(f"no JAX checkpoint under {workdir}")
    state, epoch = restored
    port = get_port_trainer(config.trainer)(
        PortConfig.from_json(config.to_json()), device="cpu")
    port.init_state()
    state_dict = params_from_flax(jax.device_get(state.params),
                                  jax.device_get(state.batch_stats),
                                  port.model)
    port.model.load_state_dict(state_dict)
    path = os.path.join(workdir, CHECKPOINT)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(state_dict, path)

    opt_states = jax.device_get(state.opt_states)
    try:
        optimizers = {
            name: adam_state_from_optax(opt_states[name or "main"],
                                        port.model, opt)
            for name, opt in port._optimizers().items()}
    except ValueError as e:  # not an Adam state
        print(f"weights only, no resumable checkpoint: {e}")
        return path
    ckpt_dir = os.path.join(workdir, CHECKPOINT_DIR)
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save({
        "model": state_dict,
        "optimizer": optimizers.get("", optimizers),
        **{k: g.get_state() for k, g in port._streams().items()},
        "step": int(jax.device_get(state.step)),
        "epoch": int(epoch),
    }, os.path.join(ckpt_dir, f"epoch_{int(epoch):06d}.pt"))
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
