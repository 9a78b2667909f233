#!/usr/bin/env python
"""Train a preset one epoch in the JAX package and in the PyTorch port
from one start, with the draws given, and print both histories.

The port's model takes the JAX init (``models/convert.py::
params_from_flax``), dropout is 0, and every
random draw of a training or VAL forward (the prior latent, eps, the
interpolates' alphas, the GMVAEs' normals) is one fixed array per shape
and kind in both packages: ``jax.random.normal`` / ``jax.random.uniform``
on the JAX side, the port's ``models/layers.py::draw`` (and
``train/gan.py``'s) on the other.  The healthy cohort is the CLI's
(``cli.build_dataset``) at the quality tables' recipe (32x32, 8 slices,
``-z 16 -b 8``, float32) unless cut with ``--patients``; ``post_fit`` (the
GMVAEs' lambda sweep) is skipped.  Besides the histories it prints each
optimizer's update count (``count`` of optax's Adam state, ``step`` of
torch's), i.e. the updates per group over the epoch:

    python tools/one_start_epoch.py --preset AAE
    python tools/one_start_epoch.py --preset constrainedAAE_Chen --resnet-dim 8

Runs on the CPU; needs both packages.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _fixed(kind: str, shape) -> "np.ndarray":
    import numpy as np

    shape = tuple(int(s) for s in shape)
    rng = np.random.default_rng([sum((i + 1) * 7919 ** k for k, i in
                                     enumerate(shape)) % 2 ** 32,
                                 len(shape), kind == "normal"])
    out = rng.normal(size=shape) if kind == "normal" else rng.uniform(
        size=shape)
    return out.astype(np.float32)


@contextlib.contextmanager
def given_draws(rows=None):
    """Both packages draw ``_fixed(kind, shape)`` for every normal and
    uniform of the training and VAL forwards.  ``rows`` reorders the JAX
    side's draws that lead with a batch of ``len(rows)`` rows, to go with
    a batch whose rows are reordered the same way."""
    import jax
    import jax.numpy as jnp
    import torch

    from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import (
        layers,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import gan

    real = (jax.random.normal, jax.random.uniform, layers.draw, gan.draw)

    def given(kind, shape):
        out = _fixed(kind, shape)
        if rows is not None and out.ndim and out.shape[0] == len(rows):
            out = out[rows]
        return out

    def normal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(given("normal", shape))

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(given("uniform", shape) * (maxval - minval)
                           + minval)

    def draw(fn, source, shape, device):
        kind = {torch.randn: "normal", torch.rand: "uniform"}.get(fn)
        if kind is None:
            return real[2](fn, source, shape, device)
        return torch.from_numpy(_fixed(kind, shape)).to(device)

    jax.random.normal, jax.random.uniform = normal, uniform
    layers.draw = gan.draw = draw
    try:
        yield
    finally:
        jax.random.normal, jax.random.uniform, layers.draw, gan.draw = real


@contextlib.contextmanager
def resnet_dim(dim):
    """Both registries build Chen's and Schlegl's ResNets at ``dim``."""
    from unsupervised_anomaly_detection_brain_mri_tpu.models import (
        chen as jax_chen,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu.models import (
        fanogan as jax_fanogan,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu.models import (
        registry as jax_registry,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import (
        chen,
        fanogan,
        registry,
    )

    saved = []
    for name, jcls, tcls in (
            ("constrained_adversarial_autoencoder_Chen",
             jax_chen.ConstrainedAAEChen, chen.ConstrainedAAEChen),
            ("fanogan_schlegl", jax_fanogan.FAnoGANSchlegl,
             fanogan.FAnoGANSchlegl)):
        for reg, cls in ((jax_registry.MODEL_REGISTRY, jcls),
                         (registry.MODEL_REGISTRY, tcls)):
            def build(c, d, cls=cls):
                return cls(image_size=c.outputWidth, channels=c.numChannels,
                           z_dim=c.zDim,
                           intermediate_resolution=c.intermediateResolutions[
                               0], dropout_rate=c.dropout_rate, dim=dim,
                           dtype=d)

            saved.append((reg, name, reg[name]))
            reg[name] = dataclasses.replace(reg[name], build=build)
    try:
        yield
    finally:
        for reg, name, entry in saved:
            reg[name] = entry


def _jax_counts(opt_states) -> dict:
    """Largest Adam ``count`` per optimizer group."""
    import jax

    out = {}
    for group, state in opt_states.items():
        counts = [int(v) for p, v in
                  jax.tree_util.tree_leaves_with_path(state)
                  if str(getattr(p[-1], "name", "")) == "count"]
        out[group] = max(counts)
    return out


def _port_counts(optimizer) -> dict:
    groups = getattr(optimizer, "optimizers", {"main": optimizer})
    return {g: max((int(s["step"]) for s in o.state_dict()["state"].values()),
                   default=0)
            for g, o in groups.items()}


def one_epoch(name: str, patients: int = 8, dim: int = 0) -> dict:
    """One epoch of preset ``name`` at the recipe in both packages from
    the JAX init with the draws given; returns both histories and update
    counts."""
    import jax

    from unsupervised_anomaly_detection_brain_mri_tpu.config import (
        Config as JaxConfig,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu.config import (
        Options as JaxOptions,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu.data.synthetic import (
        SYNTH as JaxSYNTH,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu.data.synthetic import (
        SyntheticOptions as JaxSyntheticOptions,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu.train import (
        get_trainer as jax_get_trainer,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
        Options,
        preset,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.synthetic import (
        SYNTH,
        SyntheticOptions,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.convert import (
        params_from_flax,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
        get_trainer,
    )

    config = preset(name).replace(
        batchsize=8, zDim=16, outputWidth=32, outputHeight=32, numEpochs=1,
        compute_dtype="float32", dropout_rate=0.0)
    # the CLI's healthy cohort at the recipe (cli.build_dataset)
    synth = dict(numPatients=patients, imageSize=32, numSlices=8,
                 targetSize=32, partition={"TRAIN": 0.7, "VAL": 0.3,
                                           "TEST": 0.0})
    options = dict(sliceStart=0, sliceEnd=8, erosionIterations=3)
    with contextlib.ExitStack() as stack:
        if dim:
            stack.enter_context(resnet_dim(dim))
        jt = jax_get_trainer(config.trainer)(
            JaxConfig.from_json(config.to_json()), JaxOptions(**options))
        state = jt.init_state()
        tt = get_trainer(config.trainer)(config, Options(**options),
                                         device="cpu")
        tt.init_state()
        tt.model.load_state_dict(params_from_flax(
            jax.device_get(state.params), jax.device_get(state.batch_stats),
            tt.model))
        jt.post_fit = tt.post_fit = lambda *a, **k: None
        stack.enter_context(given_draws())
        state = jt.fit(JaxSYNTH(JaxSyntheticOptions(**synth)), state=state,
                       resume=False)
        tt.fit(SYNTH(SyntheticOptions(**synth)), resume=False)
    return {"jax": jt.history, "port": tt.history,
            "jax_updates": _jax_counts(jax.device_get(state.opt_states)),
            "port_updates": _port_counts(tt.optimizer)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", required=True)
    ap.add_argument("--patients", type=int, default=8)
    ap.add_argument("--resnet-dim", type=int, default=0,
                    help="build Chen's and Schlegl's ResNets at this dim "
                         "(default: the registries' 64)")
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = one_epoch(args.preset, args.patients, args.resnet_dim)
    for j, t in zip(out["jax"], out["port"]):
        keys = sorted((set(j) | set(t)) - {"epoch", "phase"})
        print(json.dumps({"epoch": j["epoch"], "phase": j["phase"],
                          **{k: [j.get(k), t.get(k)] for k in keys}}))
    print(json.dumps({"updates": {"jax": out["jax_updates"],
                                  "port": out["port_updates"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
