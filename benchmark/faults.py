"""Faults planted under the timed path, to show that the check sees them.

Each is a context manager that patches the port while it is open:

  * ``unchanged``: a training step returns its state unchanged (the
    forward and the loss run, nothing is updated);
  * ``half_batch``: a training step sees the first half of its batch only,
    the mean taken over it;
  * ``unchanged_restoration``: a served restoration computes every
    step's gradient and returns its input unchanged;
  * ``altered_map``: a served answer's anomaly map is altered where it is
    produced (``_postprocess`` returns it scaled by 1.25);
  * ``altered_mask``: a served answer's mask is altered where it is
    produced (one voxel of the components filter's output flipped).

``calibrate.py --faults NAME --fault-seeds ...`` reads a fault on the card;
the CPU tests run a whole cell with each and see ``correct`` false.
"""

from __future__ import annotations

import contextlib
import importlib

PORT = "unsupervised_anomaly_detection_brain_mri_tpu_torch"


def _port(module: str):
    return importlib.import_module(f"{PORT}.{module}")


@contextlib.contextmanager
def _patched(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


def unchanged():
    base = _port("train.base").BaseTrainer

    def train_step(self, batch):
        outputs, inputs = self.apply_model(batch, train=True)
        losses = self.compute_losses_with_inputs(outputs, batch, inputs)
        self.step += 1
        return self._scalar_metrics(losses)

    return _patched(base, "train_step", train_step)


def half_batch():
    base = _port("train.base").BaseTrainer
    original = base.train_step

    def train_step(self, batch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return original(self, half)

    return _patched(base, "train_step", train_step)


def unchanged_restoration():
    base = _port("train.base")
    restoration = _port("train.restoration")

    def restore_inputs(outputs_fn, x, tv_lambda, restore_lr, restore_steps,
                       generator):
        for _ in range(int(restore_steps)):
            restoration.restoration_grads(outputs_fn, x.detach(), tv_lambda,
                                          generator)
        return x.detach()

    return _patched(base, "restore_inputs", restore_inputs)


def altered_map():
    inference = _port("eval.inference")
    original = inference._postprocess

    def _postprocess(*args, **kwargs):
        return original(*args, **kwargs) * 1.25

    return _patched(inference, "_postprocess", _postprocess)


def altered_mask():
    post = _port("ops.postprocess")
    original = post.filter_small_components

    def filter_small_components(mask, *args, **kwargs):
        out = original(mask, *args, **kwargs)
        kept, rest = (out if isinstance(out, tuple) else (out, None))
        kept = kept.clone()
        kept.view(-1)[kept.numel() // 2] = 1.0 - kept.view(-1)[
            kept.numel() // 2]
        return kept if rest is None else (kept, rest)

    return _patched(post, "filter_small_components",
                    filter_small_components)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "unchanged_restoration": unchanged_restoration,
          "altered_map": altered_map, "altered_mask": altered_mask}
