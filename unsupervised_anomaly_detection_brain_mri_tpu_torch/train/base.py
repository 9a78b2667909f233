"""Trainer base and the deterministic trainers (``AE``, ``VAE``,
``VAE_You``, ``CE``, ``ceVAE``): init, training, checkpoints,
reconstruction, input restoration.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/train/base.py`.
The trainer owns its model, its optimizer and its dropout generator on an
explicit ``device``; together they are the state (the JAX package's
``TrainState``).  What carries over unchanged:

  * the batch order: a per-epoch seeded host shuffle
    ``np.random.default_rng((seed + 1, epoch))`` through ``epoch_indices``,
    so both packages see the same batches;
  * the VAL pass in eval mode (no dropout, running BatchNorm statistics),
    early stopping at ``earlyStoppingPatience``, the history, a checkpoint
    after each VAL pass, and resume that replays the VAL history and
    recognises an already-triggered stop;
  * the slice pool (with the brain masks of the context-encoder trainers)
    lives on the device; pools above ``Options.streamPoolThresholdMB`` (or
    with ``streamPool``) stay on the host and stream in chunks of
    ``streamPoolChunkBatches`` batches, with the same updates bit for bit;
  * the model's inputs come from ``model_inputs`` (a context-masked copy
    for ``CE`` and ``ceVAE`` in TRAIN) and the losses may see them
    (``compute_losses_with_inputs``);
  * ``VAE_You``'s ``tv_lambda`` sweep after training, written to
    ``tv_lambda.json``: the (lambda, slice) pairs restore together, up to
    ``SWEEP_CHUNK_SLICES`` slices at a time, each with its own lambda,
    since the restoration objective is per sample;
  * the sidecars ``config.json``, ``curves.json``, ``Curves.npy`` and
    ``tv_lambda.json``.

Checkpoints: ``<workdir>/torch/model.pt`` holds the weights that serving
loads (a ``state_dict``).  Beside it ``<workdir>/torch/ckpt/epoch_NNNNNN.pt``
holds the full state after an epoch (model, optimizer, generator states,
global step, epoch); the newest ``keepCheckpoints`` are kept.  All are
loaded with ``weights_only=True``.

Random streams: weights are drawn from a CPU generator seeded with
``config.seed`` (Glorot uniform).  Training draws dropout, instance noise
and context masks from ``generator`` on the trainer's device, seeded with
``config.seed``, and the VAEs' ``eps`` (in TRAIN and VAL) from
``sample_generator``, seeded with ``config.seed + 1`` (models whose spec
has a ``sample`` stream).  Reconstruction takes its own source
(``reconstruct_device(..., generator=)``, a generator seeded 0 by
default), which drives both dropout and ``eps``.  JAX's threefry streams
have no torch counterpart, so the draws differ between the packages
(trajectories are compared at ``dropout_rate=0`` with given noise).
"""

from __future__ import annotations

import glob
import json
import os
import re
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from unsupervised_anomaly_detection_brain_mri_tpu.config import Config, Options
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    Sample,
    VolumeGenerators,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.registry import (
    get_model,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
    losses as L,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.context import (
    random_context_masks,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.engine import (
    early_stopping_update,
    epoch_indices,
    run_epoch,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.restoration import (
    gradient_anomaly_map,
    restore_inputs,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.state import (
    make_optimizer,
)

CHECKPOINT = os.path.join("torch", "model.pt")
CHECKPOINT_DIR = os.path.join("torch", "ckpt")
_EPOCH_FILE = re.compile(r"epoch_(\d+)\.pt$")
# slices per restoration of the lambda sweep: 1,280 slices of 128x128 in
# bf16 peak at 10.6 GiB of device memory on an H100
SWEEP_CHUNK_SLICES = 1280

Batch = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def count_params(model: nn.Module) -> int:
    """Number of trainable parameters (BatchNorm statistics excluded, as in
    the JAX package's ``count_params`` over ``params``)."""
    return sum(p.numel() for p in model.parameters())


class BaseTrainer:
    """Model construction, seeded init, the fit loop, checkpoints and
    reconstruction."""

    early_stop_metric: str = "loss"
    needs_brainmask: bool = False
    VALID_PHASES = ("TRAIN", "VAL")

    def __init__(self, config: Config, options: Optional[Options] = None,
                 workdir: Optional[str] = None,
                 device: torch.device | str = "cpu") -> None:
        self.config = config
        self.options = options or Options()
        self.workdir = workdir
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available")
        if self.options.tensorboard or self.options.tbEveryNBatches:
            raise NotImplementedError(
                "TensorBoard logging is not yet ported, see ROADMAP.md")
        self.dtype = dtype_of(config.compute_dtype)
        model, self.spec = get_model(config, self.dtype)
        self.model = model.to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed)
        self.sample_generator: Optional[torch.Generator] = None
        if "sample" in self.spec.rngs:
            self.sample_generator = torch.Generator(
                device=self.device).manual_seed(config.seed + 1)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0
        self.history: List[Dict[str, Any]] = []
        self.tv_lambda_value = float(config.tv_lambda)
        self.streamed_last_epoch = False

    # ------------------------------------------------------------------
    # state init

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> nn.Module:
        """Glorot-uniform weights, zero biases, BatchNorm at scale 1, bias
        0 and running statistics (0, 1), drawn on the CPU from
        ``generator`` (default: seeded with ``config.seed``).  Also starts
        a fresh optimizer, step count and random streams."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.config.seed)
        with torch.no_grad():
            for module in self.model.modules():
                if isinstance(module, nn.BatchNorm2d):
                    module.reset_parameters()
                elif isinstance(module, (nn.Conv2d, nn.ConvTranspose2d,
                                         nn.Linear)):
                    w = torch.empty(module.weight.shape)
                    nn.init.xavier_uniform_(w, generator=generator)
                    module.weight.copy_(w)
                    module.bias.zero_()
        self.optimizer = self.make_optimizer()
        self.step = 0
        self.generator.manual_seed(self.config.seed)
        if self.sample_generator is not None:
            self.sample_generator.manual_seed(self.config.seed + 1)
        print(f"[{self.__class__.__name__}] {self.config.model}: "
              f"{count_params(self.model):,} parameters")
        return self.model

    def make_optimizer(self) -> torch.optim.Optimizer:
        return make_optimizer(self.config, self.model.parameters())

    # ------------------------------------------------------------------
    # steps

    def maybe_add_instance_noise(self, batch: Batch, train: bool) -> Batch:
        """Optional N(0, 0.01) instance noise on training inputs, drawn
        from the trainer's generator."""
        if not train or not self.options.addInstanceNoise:
            return batch
        x = batch["x"]
        noise = torch.randn(x.shape, generator=self.generator,
                            device=x.device, dtype=x.dtype)
        return {**batch, "x": x + 0.01 * noise}

    def model_inputs(self, batch: Batch, train: bool
                     ) -> Tuple[torch.Tensor, ...]:
        """Positional inputs of the model call (the context-encoder
        trainers add or substitute a masked image)."""
        return (batch["x"],)

    def apply_model(self, batch: Batch, train: bool
                    ) -> Tuple[Dict[str, Any], Tuple[torch.Tensor, ...]]:
        """Forward in train mode (dropout from the trainer's generator,
        batch statistics) or eval mode (no dropout, running statistics);
        ``eps`` from the sample generator in both.  Returns the outputs and
        the model's inputs.  Instance noise reaches the model's input only:
        the losses see the clean batch."""
        inputs = self.model_inputs(
            self.maybe_add_instance_noise(batch, train), train)
        self.model.train(train)
        outputs = self.model(
            *inputs, dropout_generator=self.generator if train else None,
            sample=self.sample_generator)
        return outputs, inputs

    def compute_losses(self, outputs: Dict[str, torch.Tensor],
                       batch: Batch) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def compute_losses_with_inputs(self, outputs: Dict[str, torch.Tensor],
                                   batch: Batch,
                                   inputs: Tuple[torch.Tensor, ...]
                                   ) -> Dict[str, torch.Tensor]:
        """The losses, given also the inputs the model was called with;
        ``compute_losses`` unless a trainer needs them."""
        return self.compute_losses(outputs, batch)

    @staticmethod
    def _scalar_metrics(losses: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in losses.items() if v.ndim == 0}

    def train_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """Forward, backward and one optimizer step."""
        outputs, inputs = self.apply_model(batch, train=True)
        losses = self.compute_losses_with_inputs(outputs, batch, inputs)
        self.optimizer.zero_grad(set_to_none=True)
        losses["loss"].backward()
        self.optimizer.step()
        self.step += 1
        return self._scalar_metrics(losses)

    @torch.no_grad()
    def val_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        outputs, inputs = self.apply_model(batch, train=False)
        return self._scalar_metrics(
            self.compute_losses_with_inputs(outputs, batch, inputs))

    @classmethod
    def check_phase(cls, phase: str) -> str:
        if phase not in cls.VALID_PHASES:
            raise ValueError(
                f"unknown phase {phase!r}; expected one of "
                f"{cls.VALID_PHASES} (phase strings are case-sensitive)")
        return phase

    # ------------------------------------------------------------------
    # fit loop

    def _pool_from_dataset(self, dataset, split: str) -> Optional[Batch]:
        """Slice pool of a split (with its brain masks for the
        context-encoder trainers): numpy on the host when it streams,
        tensors on the trainer's device otherwise."""
        arr = dataset.slices(split)
        if arr is None or len(arr) == 0:
            return None
        pool = {"x": np.asarray(arr, np.float32)}
        if self.needs_brainmask:
            pool["mask"] = np.asarray(dataset.brainmasks(split), np.float32)
        if self._stream_pool(pool):
            return pool
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in pool.items()}

    def _stream_pool(self, host_pool: Dict[str, np.ndarray]) -> bool:
        o = self.options
        if o.streamPool:
            return True
        nbytes = sum(v.nbytes for v in host_pool.values())
        return nbytes > float(o.streamPoolThresholdMB) * 2 ** 20

    def _run_epoch(self, phase: str, pool: Batch, idxs: np.ndarray
                   ) -> Dict[str, torch.Tensor]:
        """One TRAIN or VAL epoch; returns the per-batch metric means as
        device tensors.  A host pool streams: each chunk of
        ``streamPoolChunkBatches`` batches is gathered on the host in batch
        order, uploaded, and run over local indices."""
        step = self.train_step if self.check_phase(phase) == "TRAIN" \
            else self.val_step
        log_n = int(self.options.logEveryNBatches) if phase == "TRAIN" else 0
        if not isinstance(pool["x"], np.ndarray):
            self.streamed_last_epoch = False
            sums = run_epoch(step, pool, idxs, log_every_n=log_n,
                             first_step=self.step)
        else:
            self.streamed_last_epoch = True
            chunk = max(1, int(self.options.streamPoolChunkBatches))
            sums = None
            for i in range(0, len(idxs), chunk):
                rows = idxs[i:i + chunk]
                flat = rows.reshape(-1)
                cpool = {k: torch.from_numpy(v[flat]).to(self.device)
                         for k, v in pool.items()}
                local = np.arange(flat.size).reshape(rows.shape)
                sums = run_epoch(step, cpool, local, sums,
                                 log_every_n=log_n, first_step=self.step)
        return {k: v / len(idxs) for k, v in sums.items()}

    def _profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    def fit(self, dataset, resume: bool = True) -> nn.Module:
        """Epoch loop with VAL early stopping and per-epoch checkpoints;
        returns the trained model."""
        c = self.config
        if c.debugNaN:
            torch.autograd.set_detect_anomaly(True)
        if self.optimizer is None:
            self.init_state()
        start_epoch = 0
        best_cost, last_improvement = float("inf"), 0
        if resume and self.workdir:
            restored = self.restore_training_checkpoint()
            if restored is not None:
                start_epoch = restored
                # replay the VAL history so the early-stopping counters
                # survive resume
                curves = os.path.join(self.workdir, "curves.json")
                if os.path.isfile(curves):
                    with open(curves) as f:
                        self.history = json.load(f)
                already_stopped = False
                for h in self.history:
                    if (h.get("phase") == "VAL"
                            and h.get("epoch", 1 << 30) < start_epoch):
                        (best_cost, last_improvement,
                         stop) = early_stopping_update(
                            h.get(self.early_stop_metric, float("inf")),
                            best_cost, last_improvement,
                            c.earlyStoppingPatience)
                        already_stopped = already_stopped or stop
                if already_stopped:
                    print(f"[{c.trainer}] resume: early stopping already "
                          f"triggered at epoch {start_epoch - 1}; nothing "
                          "left to train")
                    self.post_fit(dataset)
                    return self.model

        train_pool = self._pool_from_dataset(dataset, "TRAIN")
        val_pool = self._pool_from_dataset(dataset, "VAL")
        if train_pool is None:
            raise ValueError(
                "training split is empty — check the dataset partition and "
                "slice range (sliceStart/sliceEnd vs volume depth)")
        n_train = int(train_pool["x"].shape[0])
        if isinstance(train_pool["x"], np.ndarray):
            mb = sum(v.nbytes for v in train_pool.values()) / 2 ** 20
            print(f"[stream-pool] training pool ({mb:.0f} MB) streams in "
                  f"chunks of {self.options.streamPoolChunkBatches} batches")

        for epoch in range(start_epoch, self.num_epochs()):
            t0 = time.time()
            # the data order is a pure function of (seed, epoch), so
            # training is deterministic across checkpoint-resume
            host_rng = np.random.default_rng((c.seed + 1, epoch))
            idxs = epoch_indices(host_rng, n_train, c.batchsize)
            if idxs.size == 0:
                raise ValueError(
                    f"batchsize {c.batchsize} exceeds the training pool of "
                    f"{n_train} slices — no full batch can be formed")
            prof = None
            if self.options.profileDir and epoch == start_epoch:
                prof = self._profiler()
                prof.__enter__()
            metrics = self._run_epoch("TRAIN", train_pool, idxs)
            metrics = {k: float(v) for k, v in metrics.items()}
            if prof is not None:
                prof.__exit__(None, None, None)
                os.makedirs(self.options.profileDir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    self.options.profileDir, f"epoch_{epoch}.trace.json"))
            dt = time.time() - t0
            sps = idxs.size / max(dt, 1e-9)
            print(f"Epoch (train): [{epoch:3d}] "
                  + " ".join(f"{k}: {v:.6f}" for k, v in sorted(
                      metrics.items()))
                  + f" ({sps:,.0f} slices/s)")
            self.history.append({"epoch": epoch, "phase": "TRAIN", **metrics})

            stop = False
            if val_pool is not None:
                vidx = epoch_indices(host_rng, int(val_pool["x"].shape[0]),
                                     c.batchsize, shuffle=False)
                if vidx.size:
                    vmetrics = {k: float(v) for k, v in self._run_epoch(
                        "VAL", val_pool, vidx).items()}
                    print(f"Epoch (val):   [{epoch:3d}] "
                          + " ".join(f"{k}: {v:.6f}"
                                     for k, v in sorted(vmetrics.items())))
                    self.history.append(
                        {"epoch": epoch, "phase": "VAL", **vmetrics})
                    best_cost, last_improvement, stop = early_stopping_update(
                        vmetrics.get(self.early_stop_metric, float("inf")),
                        best_cost, last_improvement, c.earlyStoppingPatience)

            # checkpoint after the VAL pass: the saved generator state is
            # the stream the next epoch starts from, so a killed and
            # resumed run reproduces an uninterrupted one bit for bit
            if self.workdir and (epoch + 1) % c.snapshotEveryEpochs == 0:
                self.save_checkpoint(epoch + 1)
            if stop:
                print("Early stopping was triggered due to no improvement "
                      f"over the last {c.earlyStoppingPatience} epochs")
                break

        self.post_fit(dataset)
        return self.model

    def num_epochs(self) -> int:
        return self.config.numEpochs

    def post_fit(self, dataset) -> None:
        """Hook after training (the restoration trainers' lambda sweep)."""

    def determine_best_lambda(self, dataset) -> float:
        """The ``tv_lambda`` in {0.0, 0.1, .., 1.9} whose restoration of 20 %
        of the VAL batches has the least mean sum |x - restored| per batch;
        written to ``<workdir>/tv_lambda.json``.  Needs the trainer's
        ``_restoration_fn``.

        The JAX package restores each (lambda, batch) pair in turn.  Here
        the pairs restore together, up to ``SWEEP_CHUNK_SLICES`` slices at
        a time, each slice under its own lambda: the objective is a sum of
        per-sample terms, so the errors equal the sequential ones up to
        summation order."""
        c = self.config
        arr = dataset.slices("VAL")
        bs = min(c.batchsize, len(arr))
        if bs == 0:
            print("determine_best_lambda: empty VAL split, keeping lambda")
            return self.tv_lambda_value
        n_batches = max(1, int((len(arr) // bs) * 0.2))
        x = torch.from_numpy(np.asarray(arr[: n_batches * bs],
                                        np.float32)).to(self.device)
        lambdas = torch.arange(20, dtype=torch.float32,
                               device=self.device) / 10.0
        t0 = time.perf_counter()
        errors = self.lambda_sweep_errors(x, lambdas, n_batches)
        best = float(lambdas[torch.argmin(errors)])
        sweep_s = time.perf_counter() - t0
        self.tv_lambda_value = best
        print(f"Best lambda: {best} (sweep: {len(lambdas)} lambdas x "
              f"{len(x)} slices x {c.restore_steps} steps in "
              f"{sweep_s:.2f} s)")
        if self.workdir:
            with open(os.path.join(self.workdir, "tv_lambda.json"),
                      "w") as f:
                json.dump({"tv_lambda_value": best}, f)
        return best

    def lambda_sweep_errors(self, x: torch.Tensor, lambdas: torch.Tensor,
                            n_batches: int) -> torch.Tensor:
        """(len(lambdas),) mean over the ``n_batches`` batches of x of
        sum |x - restored| per batch.

        The (lambda, batch) pairs (lambda-major) restore together, as many
        whole pairs per restoration as fit in ``SWEEP_CHUNK_SLICES``, so
        device memory stays bounded whatever the size of VAL.  Each pair
        draws its eps from its own generator seeded 0, as each of the JAX
        package's sequential restorations uses ``key(0)``; the objective is
        per sample, so the errors do not depend on the chunk size."""
        c = self.config
        bs = x.shape[0] // n_batches
        pairs = [(lam, b) for lam in range(len(lambdas))
                 for b in range(n_batches)]
        per_chunk = max(1, SWEEP_CHUNK_SLICES // bs)
        self.model.eval()
        errs = []
        for i in range(0, len(pairs), per_chunk):
            chunk = pairs[i:i + per_chunk]
            xs = torch.cat([x[b * bs:(b + 1) * bs] for _, b in chunk])
            lam = lambdas[[lam for lam, _ in chunk]].repeat_interleave(bs)
            source = VolumeGenerators(
                [torch.Generator(device=self.device).manual_seed(0)
                 for _ in chunk], [bs] * len(chunk), bs)
            restored = restore_inputs(
                self._restoration_fn(False), xs, lam, c.restore_lr,
                c.restore_steps, source)
            errs.append(L.sum_per_sample(torch.abs(xs - restored)))
        err = torch.cat(errs)
        return err.reshape(len(lambdas), n_batches, bs).sum(2).mean(1)

    # ------------------------------------------------------------------
    # checkpoints

    def save_checkpoint(self, epoch: Optional[int] = None) -> str:
        """Write ``<workdir>/torch/model.pt`` and ``<workdir>/config.json``;
        with ``epoch``, also the full checkpoint of that epoch (keeping the
        newest ``keepCheckpoints``), ``curves.json`` and ``Curves.npy``."""
        path = os.path.join(self.workdir, CHECKPOINT)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _atomic_save(self.model.state_dict(), path)
        with open(os.path.join(self.workdir, "config.json"), "w") as f:
            f.write(self.config.to_json())
        if epoch is None:
            return path
        ckpt_dir = os.path.join(self.workdir, CHECKPOINT_DIR)
        os.makedirs(ckpt_dir, exist_ok=True)
        _atomic_save({
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "generator": self.generator.get_state(),
            **({"sample_generator": self.sample_generator.get_state()}
               if self.sample_generator is not None else {}),
            "step": int(self.step),
            "epoch": int(epoch),
        }, os.path.join(ckpt_dir, f"epoch_{epoch:06d}.pt"))
        for old in self._epoch_checkpoints()[:-max(
                1, int(self.config.keepCheckpoints))]:
            os.remove(old[1])
        with open(os.path.join(self.workdir, "curves.json"), "w") as f:
            json.dump(self.history, f)
        # Curves.npy: "<PHASE>/<metric>" -> per-epoch values, loaded with
        # np.load(..., allow_pickle=True).item()
        curves: Dict[str, list] = {}
        for h in self.history:
            phase = h.get("phase", "TRAIN")
            for k, v in h.items():
                if isinstance(v, (int, float)) and k != "epoch":
                    curves.setdefault(f"{phase}/{k}", []).append(v)
        np.save(os.path.join(self.workdir, "Curves.npy"),
                np.asarray(curves, dtype=object))
        return path

    def _epoch_checkpoints(self) -> List[tuple]:
        """[(epoch, path)] of the full checkpoints, oldest first."""
        if not self.workdir:
            return []
        found = []
        for p in glob.glob(os.path.join(self.workdir, CHECKPOINT_DIR,
                                        "epoch_*.pt")):
            m = _EPOCH_FILE.search(p)
            if m:
                found.append((int(m.group(1)), p))
        return sorted(found)

    def _load_tv_lambda(self) -> None:
        """A swept ``tv_lambda`` survives into fresh processes."""
        lam_path = os.path.join(self.workdir, "tv_lambda.json")
        if os.path.isfile(lam_path):
            with open(lam_path) as f:
                self.tv_lambda_value = float(json.load(f)["tv_lambda_value"])
            print(f"Restored swept tv_lambda={self.tv_lambda_value}")

    def load_checkpoint(self) -> Optional[nn.Module]:
        """Load ``<workdir>/torch/model.pt`` into the model (serving); None
        if the workdir holds no port checkpoint."""
        if not self.workdir:
            return None
        path = os.path.join(self.workdir, CHECKPOINT)
        if not os.path.isfile(path):
            return None
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state)
        print(f"Restored checkpoint {path}")
        self._load_tv_lambda()
        return self.model

    def restore_training_checkpoint(self) -> Optional[int]:
        """Load the newest full checkpoint (model, optimizer, generator,
        step); returns its epoch, or None if there is none."""
        found = self._epoch_checkpoints()
        if not found:
            return None
        epoch, path = found[-1]
        # CPU first: the generator state must be a CPU ByteTensor; the
        # model and optimizer copy their tensors onto the parameters' device
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(ckpt["model"])
        if self.optimizer is None:
            self.optimizer = self.make_optimizer()
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.generator.set_state(ckpt["generator"])
        if self.sample_generator is not None:
            self.sample_generator.set_state(ckpt["sample_generator"])
        self.step = int(ckpt["step"])
        print(f"Restored checkpoint at epoch {epoch}")
        self._load_tv_lambda()
        return int(ckpt["epoch"])

    # ------------------------------------------------------------------
    # reconstruction (evaluation API)

    def _eval_generator(self, generator: Optional[Sample]) -> Sample:
        """The random source of a reconstruction: as given, or a generator
        on the trainer's device seeded 0 (the JAX package's key(0))."""
        if generator is not None:
            return generator
        return torch.Generator(device=self.device).manual_seed(0)

    def _slices(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim < 4:
            x = x[None]
        return x.to(self.device, torch.float32)

    def _call(self, inputs: Sequence[torch.Tensor], dropout: bool,
              generator: Sample) -> Dict[str, torch.Tensor]:
        """Eval-mode forward; ``generator`` draws the dropout masks (when
        ``dropout``) and ``eps``."""
        self.model.eval()
        return self.model(*inputs,
                          dropout_generator=generator if dropout else None,
                          sample=generator)

    @torch.no_grad()
    def reconstruct_device(self, x: torch.Tensor, dropout: bool = False,
                           generator: Optional[Sample] = None
                           ) -> Dict[str, torch.Tensor]:
        """Reconstruct a batch of (B, H, W, C) slices on the trainer's
        device in eval mode, as one batch; with ``dropout`` (MC sampling)
        dropout masks are drawn from ``generator``, which also draws the
        VAEs' ``eps`` (default: a generator seeded 0).  A tensor given as
        ``generator`` is the noise itself (``eps`` only).  Returns
        ``reconstruction`` plus every model output."""
        x = self._slices(x)
        outputs = self._call(self.model_inputs({"x": x}, train=False),
                             dropout, self._eval_generator(generator))
        return {"reconstruction": outputs[self.spec.reconstruction_key],
                **outputs}

    def batched_volume_restoration(self) -> bool:
        """True when ``reconstruct_volumes_device`` restores a stack of
        volumes in one restoration (the evaluator then groups volumes)."""
        return False

    def reconstruct(self, x) -> Dict[str, Any]:
        """Reconstruct a batch of slices; numpy ``reconstruction`` and every
        model output, plus the float ``l1err`` (sum |x - rec|) and
        ``l2err`` (sum sqrt((x - rec)^2))."""
        x = np.asarray(x, np.float32)
        if x.ndim < 4:
            x = x[None]
        out = self.reconstruct_device(torch.from_numpy(x))
        res = {k: v.cpu().numpy() for k, v in out.items()}
        rec = res["reconstruction"].astype(np.float32)
        res["l1err"] = float(np.sum(np.abs(x - rec)))
        res["l2err"] = float(np.sum(np.sqrt((x - rec) ** 2)))
        return res


def _atomic_save(obj: Any, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class AE(BaseTrainer):
    """L1 autoencoder."""

    def compute_losses(self, outputs, batch):
        rec = L.l1_recon_sum(batch["x"], outputs["x_hat"])
        return {"loss": rec, "reconstructionLoss": rec}


class VAE(BaseTrainer):
    """VAE: per-sample L1 plus the analytic KL."""

    def compute_losses(self, outputs, batch):
        out = L.vae_loss(batch["x"], outputs)
        return {k: v for k, v in out.items() if k != "pixel_loss"}


class VAE_You(VAE):
    """VAE whose reconstruction is the input restored by ``restore_steps``
    steps of gradient descent on pixel loss + ``tv_lambda`` x TV, with
    ``tv_lambda`` swept after training when the config leaves it negative."""

    def post_fit(self, dataset) -> None:
        if self.tv_lambda_value < 0:
            self.determine_best_lambda(dataset)

    def _restoration_fn(self, dropout: bool):
        """(x, generator) -> (per-sample L1 + KL, x_hat) from ONE eval-mode
        forward; ``dropout`` draws dropout masks too (MC sampling)."""

        def outputs_fn(x: torch.Tensor, generator: Sample):
            out = self._call((x,), dropout, generator)
            rec = L.sum_per_sample(L.l1_elem(x, out["x_hat"]))
            return rec + L.vae_kl(out["z_mu"], out["z_sigma"]), out["x_hat"]

        return outputs_fn

    def _restore(self, x: torch.Tensor, dropout: bool,
                 generator: Sample) -> torch.Tensor:
        c = self.config
        return restore_inputs(self._restoration_fn(dropout), x,
                              max(self.tv_lambda_value, 0.0), c.restore_lr,
                              c.restore_steps, generator)

    def reconstruct_device(self, x, dropout=False, generator=None):
        """The restored input (``tv_lambda`` clamped at 0)."""
        return {"reconstruction": self._restore(
            self._slices(x), dropout, self._eval_generator(generator))}

    def batched_volume_restoration(self) -> bool:
        return self.config.restore_steps > 0

    def reconstruct_volumes_device(self, vols: torch.Tensor,
                                   dropout: bool = False,
                                   generators: Sequence[torch.Generator] = (),
                                   counts: Optional[Sequence[int]] = None
                                   ) -> Dict[str, torch.Tensor]:
        """Restore K volumes stacked as (K, S, H, W, C) in one restoration
        of K x S slices.  Volume k has ``counts[k]`` real slices (default
        all S) and its own generator: its draws are made at its real shape
        (``VolumeGenerators``), and the objective is per sample, so each
        volume's result equals a ``reconstruct_device`` call on it alone
        with that generator.  Padding slices are restored too and are the
        caller's to crop."""
        K, S = vols.shape[:2]
        counts = [S] * K if counts is None else list(counts)
        source = VolumeGenerators(generators, counts, S)
        flat = vols.reshape((K * S,) + tuple(vols.shape[2:]))
        restored = self._restore(flat.to(self.device, torch.float32),
                                 dropout, source)
        return {"reconstruction": restored.reshape(vols.shape)}


class CE(BaseTrainer):
    """Context-encoder AE: trained on context-masked inputs, with the L1
    loss against the clean image."""

    needs_brainmask = True

    def model_inputs(self, batch, train):
        if train and "mask" in batch:
            return (random_context_masks(self.generator, batch["x"],
                                         batch["mask"]),)
        return (batch["x"],)

    def compute_losses(self, outputs, batch):
        rec = L.l1_recon_sum(batch["x"], outputs["x_hat"])
        return {"loss": rec, "reconstructionLoss": rec}


class CeVAE(BaseTrainer):
    """ceVAE: VAE loss on the clean branch plus L1 of the context branch;
    with ``use_gradient_based_restoration`` = lambda > 0 the reconstruction
    is ``x - lambda * |x - x_hat| * |d loss_vae / dx|``."""

    needs_brainmask = True

    def model_inputs(self, batch, train):
        x = batch["x"]
        if train and "mask" in batch:
            return (x, random_context_masks(self.generator, x,
                                            batch["mask"]))
        return (x, x)

    def compute_losses_with_inputs(self, outputs, batch, inputs):
        # L1_ce targets the model's second input: the masked image in
        # TRAIN, the clean one in VAL
        return L.cevae_loss(batch["x"], inputs[1], outputs)

    def reconstruct_device(self, x, dropout=False, generator=None):
        lam = float(self.config.use_gradient_based_restoration)
        if lam <= 0:
            return super().reconstruct_device(x, dropout, generator)
        x = self._slices(x)
        generator = self._eval_generator(generator)

        def outputs_fn(xi: torch.Tensor):
            out = self._call((xi, xi), dropout, generator)
            rec = L.sum_per_sample(L.l1_elem(xi, out["x_hat"]))
            return rec + L.vae_kl(out["z_mu"], out["z_sigma"]), out["x_hat"]

        anomaly, _ = gradient_anomaly_map(outputs_fn, x)
        return {"reconstruction": x - lam * anomaly}
