"""Trainer base and the ``AE`` trainer: init, training, checkpoints,
reconstruction.

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
  * the slice pool lives on the device; pools above
    ``Options.streamPoolThresholdMB`` (or with ``streamPool``) stay on the
    host and stream in chunks of ``streamPoolChunkBatches`` batches, with
    the same updates bit for bit;
  * the sidecars ``config.json``, ``curves.json``, ``Curves.npy`` and
    ``tv_lambda.json``.

Checkpoints: ``<workdir>/torch/model.pt`` holds the weights that serving
loads (a ``state_dict``).  Beside it ``<workdir>/torch/ckpt/epoch_NNNNNN.pt``
holds the full state after an epoch (model, optimizer, dropout-generator
state, global step, epoch); the newest ``keepCheckpoints`` are kept.  All
are loaded with ``weights_only=True``.

Random streams: weights are drawn from a CPU generator seeded with
``config.seed`` (Glorot uniform); dropout and instance noise from one
``torch.Generator`` on the trainer's device, seeded with ``config.seed``.
JAX's threefry streams have no torch counterpart, so dropout masks differ
between the packages (trajectories are compared at ``dropout_rate=0``).
"""

from __future__ import annotations

import glob
import json
import os
import re
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from unsupervised_anomaly_detection_brain_mri_tpu.config import Config, Options
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.registry import (
    get_model,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
    losses as L,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.engine import (
    early_stopping_update,
    epoch_indices,
    run_epoch,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.state import (
    make_optimizer,
)

CHECKPOINT = os.path.join("torch", "model.pt")
CHECKPOINT_DIR = os.path.join("torch", "ckpt")
_EPOCH_FILE = re.compile(r"epoch_(\d+)\.pt$")

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
        a fresh optimizer, step count and dropout stream."""
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

    def apply_model(self, batch: Batch, train: bool) -> Dict[str, Any]:
        """Forward in train mode (dropout from the trainer's generator,
        batch statistics) or eval mode (no dropout, running statistics).
        Instance noise reaches the model's input only: the losses see the
        clean batch."""
        inputs = self.maybe_add_instance_noise(batch, train)
        self.model.train(train)
        return self.model(inputs["x"], self.generator if train else None)

    def compute_losses(self, outputs: Dict[str, torch.Tensor],
                       batch: Batch) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    @staticmethod
    def _scalar_metrics(losses: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in losses.items() if v.ndim == 0}

    def train_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """Forward, backward and one optimizer step."""
        outputs = self.apply_model(batch, train=True)
        losses = self.compute_losses(outputs, batch)
        self.optimizer.zero_grad(set_to_none=True)
        losses["loss"].backward()
        self.optimizer.step()
        self.step += 1
        return self._scalar_metrics(losses)

    @torch.no_grad()
    def val_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        outputs = self.apply_model(batch, train=False)
        return self._scalar_metrics(self.compute_losses(outputs, batch))

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
        """Slice pool of a split: numpy on the host when it streams,
        tensors on the trainer's device otherwise."""
        arr = dataset.slices(split)
        if arr is None or len(arr) == 0:
            return None
        pool = {"x": np.asarray(arr, np.float32)}
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
        self.step = int(ckpt["step"])
        print(f"Restored checkpoint at epoch {epoch}")
        self._load_tv_lambda()
        return int(ckpt["epoch"])

    # ------------------------------------------------------------------
    # reconstruction (evaluation API)

    @torch.no_grad()
    def reconstruct_device(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Reconstruct a batch of (B, H, W, C) slices on the trainer's
        device in eval mode, without dropout, as one batch.  Returns
        ``reconstruction`` plus every model output."""
        if x.ndim < 4:
            x = x[None]
        self.model.eval()
        outputs = self.model(x.to(self.device, torch.float32))
        return {"reconstruction": outputs[self.spec.reconstruction_key],
                **outputs}

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
