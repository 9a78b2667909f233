"""Trainer base and the single-optimizer trainers (``AE``, ``VAE``,
``VAE_You``, ``CE``, ``ceVAE``, ``GMVAE``, ``GMVAE_spatial``,
``ConstrainedAE``): init, training, checkpoints, reconstruction, input
restoration.  The adversarial trainers are in ``train/gan.py``.

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
    recognises an already-triggered stop; the hooks ``validation_enabled``,
    ``early_stopping_enabled`` and ``phase_tag`` (the TRAIN entries'
    label, ``TRAIN_WGAN`` and ``TRAIN_Encoder`` for ``fAnoGAN``);
  * the slice pool (with the brain masks of the context-encoder trainers)
    lives on the device; pools above ``Options.streamPoolThresholdMB`` (or
    with ``streamPool``) stay on the host and stream in chunks of
    ``streamPoolChunkBatches`` batches, with the same updates bit for bit;
  * the model's inputs come from ``model_inputs`` (a context-masked copy
    for ``CE`` and ``ceVAE`` in TRAIN, a prior latent for the adversarial
    models) and the losses may see them (``compute_losses_with_inputs``);
  * the ``tv_lambda`` sweep of ``VAE_You`` and the GMVAEs after training,
    written to ``tv_lambda.json``: the (lambda, slice) pairs restore
    together, up to ``SWEEP_CHUNK_SLICES`` slices at a time, each with its
    own lambda, since the restoration objective is per sample;
  * the sidecars ``config.json``, ``curves.json``, ``Curves.npy`` and
    ``tv_lambda.json``.

Checkpoints: ``<workdir>/torch/model.pt`` holds the weights that serving
loads (a ``state_dict``).  Beside it ``<workdir>/torch/ckpt/epoch_NNNNNN.pt``
holds the full state after an epoch (model, optimizer, generator states,
global step, epoch); the newest ``keepCheckpoints`` are kept.  All are
loaded with ``weights_only=True``.  ``fit`` sets ``epoch`` before each
TRAIN pass, for the trainers whose step depends on it (``AAE``).

Data parallelism (``mesh=``, a ``parallel.MeshContext`` of more than one
rank; the JAX package's SPMD mesh): one process per device, each holding
the whole model (broadcast from rank 0 by ``init_state``).  Every rank
builds the same pool and the same seeded batch order and runs its
contiguous ``batchsize / n_data`` rows of each batch; BatchNorm's
statistics are the whole batch's (``models/layers.py::Norm``); gradients
are averaged over the ranks in one flat buffer before each optimizer step
(``parallel.collectives.psum_mean_grads``), and the epoch's metrics before
early stopping decides; every draw (dropout, eps, context masks, instance
noise, prior latents) is made for the global batch from the trainer's
generators and cut to the rank's rows (``ShardedSource``), so a step equals
the one-process step on the whole batch.  ``reconstruct_device`` and
``reconstruct_volumes_device`` split their batch (padded by
``pad_batch_to``) over the ranks and return the whole result on every
rank.  Rank 0 writes the checkpoints and sidecars; the others wait for it.
A one-rank mesh runs the one-process path.

Tensor parallelism (a mesh with ``n_model`` > 1, reached through the API as
in the JAX package, whose CLI never sets it): the trainer makes the model's
wide layers column parallel (``parallel/sharding.py::shard_model``), so
each rank holds its model index's rows of their weights and of their Adam
moments, and everything else replicated.  The ranks of one model group
take the same rows (by their data index: every row split, draw and
collective above is over the data group), so their activations and draws
agree; ``init_state`` draws each weight whole and keeps the rank's rows,
as one process's init would; checkpoints are gathered into whole tensors
before the writer saves them and cut again on load, so they load the same
with or without tensor parallelism.

TensorBoard (``Options.tensorboard`` with a workdir): the writer rank
logs each epoch's metrics per phase and an image grid of the pool's first
8 slices to ``<workdir>/logs/{train,val}`` (``utils/logger.py``), and with
``tbEveryNBatches`` = n every n-th global step's metrics as
``batch/<metric>`` and the grid of the batch's first 8 slices.  The grid's
eval-mode forward runs on every rank (a tensor-parallel forward is
collective).

Tracing (``utils/trace.py``): under ``trace.recording()`` an epoch is a
``train.epoch`` span and ``train_step`` splits into ``train.forward``
(model and losses), ``train.backward`` (zero_grad, backward, the mesh's
gradient mean) and ``train.optimizer``.  ``Options.profileDir`` writes a
chrome trace of the first epoch that names these spans beside the kernels
they launch.

Random streams: weights are drawn from a CPU generator seeded with
``config.seed`` (Glorot uniform).  Training draws dropout, instance noise
and context masks from ``generator`` on the trainer's device, seeded with
``config.seed``, the VAEs' and GMVAEs' normals (in TRAIN and VAL) from
``sample_generator``, seeded with ``config.seed + 1`` (models whose spec
has a ``sample`` stream), and the critic interpolate's eps from
``gp_generator``, seeded with ``config.seed + 2`` (a ``gp`` stream).
Reconstruction takes its own source (``reconstruct_device(...,
generator=)``, a generator seeded 0 by default), which drives dropout, the
model's noise and the inputs' draws (a prior latent).  JAX's threefry streams
have no torch counterpart, so the draws differ between the packages
(trajectories are compared at ``dropout_rate=0`` with given noise).
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import Config, Options
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    Norm,
    Sample,
    ShardedSource,
    SpatialLayerNorm,
    VolumeGenerators,
    draw,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.registry import (
    get_model,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.collectives import (
    all_gather_batch,
    psum_mean,
    psum_mean_grads,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.mesh import (
    MeshContext,
    pad_batch_to,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.sharding import (
    count_full_params,
    cut,
    gather_like_params,
    gather_params,
    shard_like_params,
    shard_model,
    shard_params,
    whole_weight_shape,
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
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import trace
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils.logger import (
    Logger,
)

CHECKPOINT = os.path.join("torch", "model.pt")
CHECKPOINT_DIR = os.path.join("torch", "ckpt")
_EPOCH_FILE = re.compile(r"epoch_(\d+)\.pt$")
# slices per restoration of the lambda sweep: 1,280 slices of 128x128 in
# bf16 peak at 10.6 GiB of device memory on an H100
SWEEP_CHUNK_SLICES = 1280
# each generator's seed is config.seed + its offset
STREAM_SEED_OFFSETS = {"generator": 0, "sample_generator": 1,
                       "gp_generator": 2}

Batch = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def count_params(model: nn.Module) -> int:
    """Number of trainable parameters (BatchNorm statistics excluded, as in
    the JAX package's ``count_params`` over ``params``) of the whole model,
    also when its layers are sharded."""
    return count_full_params(model)


class BaseTrainer:
    """Model construction, seeded init, the fit loop, checkpoints and
    reconstruction."""

    early_stop_metric: str = "loss"
    needs_brainmask: bool = False
    VALID_PHASES = ("TRAIN", "VAL")

    def __init__(self, config: Config, options: Optional[Options] = None,
                 workdir: Optional[str] = None,
                 device: torch.device | str = "cuda",
                 mesh: Optional[MeshContext] = None) -> None:
        self.config = config
        self.options = options or Options()
        self.workdir = workdir
        self.mesh = mesh
        self.device = torch.device(mesh.device if mesh is not None
                                   else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available")
        self.dtype = dtype_of(config.compute_dtype)
        model, self.spec = get_model(config, self.dtype)
        self.model = model.to(self.device)
        if mesh is not None:
            shard_model(self.model, mesh)
        self.tensorboard = bool(self.options.tensorboard and workdir)
        self.logger = (Logger(os.path.join(workdir, "logs"))
                       if self.tensorboard and self.is_writer else None)
        if self.data_parallel:
            for module in self.model.modules():
                if isinstance(module, Norm):
                    module.mesh = mesh
        def stream(key: str, rng: Optional[str] = None
                   ) -> Optional[torch.Generator]:
            if rng is not None and rng not in self.spec.rngs:
                return None
            return torch.Generator(device=self.device).manual_seed(
                config.seed + STREAM_SEED_OFFSETS[key])

        self.generator: torch.Generator = stream("generator")
        self.sample_generator = stream("sample_generator", "sample")
        self.gp_generator = stream("gp_generator", "gp")
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0
        self.epoch = 0
        self.history: List[Dict[str, Any]] = []
        self.tv_lambda_value = float(config.tv_lambda)
        self.streamed_last_epoch = False

    @property
    def data_parallel(self) -> bool:
        """True under a mesh of more than one rank (a one-rank mesh runs
        the one-process path)."""
        return self.mesh is not None and self.mesh.parallel

    @property
    def is_writer(self) -> bool:
        """Whether this process writes files and logs (rank 0)."""
        return self.mesh is None or self.mesh.is_writer

    def _barrier(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()

    def _shard_source(self, source: Optional[Sample], local_rows: int
                      ) -> Optional[Sample]:
        """Under a data-parallel mesh, this rank's share of ``source`` for
        a batch of ``local_rows`` rows per rank (``ShardedSource``); the
        source itself otherwise."""
        if not self.data_parallel or source is None:
            return source
        start = self.mesh.data_index * local_rows
        return ShardedSource(source, local_rows * self.mesh.n_data, start,
                             start + local_rows)

    # ------------------------------------------------------------------
    # state init

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> nn.Module:
        """Glorot-uniform weights, zero biases, BatchNorm and LayerNorm at
        scale 1 and bias 0, running statistics (0, 1), drawn on the CPU from
        ``generator`` (default: seeded with ``config.seed``); a module's
        bare parameters (the GMVAEs' 0.1 bias) from its
        ``init_bare_parameters``.  Also starts a fresh optimizer, step
        count and random streams."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.config.seed)
        with torch.no_grad():
            for module in self.model.modules():
                if isinstance(module, (nn.BatchNorm2d, SpatialLayerNorm)):
                    module.reset_parameters()
                elif isinstance(module, (nn.Conv2d, nn.ConvTranspose2d,
                                         nn.Linear)):
                    # drawn whole, so a sharded layer keeps its rows of
                    # one process's weight
                    w = torch.empty(whole_weight_shape(module))
                    nn.init.xavier_uniform_(w, generator=generator)
                    if getattr(module, "tp", None) is not None:
                        w = cut(module.tp, w, module.tp_dim)
                    module.weight.copy_(w)
                    module.bias.zero_()
                if hasattr(module, "init_bare_parameters"):
                    module.init_bare_parameters()
        if self.data_parallel:
            self.mesh.replicate(self.model)
        self.optimizer = self.make_optimizer()
        self.step = 0
        for k, g in self._streams().items():
            g.manual_seed(self.config.seed + STREAM_SEED_OFFSETS[k])
        if self.is_writer:
            print(f"[{self.__class__.__name__}] {self.config.model}: "
                  f"{count_params(self.model):,} parameters")
        return self.model

    def make_optimizer(self) -> torch.optim.Optimizer:
        return make_optimizer(self.config, self.model.parameters())

    def _streams(self) -> Dict[str, torch.Generator]:
        """The trainer's generators by checkpoint key."""
        streams = {"generator": self.generator,
                   "sample_generator": self.sample_generator,
                   "gp_generator": self.gp_generator}
        return {k: g for k, g in streams.items() if g is not None}

    # ------------------------------------------------------------------
    # steps

    def maybe_add_instance_noise(self, batch: Batch, train: bool,
                                 source: Optional[Sample] = None) -> Batch:
        """Optional N(0, 0.01) instance noise on training inputs, drawn
        from ``source`` (default: the trainer's generator)."""
        if not train or not self.options.addInstanceNoise:
            return batch
        x = batch["x"]
        noise = draw(torch.randn, source or self.generator, x.shape,
                     x.device).to(x.dtype)
        return {**batch, "x": x + 0.01 * noise}

    def model_inputs(self, batch: Batch, train: bool,
                     generator: Optional[Sample] = None
                     ) -> Tuple[torch.Tensor, ...]:
        """Positional inputs of the model call (the context-encoder
        trainers add or substitute a masked image, the adversarial ones add
        a prior latent); their draws come from ``generator`` (default: the
        trainer's)."""
        return (batch["x"],)

    def _noise(self, sample: Optional[Sample], gp: Optional[Sample]
               ) -> Dict[str, Any]:
        """The model call's noise sources: ``sample``, and ``gp`` for the
        models with a ``gp`` stream."""
        kwargs = {"sample": sample}
        if "gp" in self.spec.rngs:
            kwargs["gp"] = gp
        return kwargs

    def apply_model(self, batch: Batch, train: bool
                    ) -> Tuple[Dict[str, Any], Tuple[torch.Tensor, ...]]:
        """Forward in train mode (dropout from the trainer's generator,
        batch statistics) or eval mode (no dropout, running statistics);
        the model's noise from the sample and gp generators in both.
        Returns the outputs and the model's inputs.  Instance noise reaches
        the model's input only: the losses see the clean batch.  Under a
        data-parallel mesh every draw is made for the global batch and cut
        to this rank's rows."""
        n = batch["x"].shape[0]
        g = self._shard_source(self.generator, n)
        inputs = self.model_inputs(
            self.maybe_add_instance_noise(batch, train, g), train, g)
        self.model.train(train)
        outputs = self.model(
            *inputs, dropout_generator=g if train else None,
            **self._noise(self._shard_source(self.sample_generator, n),
                          self._shard_source(self.gp_generator, n)))
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
        """Forward, backward and one optimizer step.  Under a data-parallel
        mesh ``batch`` is this rank's rows, the gradients are averaged over
        the group before the step, and the returned metrics are the
        rank's own."""
        with trace.span("train.forward"):
            outputs, inputs = self.apply_model(batch, train=True)
            losses = self.compute_losses_with_inputs(outputs, batch, inputs)
        with trace.span("train.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            losses["loss"].backward()
            if self.data_parallel:
                psum_mean_grads(self.mesh, self.model.parameters())
        with trace.span("train.optimizer"):
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
        order, uploaded, and run over local indices.  Under a data-parallel
        mesh each rank runs its contiguous columns of ``idxs`` (a batch
        size that does not split over the ranks raises), the means are
        averaged over the group, and rank 0 logs its own rows' metrics."""
        step = self.train_step if self.check_phase(phase) == "TRAIN" \
            else self.val_step
        log_n = int(self.options.logEveryNBatches) \
            if phase == "TRAIN" and self.is_writer else 0
        tb = dict(tb_every=int(self.options.tbEveryNBatches),
                  tb_hook=self._tb_batch_log) \
            if phase == "TRAIN" and self.tensorboard else {}
        with trace.span("train.epoch", phase=phase):
            if self.data_parallel:
                idxs = idxs[:, self.mesh.rows(idxs.shape[1])]
            if not isinstance(pool["x"], np.ndarray):
                self.streamed_last_epoch = False
                sums = run_epoch(step, pool, idxs, log_every_n=log_n,
                                 first_step=self.step, **tb)
            else:
                self.streamed_last_epoch = True
                chunk = max(1, int(self.options.streamPoolChunkBatches))
                sums = None
                for i in range(0, len(idxs), chunk):
                    rows = idxs[i:i + chunk]
                    flat = rows.reshape(-1)
                    cpool = {k: torch.from_numpy(v[flat]).to(self.device)
                             for k, v in pool.items()}
                    trace.count("host_syncs", len(cpool))
                    local = np.arange(flat.size).reshape(rows.shape)
                    sums = run_epoch(step, cpool, local, sums,
                                     log_every_n=log_n, first_step=self.step,
                                     **tb)
            means = {k: v / len(idxs) for k, v in sums.items()}
            if self.data_parallel:
                keys = sorted(means)
                means = dict(zip(keys, psum_mean(
                    self.mesh, torch.stack([means[k] for k in keys]))))
            return means

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
        if isinstance(train_pool["x"], np.ndarray) and self.is_writer:
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
            self.epoch = epoch
            prof = None
            with contextlib.ExitStack() as profiled:
                if self.options.profileDir and epoch == start_epoch:
                    prof = profiled.enter_context(self._profiler())
                    # the chrome trace names the port's spans beside the
                    # kernels they launch
                    profiled.enter_context(trace.recording(annotate=True))
                metrics = self._run_epoch("TRAIN", train_pool, idxs)
                trace.count("host_syncs", len(metrics))
                metrics = {k: float(v) for k, v in metrics.items()}
            if prof is not None:
                os.makedirs(self.options.profileDir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    self.options.profileDir, f"epoch_{epoch}.trace.json"))
            dt = time.time() - t0
            sps = idxs.size / max(dt, 1e-9)
            tag = self.phase_tag(epoch)
            if self.is_writer:
                print(f"Epoch (train{'' if tag == 'TRAIN' else ' ' + tag}): "
                      f"[{epoch:3d}] "
                      + " ".join(f"{k}: {v:.6f}" for k, v in sorted(
                          metrics.items()))
                      + f" ({sps:,.0f} slices/s)")
            self.history.append({"epoch": epoch, "phase": tag, **metrics})
            self.log_epoch(epoch, "TRAIN", metrics, train_pool)

            stop = False
            if val_pool is not None and self.validation_enabled(epoch):
                vidx = epoch_indices(host_rng, int(val_pool["x"].shape[0]),
                                     c.batchsize, shuffle=False)
                if vidx.size:
                    vmeans = self._run_epoch("VAL", val_pool, vidx)
                    trace.count("host_syncs", len(vmeans))
                    vmetrics = {k: float(v) for k, v in vmeans.items()}
                    if self.is_writer:
                        print(f"Epoch (val):   [{epoch:3d}] "
                              + " ".join(f"{k}: {v:.6f}" for k, v in
                                         sorted(vmetrics.items())))
                    self.history.append(
                        {"epoch": epoch, "phase": "VAL", **vmetrics})
                    self.log_epoch(epoch, "VAL", vmetrics, val_pool)
                    if self.early_stopping_enabled():
                        best_cost, last_improvement, stop = \
                            early_stopping_update(
                                vmetrics.get(self.early_stop_metric,
                                             float("inf")), best_cost,
                                last_improvement, c.earlyStoppingPatience)

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

    def _visual(self, x: torch.Tensor) -> torch.Tensor:
        """The image grid's reconstruction of slices ``x``: one plain
        eval-mode forward (a restoration trainer's restore loop is not
        run), with a generator seeded 0 for the model's draws."""
        return BaseTrainer._reconstruct(
            self, x.to(self.device, torch.float32), False,
            self._eval_generator(None))["reconstruction"]

    def _tb_batch_log(self, step: int, metrics: Dict[str, torch.Tensor],
                      batch: Batch) -> None:
        """The mid-epoch TensorBoard summary of global step ``step``: the
        step's scalars as ``batch/<metric>`` (separate tags from the epoch
        scalars, whose axis is the epoch) and the grid of the batch's first
        8 slices.  Under a mesh these are the writer's rows and metrics."""
        x = batch["x"][:8]
        rec = self._visual(x)
        if self.logger is None:
            return
        self.logger.log_scalars(step, {f"batch/{k}": float(v)
                                       for k, v in metrics.items()
                                       if v.ndim == 0}, "TRAIN")
        self.logger.log_visuals(step, x.cpu().numpy(), rec.cpu().numpy(),
                                "TRAIN")
        self.logger.flush()

    def log_epoch(self, epoch: int, phase: str, metrics: Dict[str, float],
                  pool: Optional[Batch]) -> None:
        """TensorBoard epoch logging: the epoch's scalars under ``phase``
        and the grid of the pool's first 8 slices in eval mode."""
        if not self.tensorboard:
            return
        rec = None
        if pool is not None and len(pool["x"]):
            x = pool["x"][:min(8, int(pool["x"].shape[0]))]
            x = torch.as_tensor(x)
            rec = self._visual(x)
        if self.logger is None:
            return
        self.logger.log_scalars(epoch, metrics, phase)
        if rec is not None:
            self.logger.log_visuals(epoch, x.cpu().numpy(),
                                    rec.cpu().numpy(), phase)
        self.logger.flush()

    def num_epochs(self) -> int:
        return self.config.numEpochs

    def early_stopping_enabled(self) -> bool:
        return True

    def validation_enabled(self, epoch: int) -> bool:
        """Whether the VAL pass runs after this epoch (``fAnoGAN`` skips
        it in its WGAN phase)."""
        return True

    def phase_tag(self, epoch: int) -> str:
        """The history's and the printed line's label of this epoch's
        training phase."""
        return "TRAIN"

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
        if self.workdir and self.is_writer:
            with open(os.path.join(self.workdir, "tv_lambda.json"),
                      "w") as f:
                json.dump({"tv_lambda_value": best}, f)
        self._barrier()
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
        per sample, so the errors do not depend on the chunk size.  Under a
        data-parallel mesh the pairs (padded to a multiple of the ranks)
        are split over the ranks and the errors gathered."""
        c = self.config
        bs = x.shape[0] // n_batches
        pairs = [(lam, b) for lam in range(len(lambdas))
                 for b in range(n_batches)]
        mine = pairs
        if self.data_parallel:
            idx = pad_batch_to(np.arange(len(pairs)), self.mesh.n_data)
            mine = [pairs[i] for i in idx[self.mesh.rows(len(idx))]]
        per_chunk = max(1, SWEEP_CHUNK_SLICES // bs)
        self.model.eval()
        errs = []
        for i in range(0, len(mine), per_chunk):
            chunk = mine[i:i + per_chunk]
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
        if self.data_parallel:
            err = all_gather_batch(self.mesh, err)[:len(pairs) * bs]
        return err.reshape(len(lambdas), n_batches, bs).sum(2).mean(1)

    # ------------------------------------------------------------------
    # checkpoints

    def save_checkpoint(self, epoch: Optional[int] = None) -> str:
        """Write ``<workdir>/torch/model.pt`` and ``<workdir>/config.json``;
        with ``epoch``, also the full checkpoint of that epoch (keeping the
        newest ``keepCheckpoints``), ``curves.json`` and ``Curves.npy``.
        Under a mesh rank 0 writes and the others wait for it; under tensor
        parallelism the shards are gathered into whole tensors first."""
        path = os.path.join(self.workdir, CHECKPOINT)
        model_state = self._whole_model_state()
        optimizer_state = (self._whole_optimizer_state()
                           if epoch is not None else None)
        if self.is_writer:
            self._write_checkpoint(path, epoch, model_state,
                                   optimizer_state)
        self._barrier()
        return path

    def _optimizers(self) -> Dict[str, torch.optim.Optimizer]:
        """The trainer's optimizers by ``state_dict`` key (one, unnamed, or
        an ``OptimizerGroup``'s)."""
        return getattr(self.optimizer, "optimizers", {"": self.optimizer})

    def _tensor_parallel(self) -> bool:
        return self.mesh is not None and self.mesh.tensor_parallel

    def _whole_model_state(self) -> Dict[str, torch.Tensor]:
        """The model's ``state_dict`` with whole tensors (collective under
        tensor parallelism)."""
        state = self.model.state_dict()
        if self._tensor_parallel():
            state = gather_params(self.mesh, self.model, state)
        return state

    def _whole_optimizer_state(self) -> Dict[str, Any]:
        """The optimizer's ``state_dict`` with whole moments (collective
        under tensor parallelism)."""
        if not self._tensor_parallel():
            return self.optimizer.state_dict()
        states = {k: gather_like_params(self.mesh, self.model, o,
                                        o.state_dict())
                  for k, o in self._optimizers().items()}
        return states[""] if "" in states else states

    def _load_model_state(self, state: Dict[str, torch.Tensor]) -> None:
        """Load whole tensors into the model (cut to this rank's shards
        under tensor parallelism)."""
        if self._tensor_parallel():
            state = shard_params(self.mesh, self.model, state)
        self.model.load_state_dict(state)

    def _load_optimizer_state(self, state: Dict[str, Any]) -> None:
        if self._tensor_parallel():
            opts = self._optimizers()
            cut = {k: shard_like_params(self.mesh, self.model, o,
                                        state if k == "" else state[k])
                   for k, o in opts.items()}
            state = cut[""] if "" in cut else cut
        self.optimizer.load_state_dict(state)

    def _write_checkpoint(self, path: str, epoch: Optional[int],
                          model_state: Dict[str, torch.Tensor],
                          optimizer_state: Optional[Dict[str, Any]]
                          ) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _atomic_save(model_state, path)
        with open(os.path.join(self.workdir, "config.json"), "w") as f:
            f.write(self.config.to_json())
        if epoch is None:
            return
        ckpt_dir = os.path.join(self.workdir, CHECKPOINT_DIR)
        os.makedirs(ckpt_dir, exist_ok=True)
        _atomic_save({
            "model": model_state,
            "optimizer": optimizer_state,
            **{k: g.get_state() for k, g in self._streams().items()},
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
        self._load_model_state(state)
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
        self._load_model_state(ckpt["model"])
        if self.optimizer is None:
            self.optimizer = self.make_optimizer()
        self._load_optimizer_state(ckpt["optimizer"])
        for k, g in self._streams().items():
            g.set_state(ckpt[k])
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
        ``dropout``) and the model's noise."""
        self.model.eval()
        return self.model(*inputs,
                          dropout_generator=generator if dropout else None,
                          **self._noise(generator, generator))

    def reconstruct_device(self, x: torch.Tensor, dropout: bool = False,
                           generator: Optional[Sample] = None
                           ) -> Dict[str, torch.Tensor]:
        """Reconstruct a batch of (B, H, W, C) slices on the trainer's
        device in eval mode, as one batch; with ``dropout`` (MC sampling)
        dropout masks are drawn from ``generator``, which also draws the
        model's noise and a prior latent (default: a generator seeded 0).
        A tensor (or dict of tensors) given as ``generator`` is the noise
        itself.  Returns ``reconstruction`` plus every model output.

        Under a data-parallel mesh every rank passes the whole batch and
        gets the whole result: the batch is padded to a multiple of the
        ranks (``pad_batch_to``), each rank reconstructs its rows with its
        share of the noise (``ShardedSource``, or its rows of given noise),
        and the outputs are gathered and cropped."""
        x = self._slices(x)
        generator = self._eval_generator(generator)
        if not self.data_parallel:
            return self._reconstruct(x, dropout, generator)
        B = x.shape[0]
        idx = pad_batch_to(np.arange(B), self.mesh.n_data)
        rows = self.mesh.rows(len(idx))
        mine = torch.as_tensor(idx[rows], device=x.device)

        def shard(noise):
            if isinstance(noise, torch.Tensor):
                return noise.to(x.device)[mine]
            if isinstance(noise, dict):
                return {k: shard(v) for k, v in noise.items()}
            return ShardedSource(noise, B, rows.start, rows.stop)

        out = self._reconstruct(x[mine], dropout, shard(generator))
        return {k: all_gather_batch(self.mesh, v)[:B]
                if v.ndim and v.shape[0] == len(mine) else v
                for k, v in out.items()}

    @torch.no_grad()
    def _reconstruct(self, x: torch.Tensor, dropout: bool,
                     generator: Sample) -> Dict[str, torch.Tensor]:
        """``reconstruct_device`` of a batch on this rank's device."""
        outputs = self._call(
            self.model_inputs({"x": x}, train=False, generator=generator),
            dropout, generator)
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


class InputRestoration:
    """Reconstruction by input restoration, for a trainer with a
    ``_restoration_fn``: ``restore_steps`` steps of gradient descent on
    the restoration loss + ``tv_lambda`` x TV (``tv_lambda`` clamped at
    0), and whole stacks of volumes in one restoration."""

    def _restore(self, x: torch.Tensor, dropout: bool,
                 generator: Sample) -> torch.Tensor:
        c = self.config
        return restore_inputs(self._restoration_fn(dropout), x,
                              max(self.tv_lambda_value, 0.0), c.restore_lr,
                              c.restore_steps, generator)

    def _reconstruct(self, x, dropout, generator):
        """The restored input (``tv_lambda`` clamped at 0)."""
        return {"reconstruction": self._restore(x, dropout, generator)}

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
        caller's to crop.

        Under a data-parallel mesh the stack is padded to a multiple of the
        ranks with copies of its volumes (``pad_batch_to``), each copy
        drawing from a fresh generator seeded 0; each rank restores its
        volumes, each with its own generator, so a volume's result does not
        depend on the rank that restores it, and the stacks are gathered
        and cropped to K."""
        K, S = vols.shape[:2]
        counts = [S] * K if counts is None else list(counts)
        generators = list(generators)
        if not self.data_parallel:
            return {"reconstruction": self._restore_stack(
                vols, dropout, generators, counts)}
        idx = pad_batch_to(np.arange(K), self.mesh.n_data)
        rows = self.mesh.rows(len(idx))
        mine = idx[rows]
        gens = [generators[i] if pos < K else
                torch.Generator(device=self.device).manual_seed(0)
                for pos, i in zip(range(rows.start, rows.stop), mine)]
        local = self._restore_stack(
            vols[torch.as_tensor(mine, device=vols.device)], dropout, gens,
            [counts[i] for i in mine])
        return {"reconstruction": all_gather_batch(self.mesh, local)[:K]}

    def _restore_stack(self, vols: torch.Tensor, dropout: bool,
                       generators: List[torch.Generator],
                       counts: List[int]) -> torch.Tensor:
        K, S = vols.shape[:2]
        source = VolumeGenerators(generators, counts, S)
        flat = vols.reshape((K * S,) + tuple(vols.shape[2:]))
        restored = self._restore(flat.to(self.device, torch.float32),
                                 dropout, source)
        return restored.reshape(vols.shape)


class VAE_You(InputRestoration, VAE):
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


class CE(BaseTrainer):
    """Context-encoder AE: trained on context-masked inputs, with the L1
    loss against the clean image."""

    needs_brainmask = True

    def model_inputs(self, batch, train, generator=None):
        if train and "mask" in batch:
            return (random_context_masks(generator or self.generator,
                                         batch["x"], batch["mask"]),)
        return (batch["x"],)

    def compute_losses(self, outputs, batch):
        rec = L.l1_recon_sum(batch["x"], outputs["x_hat"])
        return {"loss": rec, "reconstructionLoss": rec}


class CeVAE(BaseTrainer):
    """ceVAE: VAE loss on the clean branch plus L1 of the context branch;
    with ``use_gradient_based_restoration`` = lambda > 0 the reconstruction
    is ``x - lambda * |x - x_hat| * |d loss_vae / dx|``."""

    needs_brainmask = True

    def model_inputs(self, batch, train, generator=None):
        x = batch["x"]
        if train and "mask" in batch:
            return (x, random_context_masks(generator or self.generator, x,
                                            batch["mask"]))
        return (x, x)

    def compute_losses_with_inputs(self, outputs, batch, inputs):
        # L1_ce targets the model's second input: the masked image in
        # TRAIN, the clean one in VAL
        return L.cevae_loss(batch["x"], inputs[1], outputs)

    def _reconstruct(self, x, dropout, generator):
        lam = float(self.config.use_gradient_based_restoration)
        if lam <= 0:
            return super()._reconstruct(x, dropout, generator)

        def outputs_fn(xi: torch.Tensor):
            out = self._call((xi, xi), dropout, generator)
            rec = L.sum_per_sample(L.l1_elem(xi, out["x_hat"]))
            return rec + L.vae_kl(out["z_mu"], out["z_sigma"]), out["x_hat"]

        anomaly, _ = gradient_anomaly_map(outputs_fn, x)
        return {"reconstruction": x - lam * anomaly}


class GMVAE(InputRestoration, BaseTrainer):
    """Dense GMVAE: the 4-term loss; the reconstruction is the input
    restored on the GMVAE loss + ``tv_lambda`` x TV, or ``xz_mu`` itself
    when ``restore_steps`` <= 0.  The lambda sweep runs after training when
    the config leaves ``tv_lambda`` negative and restores at all."""

    spatial = False

    def compute_losses(self, outputs, batch):
        return L.gmvae_loss(batch["x"], outputs, self.config.dim_c,
                            self.config.c_lambda, self.spatial)

    def post_fit(self, dataset) -> None:
        if self.tv_lambda_value < 0 and self.config.restore_steps > 0:
            self.determine_best_lambda(dataset)

    def _restoration_fn(self, dropout: bool):
        """(x, generator) -> (the batch-mean GMVAE loss broadcast to (B,),
        xz_mu) from ONE eval-mode forward.  Summed over B that is the loss
        SUM, so each slice's pixel gradient is d l_j / dx_j with no 1/B
        factor (the reference differentiates the scalar mean broadcast over
        the per-sample TV vector), and zero-padded batch mates never change
        a real slice's gradient."""
        c = self.config

        def outputs_fn(x: torch.Tensor, generator: Sample):
            out = self._call((x,), dropout, generator)
            loss = L.gmvae_loss(x, out, c.dim_c, c.c_lambda,
                                self.spatial)["loss"]
            return loss.expand(x.shape[0]), out["xz_mu"]

        return outputs_fn

    def _reconstruct(self, x, dropout, generator):
        if self.config.restore_steps <= 0:
            return BaseTrainer._reconstruct(self, x, dropout, generator)
        return super()._reconstruct(x, dropout, generator)


class GMVAE_spatial(GMVAE):
    """Spatial GMVAE (and ``GMVAE_You``'s trainer): the spatial loss
    reduction."""

    spatial = True


class ConstrainedAE(BaseTrainer):
    """Constrained AE: per-sample mean L2 + rho x the latent consistency of
    the reconstruction encoded again."""

    def compute_losses(self, outputs, batch):
        return L.constrained_loss(batch["x"], outputs, self.config.rho, "z")
