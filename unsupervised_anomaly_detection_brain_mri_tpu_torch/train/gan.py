"""Adversarial trainers: the latent-critic ``AAE`` and ``ConstrainedAAE``
(also Chen's ResNet model), and the image-critic ``fAnoGAN`` and
``AnoVAEGAN``.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/train/gan.py`.
Each trainer declares its parameter groups (``group_predicates``: name ->
predicate on a parameter's dotted name), and one optimizer per group, each
Adam with betas (0.5, 0.9) and its own state, updates it:

  * ``AAE``/``ConstrainedAAE``: ``ae`` every parameter (the critic's get
    zero gradients there), ``disc`` the critic ``discriminator.*``, ``gen``
    the encoder's trunk ``encoder.*`` only (not ``intermediate_conv``,
    ``z_layer`` nor Chen's ``enc_dense``);
  * ``fAnoGAN``: ``gen`` (``generator``, ``intermediate_conv_reverse``,
    ``dec_dense``, ``gen_dense``), ``disc`` (``disc*``) and ``enc``
    (``encoder``, ``intermediate_conv``, ``z_layer``, ``enc_dense``);
  * ``AnoVAEGAN``: ``vae`` (the encoder's names, ``mu_layer`` and
    ``sigma_layer``, and the generator's), ``gen`` and ``disc``.

Each substep differentiates its loss with respect to its group alone: the
parameters outside the group are frozen (``requires_grad`` off) for the
substep, so a critic substep builds no graph through the encoder and
decoder and pays for no backward through them.  Every substep runs the
whole model in train mode, with fresh draws, so BatchNorm's running
statistics move once per substep, in the JAX package's order.

Schedules per batch:

  * ``AAE``: ``ae_iters`` AE updates (``d_iters`` = 20 while ``epoch``,
    which ``fit`` sets, is <= 5, then 1), ``d_iters`` critic updates, each
    with a fresh prior ``z`` and a fresh interpolate eps, and one generator
    update;
  * ``fAnoGAN`` runs ``2 x numEpochs`` epochs: below ``numEpochs`` (the
    WGAN phase, tagged ``TRAIN_WGAN``, no VAL) one generator update with a
    fresh prior ``z``, then 5 critic updates, each with a fresh ``z``; later
    (``TRAIN_Encoder``) one encoder update on ``fanogan_enc_loss``, and the
    VAL pass;
  * ``AnoVAEGAN``: one VAE update on ``rec_sum + kl_weight * mean(kl)``,
    one generator update, 5 critic updates.

A critic's loss is the WGAN loss plus the gradient penalty on ``ddx = d
D(interpolate) / d interpolate``, taken with ``create_graph`` so that the
critic's gradient flows through the penalty.  The image critics keep the
reference's slope over axis 1 only (H of NHWC).  Early stopping watches
``reconstructionLoss``.

Checkpoints hold the optimizer states (``OptimizerGroup``) and the ``gp``
and ``sample`` generators beside the others, so resume continues bit for
bit.

Tracing: each substep is a ``train.substep`` span holding its forward,
penalty, backward and optimizer spans, and each critic substep counts one
``critic_updates`` (``utils/trace.py`` describes them).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    Sample,
    draw,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.collectives import (
    psum_mean_grads,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
    losses as L,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.base import (
    BaseTrainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.state import (
    gan_adam,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import trace

Tensor = torch.Tensor


class OptimizerGroup:
    """Named optimizers that checkpoint as one: ``state_dict()`` is
    ``{name: optimizer.state_dict()}``."""

    def __init__(self, optimizers: Dict[str, torch.optim.Optimizer]):
        self.optimizers = dict(optimizers)

    def __getitem__(self, name: str) -> torch.optim.Optimizer:
        return self.optimizers[name]

    def state_dict(self) -> Dict[str, Any]:
        return {k: o.state_dict() for k, o in self.optimizers.items()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for k, o in self.optimizers.items():
            o.load_state_dict(state[k])


def _names_in(*names: str) -> Callable[[str], bool]:
    """A predicate: some component of the dotted name is one of ``names``
    (the JAX package's test over a parameter's path)."""
    wanted = set(names)
    return lambda name: any(k in wanted for k in name.split("."))


def _disc(name: str) -> bool:
    return any(k.startswith("disc") for k in name.split("."))


class AdversarialTrainerBase(BaseTrainer):
    """The adversarial trainers' parameter groups, substeps and prior
    latent."""

    early_stop_metric = "reconstructionLoss"

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        names = [n for n, _ in self.model.named_parameters()]
        self.groups: Dict[str, List[str]] = {
            group: [n for n in names if pred(n)]
            for group, pred in self.group_predicates().items()}

    def group_predicates(self) -> Dict[str, Callable[[str], bool]]:
        raise NotImplementedError

    def make_optimizer(self) -> OptimizerGroup:
        params = dict(self.model.named_parameters())
        return OptimizerGroup({
            group: gan_adam(self.config, [params[n] for n in names])
            for group, names in self.groups.items()})

    def sample_z(self, generator: Sample, n: int) -> Tensor:
        """A prior latent, (n, zDim) ~ N(0, 1)."""
        return draw(torch.randn, generator, (n, self.config.zDim),
                    self.device)

    def prior_z(self, n: int) -> Tensor:
        """A training step's prior latent for ``n`` rows, from the
        trainer's generator (this rank's rows of the global batch's
        draw under a data-parallel mesh)."""
        return self.sample_z(self._shard_source(self.generator, n), n)

    def model_inputs(self, batch, train, generator: Optional[Sample] = None):
        """The models that take a prior latent get one in every forward
        (TRAIN, VAL and reconstruction)."""
        x = batch["x"]
        if self.spec.takes_prior_z:
            return (x, self.sample_z(generator or self.generator,
                                     x.shape[0]))
        return (x,)

    def forward_train(self, batch, z: Optional[Tensor] = None
                      ) -> Dict[str, Tensor]:
        """The whole model in train mode (dropout, batch statistics, the
        model's draws from the trainer's generators); ``z`` is the prior
        latent of the models that take one."""
        self.model.train()
        n = batch["x"].shape[0]
        args = (batch["x"], z) if self.spec.takes_prior_z else (batch["x"],)
        return self.model(
            *args, dropout_generator=self._shard_source(self.generator, n),
            **self._noise(self._shard_source(self.sample_generator, n),
                          self._shard_source(self.gp_generator, n)))

    def image_disc_loss(self, outputs, interpolate: str) -> Tensor:
        """WGAN critic loss + the gradient penalty at the image
        interpolate ``outputs[interpolate]`` (NHWC; slopes over axis 1)."""
        x_hat = outputs[interpolate].detach().requires_grad_(True)
        with trace.span("train.penalty"):
            (ddx,) = torch.autograd.grad(
                self.model.discriminate(x_hat)[1].sum(), x_hat,
                create_graph=True)
            penalty = L.wgan_gp_penalty_from_grads(ddx, self.config.scale)
        return L.wgan_disc_loss(outputs["d"], outputs["d_"]) + penalty

    @staticmethod
    def substep(group: str):
        """The ``train.substep`` span of one update of ``group``; a critic
        substep also counts one ``critic_updates``."""
        if group == "disc":
            trace.count("critic_updates")
        return trace.span("train.substep", group=group)

    @contextlib.contextmanager
    def only(self, group: str) -> Iterator[None]:
        """Freeze every parameter outside ``group`` for the block."""
        trainable = set(self.groups[group])
        params = list(self.model.named_parameters())
        for n, p in params:
            p.requires_grad_(n in trainable)
        try:
            yield
        finally:
            for _, p in params:
                p.requires_grad_(True)

    def update(self, group: str, loss: Tensor) -> None:
        """One step of ``group``'s optimizer on d loss / d group; a
        parameter of the group that the loss does not reach gets a zero
        gradient (its Adam moments decay, as optax's do).  Under a
        data-parallel mesh the group's gradients are averaged over the
        ranks before the step (``autograd.grad`` bypasses DDP's hooks)."""
        opt = self.optimizer[group]
        params = [p for g in opt.param_groups for p in g["params"]]
        with trace.span("train.backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        with trace.span("train.optimizer"):
            for p, g in zip(params, grads):
                p.grad = torch.zeros_like(p) if g is None else g
            if self.data_parallel:
                psum_mean_grads(self.mesh, params)
            opt.step()
            for p in params:
                p.grad = None


class AAE(AdversarialTrainerBase):
    """Adversarial AE: per batch ``ae_iters()`` AE updates on the mean L2,
    ``d_iters`` critic updates and one generator update."""

    d_iters: int = 20

    def group_predicates(self):
        return {"ae": lambda name: True,
                "disc": _names_in("discriminator"),
                # the encoder's conv trunk only, as the reference's scope
                "gen": _names_in("encoder")}

    def ae_iters(self) -> int:
        return self.d_iters if self.epoch <= 5 else 1

    def ae_loss(self, outputs, batch) -> Dict[str, Tensor]:
        x = batch["x"]
        return {
            "loss": torch.mean(L.mean_per_sample(L.l2_elem(x,
                                                           outputs["x_hat"]))),
            "reconstructionLoss": L.l1_recon_sum(x, outputs["x_hat"]),
        }

    def compute_losses(self, outputs, batch):  # the VAL pass
        return self.ae_loss(outputs, batch)

    def disc_loss(self, outputs) -> Tensor:
        """WGAN critic loss + the gradient penalty at ``z_hat``."""
        z_hat = outputs["z_hat"].detach().requires_grad_(True)
        with trace.span("train.penalty"):
            (ddx,) = torch.autograd.grad(self.model.discriminate(z_hat).sum(),
                                         z_hat, create_graph=True)
            penalty = L.wgan_gp_penalty_from_grads(ddx, self.config.scale)
        return L.wgan_disc_loss(outputs["d"], outputs["d_"]) + penalty

    def train_step(self, batch) -> Dict[str, Tensor]:
        n = batch["x"].shape[0]
        for _ in range(self.ae_iters()):
            with self.substep("ae"):
                with trace.span("train.forward"):
                    losses = self.ae_loss(self.forward_train(batch, None),
                                          batch)
                self.update("ae", losses["loss"])
        metrics = self._scalar_metrics(losses)
        disc_loss = torch.zeros((), device=self.device)
        with self.only("disc"):
            for _ in range(self.d_iters):
                with self.substep("disc"):
                    with trace.span("train.forward"):
                        z = self.prior_z(n)
                        outputs = self.forward_train(batch, z)
                    disc_loss = self.disc_loss(outputs)
                    self.update("disc", disc_loss)
        metrics["disc_loss"] = disc_loss.detach()
        with self.only("gen"), self.substep("gen"):
            with trace.span("train.forward"):
                outputs = self.forward_train(batch, None)
                gen_loss = L.wgan_gen_loss(
                    self.model.discriminate(outputs["z_"]))
            self.update("gen", gen_loss)
        metrics["gen_loss"] = gen_loss.detach()
        self.step += 1
        return metrics


class ConstrainedAAE(AAE):
    """Constrained AAE: the AAE schedule with the latent consistency of the
    re-encoded reconstruction in the AE loss."""

    def ae_loss(self, outputs, batch):
        return L.constrained_loss(batch["x"], outputs, self.config.rho, "z_")


class FAnoGAN(AdversarialTrainerBase):
    """fAnoGAN: ``numEpochs`` WGAN epochs (per batch one generator update,
    then ``d_iters`` critic updates, no VAL), then ``numEpochs`` encoder
    epochs (one update of ``enc`` on ``fanogan_enc_loss`` per batch, and
    the VAL pass on it)."""

    d_iters: int = 5

    def group_predicates(self):
        return {"gen": _names_in("generator", "intermediate_conv_reverse",
                                 "dec_dense", "gen_dense"),
                "disc": _disc,
                "enc": _names_in("encoder", "intermediate_conv", "z_layer",
                                 "enc_dense")}

    def num_epochs(self) -> int:
        return 2 * self.config.numEpochs

    def encoder_phase(self, epoch: int) -> bool:
        return epoch >= self.config.numEpochs

    def validation_enabled(self, epoch: int) -> bool:
        return self.encoder_phase(epoch)

    def phase_tag(self, epoch: int) -> str:
        return "TRAIN_Encoder" if self.encoder_phase(epoch) else "TRAIN_WGAN"

    def compute_losses(self, outputs, batch):  # the VAL pass
        return L.fanogan_enc_loss(batch["x"], outputs, self.config.kappa)

    def train_step(self, batch) -> Dict[str, Tensor]:
        if self.encoder_phase(self.epoch):
            with self.only("enc"), self.substep("enc"):
                with trace.span("train.forward"):
                    losses = self.compute_losses(self.forward_train(batch),
                                                 batch)
                self.update("enc", losses["enc_loss"])
            self.step += 1
            return self._scalar_metrics(losses)
        n = batch["x"].shape[0]
        with self.only("gen"), self.substep("gen"):
            with trace.span("train.forward"):
                outputs = self.forward_train(batch, self.prior_z(n))
                gen_loss = L.wgan_gen_loss(outputs["d_"])
            self.update("gen", gen_loss)
        disc_loss = torch.zeros((), device=self.device)
        with self.only("disc"):
            for _ in range(self.d_iters):
                with self.substep("disc"):
                    with trace.span("train.forward"):
                        outputs = self.forward_train(batch, self.prior_z(n))
                    disc_loss = self.image_disc_loss(outputs, "x_hat")
                    self.update("disc", disc_loss)
        self.step += 1
        return {"gen_loss": gen_loss.detach(), "disc_loss": disc_loss.detach(),
                "reconstructionLoss": torch.zeros((), device=self.device)}


class AnoVAEGAN(AdversarialTrainerBase):
    """AnoVAEGAN: per batch one VAE update (encoder and generator) on
    ``rec_sum + kl_weight * mean(kl)``, one generator update on the WGAN
    generator loss, ``d_iters`` critic updates."""

    d_iters: int = 5

    def group_predicates(self):
        enc = _names_in("encoder", "intermediate_conv", "mu_layer",
                        "sigma_layer")
        gen = _names_in("generator", "intermediate_conv_reverse",
                        "dec_dense")
        return {"vae": lambda name: enc(name) or gen(name), "gen": gen,
                "disc": _disc}

    def compute_losses(self, outputs, batch):  # the VAL pass
        kl = L.vae_kl(outputs["z_mu"], outputs["z_sigma"])
        rec_sum = L.l1_recon_sum(batch["x"], outputs["out"])
        return {"kl": torch.mean(kl), "reconstructionLoss": rec_sum,
                "loss": rec_sum,
                "enc_loss": rec_sum + self.config.kl_weight * torch.mean(kl)}

    def train_step(self, batch) -> Dict[str, Tensor]:
        with self.only("vae"), self.substep("vae"):
            with trace.span("train.forward"):
                losses = self.compute_losses(self.forward_train(batch), batch)
            self.update("vae", losses["enc_loss"])
        metrics = self._scalar_metrics(losses)
        with self.only("gen"), self.substep("gen"):
            with trace.span("train.forward"):
                gen_loss = L.wgan_gen_loss(self.forward_train(batch)["d_"])
            self.update("gen", gen_loss)
        metrics["gen_loss"] = gen_loss.detach()
        disc_loss = torch.zeros((), device=self.device)
        with self.only("disc"):
            for _ in range(self.d_iters):
                with self.substep("disc"):
                    with trace.span("train.forward"):
                        outputs = self.forward_train(batch)
                    disc_loss = self.image_disc_loss(outputs, "x_hat_gp")
                    self.update("disc", disc_loss)
        metrics["disc_loss"] = disc_loss.detach()
        self.step += 1
        return metrics
