"""Adversarial trainers of the latent-critic family: ``AAE`` and
``ConstrainedAAE``.

Counterpart of the latent-critic half of `unsupervised_anomaly_detection_
brain_mri_tpu/train/gan.py`.  Three optimizers, each Adam with betas
(0.5, 0.9) and its own state, update three groups of parameters:

  * ``ae``: every parameter (the critic's get zero gradients there);
  * ``disc``: the critic, ``discriminator.*``;
  * ``gen``: the encoder's conv pyramid, ``encoder.*`` only (not
    ``intermediate_conv`` nor ``z_layer``).

Each substep differentiates its loss with respect to its group alone: the
parameters outside the group are frozen (``requires_grad`` off) for the
substep, so a critic substep builds no graph through the encoder and
decoder and pays for no backward through them.

One batch runs ``ae_iters`` AE updates (``d_iters`` = 20 while ``epoch``,
which ``fit`` sets, is <= 5, then 1), ``d_iters`` critic updates, each with
a fresh prior ``z`` and a fresh interpolate eps, and one generator update.
Every substep runs the whole model in train mode, so BatchNorm's running
statistics move ``ae_iters + d_iters + 1`` times per batch, in that order.
The critic's loss is the WGAN loss plus the gradient penalty on
``ddx = d D(z_hat) / d z_hat``, taken with ``create_graph`` so that the
critic's gradient flows through the penalty.  The metrics are the last AE
update's losses, the last ``disc_loss`` and ``gen_loss``.  Early stopping
watches ``reconstructionLoss``.

Checkpoints hold the three optimizer states (``OptimizerGroup``) and the
``gp`` generator beside the others, so resume continues bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional

import torch

from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    Sample,
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


class AdversarialTrainerBase(BaseTrainer):
    """The latent-critic trainers' parameter groups and prior latent."""

    early_stop_metric = "reconstructionLoss"

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        names = [n for n, _ in self.model.named_parameters()]
        self.groups: Dict[str, List[str]] = {
            "ae": names,
            "disc": [n for n in names if self.disc_pred(n)],
            "gen": [n for n in names if self.gen_pred(n)],
        }

    @staticmethod
    def disc_pred(name: str) -> bool:
        return any("discriminator" in k for k in name.split("."))

    @staticmethod
    def gen_pred(name: str) -> bool:
        # the encoder's conv pyramid only, as the reference's scope
        return any(k == "encoder" for k in name.split("."))

    def make_optimizer(self) -> OptimizerGroup:
        params = dict(self.model.named_parameters())
        return OptimizerGroup({
            group: gan_adam(self.config, [params[n] for n in names])
            for group, names in self.groups.items()})

    def sample_z(self, generator: torch.Generator, n: int) -> Tensor:
        """A prior latent, (n, zDim) ~ N(0, 1)."""
        return torch.randn((n, self.config.zDim), generator=generator,
                           device=self.device)

    def model_inputs(self, batch, train, generator: Optional[Sample] = None):
        """The models that take a prior latent get one in every forward
        (TRAIN, VAL and reconstruction)."""
        x = batch["x"]
        if self.spec.takes_prior_z:
            return (x, self.sample_z(generator or self.generator,
                                     x.shape[0]))
        return (x,)

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
        gradient (its Adam moments decay, as optax's do)."""
        opt = self.optimizer[group]
        params = [p for g in opt.param_groups for p in g["params"]]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        opt.step()
        for p in params:
            p.grad = None


class AAE(AdversarialTrainerBase):
    """Adversarial AE: per batch ``ae_iters()`` AE updates on the mean L2,
    ``d_iters`` critic updates and one generator update."""

    d_iters: int = 20

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

    def forward_train(self, batch, z: Optional[Tensor]
                      ) -> Dict[str, Tensor]:
        """The whole model in train mode (dropout, batch statistics)."""
        self.model.train()
        return self.model(batch["x"], z, dropout_generator=self.generator,
                          gp=self.gp_generator)

    def disc_loss(self, outputs) -> Tensor:
        """WGAN critic loss + the gradient penalty at ``z_hat``."""
        z_hat = outputs["z_hat"].detach().requires_grad_(True)
        (ddx,) = torch.autograd.grad(self.model.discriminate(z_hat).sum(),
                                     z_hat, create_graph=True)
        return (L.wgan_disc_loss(outputs["d"], outputs["d_"])
                + L.wgan_gp_penalty_from_grads(ddx, self.config.scale))

    def train_step(self, batch) -> Dict[str, Tensor]:
        n = batch["x"].shape[0]
        for _ in range(self.ae_iters()):
            losses = self.ae_loss(self.forward_train(batch, None), batch)
            self.update("ae", losses["loss"])
        metrics = self._scalar_metrics(losses)
        disc_loss = torch.zeros((), device=self.device)
        with self.only("disc"):
            for _ in range(self.d_iters):
                z = self.sample_z(self.generator, n)
                disc_loss = self.disc_loss(self.forward_train(batch, z))
                self.update("disc", disc_loss)
        metrics["disc_loss"] = disc_loss.detach()
        with self.only("gen"):
            outputs = self.forward_train(batch, None)
            gen_loss = L.wgan_gen_loss(self.model.discriminate(outputs["z_"]))
            self.update("gen", gen_loss)
        metrics["gen_loss"] = gen_loss.detach()
        self.step += 1
        return metrics


class ConstrainedAAE(AAE):
    """Constrained AAE: the AAE schedule with the latent consistency of the
    re-encoded reconstruction in the AE loss."""

    def ae_loss(self, outputs, batch):
        return L.constrained_loss(batch["x"], outputs, self.config.rho, "z_")
