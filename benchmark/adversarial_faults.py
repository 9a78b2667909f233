"""Faults of the adversarial trainers, planted under the timed path to show
that the check of ``kinds/wgan_train.py`` sees them (as ``faults.py``'s):

  * ``no_penalty``: the critic's gradient penalty is left out, as with
    ``scale`` 0 under the port (its graph is still built);
  * ``no_double_backward``: the penalty's value is kept and its gradient
    with respect to the critic's parameters dropped, as an input gradient
    taken without ``create_graph`` gives: the critic loss reads the same,
    and the critic steps on the WGAN terms' gradient alone;
  * ``unstepped_critic``: the critic's gradients are taken and its
    optimizer never steps, so the critic's state is left unchanged.

On the card: register them beside ``faults.py``'s and read them with
``calibrate.py``'s ``readings(..., fault="no_penalty")``.
"""

from __future__ import annotations

from benchmark.faults import _patched, _port


def no_penalty():
    losses = _port("train.gan").L
    original = losses.wgan_gp_penalty_from_grads

    def wgan_gp_penalty_from_grads(ddx, scale):
        return original(ddx, 0.0)

    return _patched(losses, "wgan_gp_penalty_from_grads",
                    wgan_gp_penalty_from_grads)


def no_double_backward():
    losses = _port("train.gan").L
    original = losses.wgan_gp_penalty_from_grads

    def wgan_gp_penalty_from_grads(ddx, scale):
        return original(ddx.detach(), scale)

    return _patched(losses, "wgan_gp_penalty_from_grads",
                    wgan_gp_penalty_from_grads)


def unstepped_critic():
    base = _port("train.gan").AdversarialTrainerBase
    original = base.update

    def update(self, group, loss):
        if group != "disc":
            return original(self, group, loss)
        opt = self.optimizer[group]
        opt.step = lambda *args, **kwargs: None
        try:
            original(self, group, loss)
        finally:
            del opt.step

    return _patched(base, "update", update)


FAULTS = {"no_penalty": no_penalty, "no_double_backward": no_double_backward,
          "unstepped_critic": unstepped_critic}
