"""Loss functions of every algorithm in the zoo, in torch.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/train/
losses.py`, formula for formula (the reference trainers' formulas, not
textbook versions).  Images are NHWC float32; latent vectors are (B, Z).
The ``AE`` path uses ``l1_recon_sum``; the rest waits for its networks.
"""

from __future__ import annotations

from typing import Dict

import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# elementary reductions


def l1_elem(x: Tensor, y: Tensor) -> Tensor:
    """Elementwise absolute difference."""
    return torch.abs(x - y)


def l2_elem(x: Tensor, y: Tensor) -> Tensor:
    """Elementwise squared error."""
    return torch.square(x - y)


def sum_per_sample(e: Tensor) -> Tensor:
    """Sum over all non-batch axes -> (B,)."""
    return torch.sum(e, dim=tuple(range(1, e.ndim)))


def mean_per_sample(e: Tensor) -> Tensor:
    """Mean over all non-batch axes -> (B,)."""
    return torch.mean(e, dim=tuple(range(1, e.ndim)))


def l1_recon_sum(x: Tensor, x_hat: Tensor) -> Tensor:
    """``mean_b(sum_hwc |x - x_hat|)``."""
    return torch.mean(sum_per_sample(l1_elem(x, x_hat)))


def l2_recon_mean(x: Tensor, x_hat: Tensor) -> Tensor:
    """``mean_b(mean_hwc (x - x_hat)^2)``."""
    return torch.mean(mean_per_sample(l2_elem(x, x_hat)))


# ---------------------------------------------------------------------------
# VAE family


def vae_kl(z_mu: Tensor, z_sigma: Tensor) -> Tensor:
    """Per-sample analytic KL in the sigma form:
    ``0.5 * sum(mu^2 + sigma^2 - log(sigma^2) - 1)``."""
    s2 = torch.square(z_sigma)
    return 0.5 * torch.sum(torch.square(z_mu) + s2 - torch.log(s2) - 1.0,
                           dim=1)


def vae_loss(x: Tensor, outputs: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """VAE total loss; ``pixel_loss`` is per sample (restoration)."""
    rec = sum_per_sample(l1_elem(x, outputs["x_hat"]))
    kl = vae_kl(outputs["z_mu"], outputs["z_sigma"])
    return {
        "reconstructionLoss": torch.mean(rec),
        "kl": torch.mean(kl),
        "loss": torch.mean(rec + kl),
        "pixel_loss": rec + kl,
    }


def cevae_loss(x: Tensor, x_ce: Tensor, outputs: Dict[str, Tensor]
               ) -> Dict[str, Tensor]:
    """ceVAE combi loss."""
    rec_vae = sum_per_sample(l1_elem(x, outputs["x_hat"]))
    rec_ce = sum_per_sample(l1_elem(x_ce, outputs["x_hat_ce"]))
    kl = vae_kl(outputs["z_mu"], outputs["z_sigma"])
    return {
        "Rec_vae": torch.mean(rec_vae),
        "Rec_ce": torch.mean(rec_ce),
        "reconstructionLoss": 0.5 * torch.mean(rec_vae + rec_ce),
        "kl": torch.mean(kl),
        "loss": torch.mean(rec_vae + kl + rec_ce),
        "loss_vae": torch.mean(rec_vae + kl),
    }


# ---------------------------------------------------------------------------
# GMVAE (4-term loss; dense and spatial reductions)


def gmvae_loss(x: Tensor, outputs: Dict[str, Tensor], dim_c: int,
               c_lambda: float, spatial: bool) -> Dict[str, Tensor]:
    xz_mu = outputs["xz_mu"]
    rec = sum_per_sample(l1_elem(x, xz_mu))
    mean_p_loss = torch.mean(rec)

    z_mu = outputs["z_mu"].unsqueeze(-1)
    z_logvar = outputs["z_log_sigma"].unsqueeze(-1)
    z_wc_mu = outputs["z_wc_mus"]
    z_wc_lsi = outputs["z_wc_log_sigma_invs"]
    pc = outputs["pc"]

    d_mu_2 = torch.square(z_mu - z_wc_mu)
    d_var = (torch.exp(z_logvar) + d_mu_2) * (torch.exp(z_wc_lsi) + 1e-6)
    d_logvar = -1.0 * (z_wc_lsi + z_logvar)
    kl = (d_var + d_logvar - 1.0) * 0.5
    # contract the mixture axis with pc, then sum remaining non-batch axes
    weighted = torch.einsum("...zc,...c->...z", kl, pc)
    mean_con_loss = torch.mean(sum_per_sample(weighted))

    w_mu, w_log_sigma = outputs["w_mu"], outputs["w_log_sigma"]
    w_loss = 0.5 * sum_per_sample(
        torch.square(w_mu) + torch.exp(w_log_sigma) - w_log_sigma - 1.0)
    mean_w_loss = torch.mean(w_loss)

    closs1 = torch.sum(pc * torch.log(pc * dim_c + 1e-8), dim=-1)
    c_loss = torch.clamp_min(closs1, c_lambda)
    if spatial:
        c_loss = sum_per_sample(c_loss)
    mean_c_loss = torch.mean(c_loss)

    return {
        "reconstructionLoss": mean_p_loss,
        "conditional_prior_loss": mean_con_loss,
        "w_prior_loss": mean_w_loss,
        "c_prior_loss": mean_c_loss,
        "loss": mean_p_loss + mean_con_loss + mean_w_loss + mean_c_loss,
    }


# ---------------------------------------------------------------------------
# adversarial (WGAN-GP) pieces


def total_variation(images: Tensor) -> Tensor:
    """Per-sample anisotropic TV (``tf.image.total_variation``): sum of
    absolute row and column differences -> (B,)."""
    dh = torch.abs(images[:, 1:, :, :] - images[:, :-1, :, :])
    dw = torch.abs(images[:, :, 1:, :] - images[:, :, :-1, :])
    return sum_per_sample(dh) + sum_per_sample(dw)


def wgan_gp_penalty_from_grads(ddx: Tensor, scale: float) -> Tensor:
    """Gradient penalty with the reference's axis-1 slope reduction: for
    4-D image gradients it reduces the H axis only (kept for parity)."""
    slopes = torch.sqrt(torch.sum(torch.square(ddx), dim=1) + 1e-12)
    return torch.mean(torch.square(slopes - 1.0)) * scale


def wgan_disc_loss(d_real: Tensor, d_fake: Tensor) -> Tensor:
    """``mean(d_fake) - mean(d_real)``."""
    return torch.mean(d_fake) - torch.mean(d_real)


def wgan_gen_loss(d_fake: Tensor) -> Tensor:
    """``-mean(d_fake)``."""
    return -torch.mean(d_fake)


def constrained_loss(x: Tensor, outputs: Dict[str, Tensor], rho: float,
                     z_key: str = "z") -> Dict[str, Tensor]:
    """Constrained-AE objective."""
    l2 = mean_per_sample(l2_elem(x, outputs["x_hat"]))
    rec_z = torch.mean(l2_elem(outputs[z_key], outputs["z_rec"]), dim=1)
    return {
        "reconstructionLoss": l1_recon_sum(x, outputs["x_hat"]),
        "L2": torch.mean(l2),
        "Rec_z": torch.mean(rec_z),
        "loss": torch.mean(l2 + rho * rec_z),
    }


def fanogan_enc_loss(x: Tensor, outputs: Dict[str, Tensor], kappa: float
                     ) -> Dict[str, Tensor]:
    """izif encoder loss."""
    loss_img = torch.mean(mean_per_sample(l2_elem(x, outputs["x_enc"])))
    loss_fts = torch.mean(mean_per_sample(
        l2_elem(outputs["d_enc_features"], outputs["d_features"])))
    return {
        "loss_img": loss_img,
        "loss_fts": loss_fts,
        "enc_loss": loss_img + kappa * loss_fts,
        "reconstructionLoss": l1_recon_sum(x, outputs["x_enc"]),
    }
