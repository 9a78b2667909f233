"""AnoVAEGAN: a VAE whose decoder is a WGAN-GP generator with an image
critic.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/models/
anovaegan.py`: the BatchNorm unified encoder -> ``intermediate_conv`` ->
``mu_layer`` and ``sigma_layer`` (dropout on both) -> ``z = mu + eps *
sigma``; the generator ``dec_dense`` -> ``intermediate_conv_reverse`` -> the
LayerNorm unified decoder (no final activation); the critic the LayerNorm
unified encoder (``disc_features``) with ``disc_dense`` on every position.

Output keys: ``z_mu``, ``z_log_sigma``, ``z_sigma``, ``out`` (the
reconstruction), ``d_fake_features``, ``d_`` (on ``out``),
``d_features``, ``d`` (on x), ``x_hat`` (also ``x_hat_gp``: the gradient
penalty's interpolate ``x + alpha * (out - x)``, NOT the reconstruction),
``d_hat_features`` and ``d_hat``.  ``d*`` and ``*_features`` are NHWC
float32.

Draws: ``eps ~ N(0, 1)`` from ``sample`` and a per-sample ``alpha ~ U[0,
1)`` of shape (B, 1, 1, 1) from ``gp``, both in eval mode too.  The
reference's ``dec_dense`` dropout lacks its training flag and never fires.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.fanogan import (
    image_critic,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    Conv2d,
    Linear,
    RandomSource,
    Sample,
    UnifiedDecoder,
    UnifiedEncoder,
    dropout,
    flatten_nhwc,
    uniform,
    unflatten_nhwc,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.vae import (
    reparameterise,
)

Tensor = torch.Tensor


class AnoVAEGAN(nn.Module):

    def __init__(self, image_size: int = 128, channels: int = 1,
                 z_dim: int = 128, intermediate_resolution: int = 8,
                 dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 space_to_depth_stem: bool = False,
                 depth_to_space_head: bool = False):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.encoder = UnifiedEncoder(image_size, channels,
                                      intermediate_resolution, dtype,
                                      space_to_depth_stem=space_to_depth_stem)
        c = self.encoder.out_channels
        feat = image_size // 2 ** self.encoder.n
        self.reshape = (feat, feat, c // 8)  # NHWC, as Flax
        self.intermediate_conv = Conv2d(c, c // 8, 1, 1, dtype)
        self.intermediate_conv_reverse = Conv2d(c // 8, c, 1, 1, dtype)
        self.mu_layer = Linear(feat * feat * (c // 8), z_dim, dtype)
        self.sigma_layer = Linear(feat * feat * (c // 8), z_dim, dtype)
        self.dec_dense = Linear(z_dim, feat * feat * (c // 8), dtype)
        self.generator = UnifiedDecoder(
            c, image_size, channels, intermediate_resolution, dtype,
            use_batchnorm=False, depth_to_space_head=depth_to_space_head)
        self.disc_features = UnifiedEncoder(
            image_size, channels, intermediate_resolution, dtype,
            use_batchnorm=False, space_to_depth_stem=space_to_depth_stem)
        self.disc_dense = Linear(c, 1, dtype)

    def generate(self, z: Tensor) -> Tensor:
        """z -> the reconstruction (B, H, W, C) float32."""
        h = self.intermediate_conv_reverse(unflatten_nhwc(self.dec_dense(z),
                                                          self.reshape))
        return self.generator(h).permute(0, 2, 3, 1)

    def discriminate(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        return image_critic(self.disc_features, self.disc_dense, x)

    def forward(self, x: Tensor,
                dropout_generator: Optional[RandomSource] = None,
                sample: Optional[Sample] = None,
                gp: Optional[Sample] = None) -> Dict[str, Tensor]:
        flat = flatten_nhwc(self.intermediate_conv(
            self.encoder(x.permute(0, 3, 1, 2))))
        z_mu, z_log_sigma = (
            dropout(layer(flat), self.dropout_rate,
                    dropout_generator).to(torch.float32)
            for layer in (self.mu_layer, self.sigma_layer))
        z_sigma, z = reparameterise(z_mu, z_log_sigma, sample)
        out: Dict[str, Tensor] = {"z_mu": z_mu, "z_log_sigma": z_log_sigma,
                                  "z_sigma": z_sigma}
        out["out"] = rec = self.generate(z)
        out["d_fake_features"], out["d_"] = self.discriminate(rec)
        out["d_features"], out["d"] = self.discriminate(x)
        alpha = uniform(gp, (x.shape[0], 1, 1, 1), x.device)
        out["x_hat"] = out["x_hat_gp"] = x_hat = x + alpha * (rec - x)
        out["d_hat_features"], out["d_hat"] = self.discriminate(x_hat)
        return out
