"""Context-encoding variational autoencoders (ceVAE).

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/models/
cevae.py`.  One encoder, bottleneck and decoder run over two inputs: the
clean image ``x`` (the variational branch, reparameterised) and the
context-masked image ``x_ce`` (decoded from its mean ``z_mu_ce``, with no
noise).  In train mode every BatchNorm is therefore called twice, ``x``
first, and its running statistics move twice in that order, as Flax's do.
Output keys: ``z_mu``, ``z_mu_ce``, ``z_log_sigma``, ``z_sigma``,
``x_hat``, ``x_hat_ce``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    RandomSource,
    Sample,
    UnifiedDecoder,
    UnifiedEncoder,
    flatten_nhwc,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.vae import (
    VAEBottleneck,
    VariationalAutoencoderZimmerer,
    reparameterise,
)

Tensor = torch.Tensor


class ContextEncoderVAE(VAEBottleneck):
    """Unified-backbone ceVAE.  The bottleneck's layers (``intermediate_conv``,
    ``mu_layer``, ``sigma_layer``, ``dec_dense``,
    ``intermediate_conv_reverse``) sit at the top of the module tree beside
    ``encoder`` and ``decoder``, as in the Flax tree."""

    def __init__(self, image_size: int = 128, channels: int = 1,
                 z_dim: int = 128, intermediate_resolution: int = 8,
                 dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        encoder = UnifiedEncoder(image_size, channels,
                                 intermediate_resolution, dtype=dtype)
        super().__init__(encoder.out_channels, image_size // 2 ** encoder.n,
                         z_dim, dropout_rate, dtype)
        self.encoder = encoder
        self.decoder = UnifiedDecoder(
            encoder.out_channels, image_size, channels,
            intermediate_resolution, dtype=dtype)

    def forward(self, x: Tensor, x_ce: Optional[Tensor] = None,
                dropout_generator: Optional[RandomSource] = None,
                sample: Optional[Sample] = None) -> Dict[str, Tensor]:
        """x, x_ce: (B, H, W, C); without ``x_ce`` both branches see ``x``
        (the eval path)."""
        if x_ce is None:
            x_ce = x
        g = dropout_generator
        h = self.encoder(x.permute(0, 3, 1, 2))
        h_ce = self.encoder(x_ce.permute(0, 3, 1, 2))
        flat = flatten_nhwc(self.intermediate_conv(h))
        flat_ce = flatten_nhwc(self.intermediate_conv(h_ce))
        z_mu = self.head(self.mu_layer, flat, g)
        z_mu_ce = self.head(self.mu_layer, flat_ce, g)
        z_log_sigma = self.head(self.sigma_layer, flat, g)
        z_sigma, z = reparameterise(z_mu, z_log_sigma, sample)
        hb, hb_ce = self.expand(z, g), self.expand(z_mu_ce, g)
        return {
            "z_mu": z_mu, "z_mu_ce": z_mu_ce, "z_log_sigma": z_log_sigma,
            "z_sigma": z_sigma,
            "x_hat": self.decoder(hb).permute(0, 2, 3, 1),
            "x_hat_ce": self.decoder(hb_ce).permute(0, 2, 3, 1),
        }


class ContextEncoderVAEZimmerer(VariationalAutoencoderZimmerer):
    """Zimmerer-backbone ceVAE: the Zimmerer VAE's layers over two inputs
    (no normalisation, no dropout)."""

    def forward(self, x: Tensor, x_ce: Optional[Tensor] = None,
                dropout_generator: Optional[RandomSource] = None,
                sample: Optional[Sample] = None) -> Dict[str, Tensor]:
        if x_ce is None:
            x_ce = x
        flat, flat_ce = self.encode(x), self.encode(x_ce)
        outputs = self.latent(flat, sample)
        outputs["z_mu_ce"] = self.mu_layer(flat_ce).to(torch.float32)
        outputs["x_hat"] = self.decode(outputs.pop("z"))
        outputs["x_hat_ce"] = self.decode(outputs["z_mu_ce"])
        return outputs
