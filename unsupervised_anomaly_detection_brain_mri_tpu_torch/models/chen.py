"""Chen's constrained adversarial autoencoder: the ResNet variant.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/models/
chen.py`: a ResNet encoder (``encoder``, ``dim`` 64), ``enc_dense`` to
``zDim``, ``dec_dense`` back to (H / 8, W / 8, 8 dim) in NHWC order, a
ResNet decoder (``decoder``) and a 400-200-1 latent critic
(``discriminator``).  No BatchNorm and no dropout (``dropout_rate`` and
``intermediate_resolution`` are taken for the registry's sake only).

Output keys: ``z_`` (also ``z``), ``x_hat``, ``z_rec`` (the reconstruction
encoded again, always), and with a prior latent ``z`` the critic's ``d``,
``d_`` and ``d_hat``.  The interpolate uses ONE scalar ``eps ~ U[0, 1)``
drawn from ``gp``: ``z_hat = eps * z + (1 - eps) * z_``, the other
direction from ``models/aae.py``'s per-sample ``z + eps * (z - z_)``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    Linear,
    MLPDiscriminator,
    RandomSource,
    Sample,
    flatten_nhwc,
    uniform,
    unflatten_nhwc,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.resnet import (
    ResNetDecoder,
    ResNetEncoder,
)

Tensor = torch.Tensor


class ConstrainedAAEChen(nn.Module):
    """Chen's ResNet constrained AAE."""

    def __init__(self, image_size: int = 128, channels: int = 1,
                 z_dim: int = 128, intermediate_resolution: int = 16,
                 dropout_rate: float = 0.1, dim: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        feat = image_size // 8
        self.reshape = (feat, feat, 8 * dim)  # NHWC, as Flax
        self.encoder = ResNetEncoder(dim, channels, dtype)
        self.enc_dense = Linear(feat * feat * 8 * dim, z_dim, dtype)
        self.dec_dense = Linear(z_dim, feat * feat * 8 * dim, dtype)
        self.decoder = ResNetDecoder(dim, channels, dtype=dtype)
        self.discriminator = MLPDiscriminator(z_dim, (400, 200), dtype)

    def encode(self, x: Tensor) -> Tensor:
        """(B, H, W, C) -> z (B, zDim) float32."""
        h = self.encoder(x.permute(0, 3, 1, 2))
        return self.enc_dense(flatten_nhwc(h)).to(torch.float32)

    def decode(self, z: Tensor) -> Tensor:
        """z (B, zDim) -> x_hat (B, H, W, C) float32."""
        h = unflatten_nhwc(self.dec_dense(z), self.reshape)
        return self.decoder(h).permute(0, 2, 3, 1)

    def discriminate(self, z: Tensor) -> Tensor:
        return self.discriminator(z)

    def forward(self, x: Tensor, z: Optional[Tensor] = None,
                dropout_generator: Optional[RandomSource] = None,
                sample: Optional[Sample] = None,
                gp: Optional[Sample] = None) -> Dict[str, Tensor]:
        """``dropout_generator`` and ``sample`` are unused (no dropout, no
        normal draws); ``gp`` draws the scalar eps when ``z`` is given."""
        z_ = self.encode(x)
        out = {"z_": z_, "z": z_}
        out["x_hat"] = x_hat = self.decode(z_)
        out["z_rec"] = self.encode(x_hat)
        if z is not None:
            out["d_"] = self.discriminate(z_)
            out["d"] = self.discriminate(z)
            eps = uniform(gp, (), z.device)
            out["z_hat"] = z_hat = eps * z + (1.0 - eps) * z_
            out["d_hat"] = self.discriminate(z_hat)
        return out
