"""Variational autoencoders: the unified-backbone VAE and Zimmerer's VAE.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/models/vae.py`.
Output keys: ``z_mu``, ``z_log_sigma``, ``z_sigma``, ``x_hat``.

``eps ~ N(0, 1)`` is drawn on *every* forward, in eval mode too, so a VAE
reconstruction is stochastic: the forward takes ``sample``, a generator (or
``VolumeGenerators``) to draw ``eps`` from, or the noise itself as a tensor
(``models/layers.py``).  Dropout (unified VAE only) is drawn from
``dropout_generator``, and is off without one.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    LEAKY_SLOPE_ZIMMERER,
    Conv2d,
    ConvTranspose2d,
    Linear,
    RandomSource,
    Sample,
    UnifiedDecoder,
    UnifiedEncoder,
    dropout,
    flatten_nhwc,
    leaky_relu,
    standard_normal,
    unflatten_nhwc,
)

Tensor = torch.Tensor


def reparameterise(z_mu: Tensor, z_log_sigma: Tensor,
                   sample: Optional[Sample]) -> Tuple[Tensor, Tensor]:
    """(z_sigma, z = z_mu + eps * z_sigma), float32."""
    z_sigma = torch.exp(z_log_sigma)
    eps = standard_normal(sample, z_sigma.shape, z_sigma.device)
    return z_sigma, z_mu + eps * z_sigma


class VAEBottleneck(nn.Module):
    """1x1-conv squeeze to C/8 -> NHWC flatten -> Dense mu and Dense
    log-sigma heads (dropout on both) -> reparameterise -> Dense back up
    (dropout) -> 1x1 expand to C.  ``models/cevae.py::ContextEncoderVAE``
    subclasses it: there the same layers sit at the top of the tree and run
    over two inputs."""

    def __init__(self, channels: int, spatial: int, z_dim: int,
                 dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        squeezed = channels // 8
        self.reshape = (spatial, spatial, squeezed)  # NHWC, as Flax
        flat = math.prod(self.reshape)
        self.dropout_rate = dropout_rate
        self.intermediate_conv = Conv2d(channels, squeezed, 1, 1, dtype)
        self.mu_layer = Linear(flat, z_dim, dtype)
        self.sigma_layer = Linear(flat, z_dim, dtype)
        self.dec_dense = Linear(z_dim, flat, dtype)
        self.intermediate_conv_reverse = Conv2d(squeezed, channels, 1, 1,
                                                dtype)

    def head(self, layer: nn.Module, flat: Tensor,
             generator: Optional[RandomSource]) -> Tensor:
        """A latent head with dropout, cast to float32."""
        return dropout(layer(flat), self.dropout_rate,
                       generator).to(torch.float32)

    def expand(self, z: Tensor, generator: Optional[RandomSource]) -> Tensor:
        """Dense back up (dropout) and the 1x1 expand: (B, C, h, w)."""
        dec = dropout(self.dec_dense(z), self.dropout_rate, generator)
        return self.intermediate_conv_reverse(unflatten_nhwc(dec,
                                                             self.reshape))

    def forward(self, h: Tensor, dropout_generator: Optional[RandomSource],
                sample: Optional[Sample]) -> Tuple[Dict[str, Tensor], Tensor]:
        flat = flatten_nhwc(self.intermediate_conv(h))
        z_mu = self.head(self.mu_layer, flat, dropout_generator)
        z_log_sigma = self.head(self.sigma_layer, flat, dropout_generator)
        z_sigma, z = reparameterise(z_mu, z_log_sigma, sample)
        outputs = {"z_mu": z_mu, "z_log_sigma": z_log_sigma,
                   "z_sigma": z_sigma}
        return outputs, self.expand(z, dropout_generator)


class VariationalAutoencoder(nn.Module):
    """Unified-backbone VAE."""

    def __init__(self, image_size: int = 128, channels: int = 1,
                 z_dim: int = 128, intermediate_resolution: int = 8,
                 dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 space_to_depth_stem: bool = False,
                 depth_to_space_head: bool = False):
        super().__init__()
        self.encoder = UnifiedEncoder(
            image_size, channels, intermediate_resolution, dtype=dtype,
            space_to_depth_stem=space_to_depth_stem)
        self.bottleneck = VAEBottleneck(
            self.encoder.out_channels, image_size // 2 ** self.encoder.n,
            z_dim, dropout_rate, dtype)
        self.decoder = UnifiedDecoder(
            self.encoder.out_channels, image_size, channels,
            intermediate_resolution, dtype=dtype,
            depth_to_space_head=depth_to_space_head)

    def forward(self, x: Tensor,
                dropout_generator: Optional[RandomSource] = None,
                sample: Optional[Sample] = None) -> Dict[str, Tensor]:
        h = self.encoder(x.permute(0, 3, 1, 2))
        outputs, h = self.bottleneck(h, dropout_generator, sample)
        outputs["x_hat"] = self.decoder(h).permute(0, 2, 3, 1)
        return outputs


class VariationalAutoencoderZimmerer(nn.Module):
    """Zimmerer's VAE: four 4x4 stride-2 convolutions of 16/64/256/1024
    filters with LeakyReLU 0.2 and no normalisation, Dense mu/log-sigma
    heads, Dense back to (size/16)^2 x 1024, four mirrored 4x4 stride-2
    transposed convolutions, and a final 4x4 stride-1 convolution.  It has
    no dropout (``dropout_rate`` is unused)."""

    FILTERS = (16, 64, 256, 1024)

    def __init__(self, image_size: int = 128, channels: int = 1,
                 z_dim: int = 128, intermediate_resolution: int = 8,
                 dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channels
        for i, f in enumerate(self.FILTERS):
            self.add_module(f"enc_conv_{i + 1}", Conv2d(c, f, 4, 2, dtype))
            c = f
        inter = image_size // 16  # 4 stride-2 stages
        self.reshape = (inter, inter, 1024)
        flat = math.prod(self.reshape)
        self.mu_layer = Linear(flat, z_dim, dtype)
        self.sigma_layer = Linear(flat, z_dim, dtype)
        self.dec_dense = Linear(z_dim, flat, dtype)
        for i, f in enumerate(self.FILTERS[::-1]):
            self.add_module(f"dec_convT_{i + 1}",
                            ConvTranspose2d(c, f, 4, dtype))
            c = f
        self.dec_conv_final = Conv2d(c, channels, 4, 1, dtype)

    def encode(self, x: Tensor) -> Tensor:
        """(B, H, W, C) -> the NHWC-flattened features (B, inter^2 * 1024)."""
        h = x.permute(0, 3, 1, 2)
        for i in range(len(self.FILTERS)):
            h = leaky_relu(getattr(self, f"enc_conv_{i + 1}")(h),
                           LEAKY_SLOPE_ZIMMERER)
        return flatten_nhwc(h)

    def decode(self, z: Tensor) -> Tensor:
        """latent (B, zDim) -> x_hat (B, H, W, C) float32."""
        h = unflatten_nhwc(self.dec_dense(z), self.reshape)
        for i in range(len(self.FILTERS)):
            h = leaky_relu(getattr(self, f"dec_convT_{i + 1}")(h),
                           LEAKY_SLOPE_ZIMMERER)
        return self.dec_conv_final(h).to(torch.float32).permute(0, 2, 3, 1)

    def latent(self, flat: Tensor, sample: Optional[Sample]
               ) -> Dict[str, Tensor]:
        z_mu = self.mu_layer(flat).to(torch.float32)
        z_log_sigma = self.sigma_layer(flat).to(torch.float32)
        z_sigma, z = reparameterise(z_mu, z_log_sigma, sample)
        return {"z_mu": z_mu, "z_log_sigma": z_log_sigma, "z_sigma": z_sigma,
                "z": z}

    def forward(self, x: Tensor,
                dropout_generator: Optional[RandomSource] = None,
                sample: Optional[Sample] = None) -> Dict[str, Tensor]:
        outputs = self.latent(self.encode(x), sample)
        outputs["x_hat"] = self.decode(outputs.pop("z"))
        return outputs
