"""Deterministic autoencoders: the dense-bottleneck AE and the spatial-latent
AE.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/models/ae.py`.
Take and return NHWC slices; the output dict keys match the JAX package
(``z``, ``x_hat``).  Every model of the port has the call signature
``model(x, [x_ce,] dropout_generator=None, sample=None)``; these two draw
no ``eps`` and ignore ``sample``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    DenseBottleneck,
    RandomSource,
    Sample,
    UnifiedDecoder,
    UnifiedEncoder,
    dropout,
)


class Autoencoder(nn.Module):
    """Dense-bottleneck AE."""

    def __init__(self, image_size: int = 128, channels: int = 1,
                 z_dim: int = 128, intermediate_resolution: int = 8,
                 dropout_rate: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = UnifiedEncoder(
            image_size, channels, intermediate_resolution, dtype=dtype)
        self.bottleneck = DenseBottleneck(
            self.encoder.out_channels, image_size // 2 ** self.encoder.n,
            z_dim, dropout_rate,
            # reference AE quirk: the decoder-dense dropout never fires
            decoder_dropout=False, dtype=dtype)
        self.decoder = UnifiedDecoder(
            self.encoder.out_channels, image_size, channels,
            intermediate_resolution, dtype=dtype)

    def forward(self, x: torch.Tensor,
                dropout_generator: Optional[RandomSource] = None,
                sample: Optional[Sample] = None) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, C) -> {"z": (B, zDim), "x_hat": (B, H, W, C)}.
        Dropout on the latent is drawn from ``dropout_generator``; without
        one the forward is deterministic."""
        h = self.encoder(x.permute(0, 3, 1, 2))
        z, h = self.bottleneck(h, dropout_generator)
        x_hat = self.decoder(h).permute(0, 2, 3, 1)
        return {"z": z, "x_hat": x_hat}


class AutoencoderSpatial(nn.Module):
    """Spatial-latent AE: the unified encoder's output, after dropout, is
    the latent; no dense bottleneck.  ``z_dim`` is unused (kept for a
    uniform constructor)."""

    def __init__(self, image_size: int = 128, channels: int = 1,
                 z_dim: int = 128, intermediate_resolution: int = 8,
                 dropout_rate: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.encoder = UnifiedEncoder(
            image_size, channels, intermediate_resolution, dtype=dtype)
        self.decoder = UnifiedDecoder(
            self.encoder.out_channels, image_size, channels,
            intermediate_resolution, dtype=dtype)

    def forward(self, x: torch.Tensor,
                dropout_generator: Optional[RandomSource] = None,
                sample: Optional[Sample] = None) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, C) -> {"z": (B, h, w, 128) float32, "x_hat"}."""
        z = dropout(self.encoder(x.permute(0, 3, 1, 2)), self.dropout_rate,
                    dropout_generator)
        x_hat = self.decoder(z).permute(0, 2, 3, 1)
        return {"z": z.permute(0, 2, 3, 1).to(torch.float32), "x_hat": x_hat}
