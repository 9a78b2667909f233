"""Dense-bottleneck autoencoder.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/models/ae.py::
Autoencoder`.  Takes and returns NHWC slices; the output dict keys match
the JAX package (``z``, ``x_hat``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    DenseBottleneck,
    UnifiedDecoder,
    UnifiedEncoder,
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
                dropout_generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, C) -> {"z": (B, zDim), "x_hat": (B, H, W, C)}.
        Dropout on the latent is drawn from ``dropout_generator``; without
        one the forward is deterministic."""
        h = self.encoder(x.permute(0, 3, 1, 2))
        z, h = self.bottleneck(h, dropout_generator)
        x_hat = self.decoder(h).permute(0, 2, 3, 1)
        return {"z": z, "x_hat": x_hat}
