"""Adversarial and constrained autoencoders (the latent-critic WGAN-GP
family): the adversarial AE, the constrained adversarial AE and the
constrained AE.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/models/
aae.py`.  Output keys: ``z_`` (the encoded latent, also ``z``), ``x_hat``,
``z_rec`` (constrained variants: the reconstruction encoded again through
the same encoder), and, when a prior latent ``z`` is given, the critic's
outputs ``d`` (on ``z``), ``d_`` (on ``z_``) and ``d_hat`` (on the
interpolate ``z_hat``).

The interpolate keeps the reference's direction quirk ``z_hat = z + eps *
(z - z_)``, with one ``eps ~ U[0, 1)`` per sample drawn from ``gp`` (a
generator, or the noise as a (B, 1) tensor).  The gradient penalty
itself is the trainer's (``train/gan.py``).  In the constrained
adversarial model the decoder-dense and ``z_rec`` dropouts never fire (the
reference's calls lack the training flag); in the other two they do.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    Conv2d,
    Linear,
    MLPDiscriminator,
    RandomSource,
    Sample,
    UnifiedDecoder,
    UnifiedEncoder,
    dropout,
    flatten_nhwc,
    uniform,
    unflatten_nhwc,
)

Tensor = torch.Tensor


class _AAECore(nn.Module):
    """The unified encoder, a dense bottleneck (``intermediate_conv``,
    ``z_layer``, ``dec_dense``, ``intermediate_conv_reverse`` at the top of
    the tree), the unified decoder and, ``with_discriminator``, the latent
    critic."""

    def __init__(self, image_size: int = 128, channels: int = 1,
                 z_dim: int = 128, intermediate_resolution: int = 16,
                 dropout_rate: float = 0.1,
                 disc_hidden: Sequence[int] = (50, 50),
                 constrained: bool = False, with_discriminator: bool = True,
                 dtype: torch.dtype = torch.float32,
                 space_to_depth_stem: bool = False,
                 depth_to_space_head: bool = False):
        super().__init__()
        self.constrained = constrained
        self.with_discriminator = with_discriminator
        self.dropout_rate = dropout_rate
        self.encoder = UnifiedEncoder(
            image_size, channels, intermediate_resolution, dtype=dtype,
            space_to_depth_stem=space_to_depth_stem)
        self.decoder = UnifiedDecoder(
            self.encoder.out_channels, image_size, channels,
            intermediate_resolution, dtype=dtype,
            depth_to_space_head=depth_to_space_head)
        # min(128, 32 * 2^(n - 1)): 128 at intermediate resolution 16
        c = self.encoder.out_channels
        feat = image_size // 2 ** self.encoder.n
        self.reshape = (feat, feat, c // 8)  # NHWC, as Flax
        self.intermediate_conv = Conv2d(c, c // 8, 1, 1, dtype)
        self.intermediate_conv_reverse = Conv2d(c // 8, c, 1, 1, dtype)
        self.z_layer = Linear(feat * feat * (c // 8), z_dim, dtype)
        self.dec_dense = Linear(z_dim, feat * feat * (c // 8), dtype)
        if with_discriminator:
            self.discriminator = MLPDiscriminator(z_dim, disc_hidden, dtype)

    def encode(self, x: Tensor,
               dropout_generator: Optional[RandomSource] = None) -> Tensor:
        """(B, H, W, C) -> z (B, zDim) float32."""
        flat = flatten_nhwc(self.intermediate_conv(
            self.encoder(x.permute(0, 3, 1, 2))))
        return dropout(self.z_layer(flat), self.dropout_rate,
                       dropout_generator).to(torch.float32)

    def decode(self, z: Tensor,
               dropout_generator: Optional[RandomSource] = None) -> Tensor:
        """z (B, zDim) -> x_hat (B, H, W, C) float32."""
        dec = dropout(self.dec_dense(z), self.dropout_rate, dropout_generator)
        h = self.intermediate_conv_reverse(unflatten_nhwc(dec, self.reshape))
        return self.decoder(h).permute(0, 2, 3, 1)

    def discriminate(self, z: Tensor) -> Tensor:
        return self.discriminator(z)

    def forward(self, x: Tensor, z: Optional[Tensor] = None,
                dropout_generator: Optional[RandomSource] = None,
                sample: Optional[Sample] = None,
                gp: Optional[Sample] = None) -> Dict[str, Tensor]:
        """``sample`` is unused (no model of this family draws a normal);
        ``gp`` draws the interpolate's eps when ``z`` is given."""
        z_ = self.encode(x, dropout_generator)
        out = {"z_": z_, "z": z_}
        quirk = self.constrained and self.with_discriminator
        late = None if quirk else dropout_generator
        out["x_hat"] = x_hat = self.decode(z_, late)
        if self.constrained:
            out["z_rec"] = self.encode(x_hat, late)
        if z is not None:
            out["d_"] = self.discriminate(z_)
            out["d"] = self.discriminate(z)
            eps = uniform(gp, (z.shape[0], 1), z.device)
            out["z_hat"] = z_hat = z + eps * (z - z_)
            out["d_hat"] = self.discriminate(z_hat)
        return out


class AdversarialAutoencoder(_AAECore):
    """The adversarial AE, with a 50-50-1 critic."""

    def __init__(self, image_size: int = 128, channels: int = 1,
                 z_dim: int = 128, intermediate_resolution: int = 16,
                 dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 space_to_depth_stem: bool = False,
                 depth_to_space_head: bool = False):
        super().__init__(image_size, channels, z_dim, intermediate_resolution,
                         dropout_rate, (50, 50), dtype=dtype,
                         space_to_depth_stem=space_to_depth_stem,
                         depth_to_space_head=depth_to_space_head)


class ConstrainedAAE(_AAECore):
    """The constrained adversarial AE, with a 100-50-1 critic."""

    def __init__(self, image_size: int = 128, channels: int = 1,
                 z_dim: int = 128, intermediate_resolution: int = 16,
                 dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 space_to_depth_stem: bool = False,
                 depth_to_space_head: bool = False):
        super().__init__(image_size, channels, z_dim, intermediate_resolution,
                         dropout_rate, (100, 50), constrained=True,
                         dtype=dtype, space_to_depth_stem=space_to_depth_stem,
                         depth_to_space_head=depth_to_space_head)


class ConstrainedAutoencoder(nn.Module):
    """The constrained AE: a critic-less constrained core under ``core``,
    as in the Flax tree.  Outputs ``z``, ``x_hat`` and ``z_rec``."""

    def __init__(self, image_size: int = 128, channels: int = 1,
                 z_dim: int = 1024, intermediate_resolution: int = 16,
                 dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 space_to_depth_stem: bool = False,
                 depth_to_space_head: bool = False):
        super().__init__()
        self.core = _AAECore(image_size, channels, z_dim,
                             intermediate_resolution, dropout_rate,
                             constrained=True, with_discriminator=False,
                             dtype=dtype,
                             space_to_depth_stem=space_to_depth_stem,
                             depth_to_space_head=depth_to_space_head)

    def forward(self, x: Tensor,
                dropout_generator: Optional[RandomSource] = None,
                sample: Optional[Sample] = None) -> Dict[str, Tensor]:
        out = self.core(x, None, dropout_generator)
        return {"z": out["z_"], "x_hat": out["x_hat"], "z_rec": out["z_rec"]}
