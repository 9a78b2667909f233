"""fAnoGAN: a WGAN-GP generator and image critic, and the izif encoder.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/models/
fanogan.py`:

  * ``FAnoGAN``: the unified backbones.  The encoder is the BatchNorm
    unified encoder -> ``intermediate_conv`` -> ``z_layer`` (dropout) ->
    tanh; the generator is ``dec_dense`` (dropout) ->
    ``intermediate_conv_reverse`` -> the LayerNorm unified decoder ->
    sigmoid; the critic is the LayerNorm unified encoder
    (``disc_features``) with ``disc_dense``;
  * ``FAnoGANSchlegl``: the BatchNorm unified encoder -> ``enc_dense`` ->
    tanh, and Schlegl's ResNets: ``gen_dense`` -> ``ResNetDecoder`` (tanh)
    as the generator and ``ResNetEncoder`` (``disc_features``) with
    ``disc_dense`` as the critic; no dropout.

Output keys (both): ``z_enc``, ``x_enc`` (the reconstruction, also
``x_hat_enc``), ``x_``, ``d_fake_features``, ``d_``, ``d_features``,
``d``, ``x_hat``, ``d_hat_features``, ``d_hat``, ``d_enc_features``,
``d_enc``.  The critic's Dense(1) acts on the 4-D feature map, as the
reference's does, so every ``d*`` is a (B, h, w, 1) score map; ``d*`` and
``*_features`` are NHWC float32.  Each forward draws a per-sample
``alpha ~ U[0, 1)`` of shape (B, 1, 1, 1) from ``gp`` (in eval mode too)
for the interpolate ``x_hat = x + alpha * (x_ - x)``.  Without a prior
``z`` the generator's ``x_`` is made from ``z_enc``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

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
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.resnet import (
    ResNetDecoder,
    ResNetEncoder,
)

Tensor = torch.Tensor


def image_critic(features: nn.Module, dense: nn.Module, x: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """(features, score map) of the critic on NHWC images, both NHWC
    float32: the feature trunk, then ``dense`` on every position."""
    feats = features(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return feats.to(torch.float32), dense(feats).to(torch.float32)


class _FAnoGANCore(nn.Module):
    """The forward shared by both fAnoGANs: ``encode``, ``generate`` and
    ``discriminate`` are the subclass's."""

    def discriminate(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        return image_critic(self.disc_features, self.disc_dense, x)

    def forward(self, x: Tensor, z: Optional[Tensor] = None,
                dropout_generator: Optional[RandomSource] = None,
                sample: Optional[Sample] = None,
                gp: Optional[Sample] = None) -> Dict[str, Tensor]:
        """``sample`` is unused (no normal draws); ``gp`` draws alpha."""
        out: Dict[str, Tensor] = {}
        out["z_enc"] = z_enc = self.encode(x, dropout_generator)
        out["x_enc"] = out["x_hat_enc"] = x_enc = self.generate(
            z_enc, dropout_generator)
        out["x_"] = x_ = self.generate(z_enc if z is None else z,
                                       dropout_generator)
        out["d_fake_features"], out["d_"] = self.discriminate(x_)
        out["d_features"], out["d"] = self.discriminate(x)
        alpha = uniform(gp, (x.shape[0], 1, 1, 1), x.device)
        out["x_hat"] = x_hat = x + alpha * (x_ - x)
        out["d_hat_features"], out["d_hat"] = self.discriminate(x_hat)
        out["d_enc_features"], out["d_enc"] = self.discriminate(x_enc)
        return out


class FAnoGAN(_FAnoGANCore):
    """The unified-backbone fAnoGAN."""

    def __init__(self, image_size: int = 128, channels: int = 1,
                 z_dim: int = 128, intermediate_resolution: int = 16,
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
        self.z_layer = Linear(feat * feat * (c // 8), z_dim, dtype)
        self.dec_dense = Linear(z_dim, feat * feat * (c // 8), dtype)
        self.generator = UnifiedDecoder(
            c, image_size, channels, intermediate_resolution, dtype,
            use_batchnorm=False, depth_to_space_head=depth_to_space_head)
        self.disc_features = UnifiedEncoder(
            image_size, channels, intermediate_resolution, dtype,
            use_batchnorm=False, space_to_depth_stem=space_to_depth_stem)
        self.disc_dense = Linear(c, 1, dtype)

    def encode(self, x: Tensor,
               dropout_generator: Optional[RandomSource] = None) -> Tensor:
        """(B, H, W, C) -> tanh latent (B, zDim) float32."""
        flat = flatten_nhwc(self.intermediate_conv(
            self.encoder(x.permute(0, 3, 1, 2))))
        z = dropout(self.z_layer(flat), self.dropout_rate, dropout_generator)
        return torch.tanh(z.to(torch.float32))

    def generate(self, z: Tensor,
                 dropout_generator: Optional[RandomSource] = None) -> Tensor:
        """z -> sigmoid image (B, H, W, C) float32."""
        dec = dropout(self.dec_dense(z), self.dropout_rate, dropout_generator)
        h = self.intermediate_conv_reverse(unflatten_nhwc(dec, self.reshape))
        return torch.sigmoid(self.generator(h)).permute(0, 2, 3, 1)


class FAnoGANSchlegl(_FAnoGANCore):
    """Schlegl's ResNet fAnoGAN (no dropout; ``dropout_rate`` is taken for
    the registry's sake only)."""

    def __init__(self, image_size: int = 128, channels: int = 1,
                 z_dim: int = 64, intermediate_resolution: int = 16,
                 dropout_rate: float = 0.1, dim: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = UnifiedEncoder(image_size, channels,
                                      intermediate_resolution, dtype)
        feat = image_size // 2 ** self.encoder.n
        self.enc_dense = Linear(feat * feat * self.encoder.out_channels,
                                z_dim, dtype)
        # the ResNet generator upsamples x8: its grid is image_size / 8
        inter = image_size // 8
        self.reshape = (inter, inter, 8 * dim)  # NHWC, as Flax
        self.gen_dense = Linear(z_dim, inter * inter * 8 * dim, dtype)
        self.generator = ResNetDecoder(dim, channels, final_tanh=True,
                                       dtype=dtype)
        self.disc_features = ResNetEncoder(dim, channels, dtype)
        self.disc_dense = Linear(8 * dim, 1, dtype)

    def encode(self, x: Tensor,
               dropout_generator: Optional[RandomSource] = None) -> Tensor:
        h = self.encoder(x.permute(0, 3, 1, 2))
        return torch.tanh(self.enc_dense(flatten_nhwc(h)).to(torch.float32))

    def generate(self, z: Tensor,
                 dropout_generator: Optional[RandomSource] = None) -> Tensor:
        h = unflatten_nhwc(self.gen_dense(z), self.reshape)
        return self.generator(h).permute(0, 2, 3, 1)
