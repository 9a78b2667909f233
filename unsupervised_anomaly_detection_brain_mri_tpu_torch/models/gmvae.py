"""Gaussian-mixture variational autoencoders: the dense GMVAE, the
spatial-latent GMVAE and You et al.'s GMVAE.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/models/
gmvae.py`.  Output keys (all three): ``w_mu``, ``w_log_sigma``,
``w_sampled``, ``z_mu``, ``z_log_sigma``, ``z_sampled``, ``z_wc_mus``,
``z_wc_log_sigma_invs``, ``z_wc_sampled``, ``xz_mu``, ``pc_logit``, ``pc``,
and ``x_hat`` (the same tensor as ``xz_mu``).  Spatial outputs are NHWC,
with the mixture axes last: ``z_wc_mus`` is (B, h, w, dim_z, dim_c).

The reference's quirks are kept (they change the learned model):
  * ``z_wc_log_sigma`` gets a trainable bias ``z_wc_log_sigma_inv_bias``
    that starts at 0.1 (``init_bare_parameters``);
  * ``z_wc_sampled`` uses ``exp(log_sigma_inv)`` as its std;
  * the mixture log-likelihood adds ``+ log(pi)``;
  * the dense variant has no dropout on ``z_log_sigma``;
  * the spatial decoder reads the encoder features, not the sample;
  * ``GMVAEYou`` uses ReLU throughout and its ``dec_conv_10`` has no
    activation.

Each forward draws three normals, in this order: ``w``, ``z`` and ``z_wc``
(in eval mode too), from ``sample``: a generator, a ``VolumeGenerators``,
or given noise as a dict ``{"w": ..., "z": ..., "z_wc": ...}``.  Dropout
(dense variant only) is drawn from ``dropout_generator``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    Linear,
    RandomSource,
    Sample,
    UnifiedDecoder,
    UnifiedEncoder,
    dropout,
    flatten_nhwc,
    standard_normal,
    unflatten_nhwc,
    upsample_nearest2x,
)

Tensor = torch.Tensor

LOG_PI = math.log(math.pi)
SIGMA_INV_BIAS_INIT = 0.1


def _mixture_posterior(z_sampled: Tensor, z_wc_mus: Tensor,
                       z_wc_log_sigma_invs: Tensor) -> Dict[str, Tensor]:
    """p(c) from the log-likelihood of z under each component, reduced over
    the dim_z axis.  Dense: z (B, dz), mus (B, dz, C); spatial: z
    (B, h, w, dz), mus (B, h, w, dz, C)."""
    loglh = (-0.5 * (torch.square(z_sampled.unsqueeze(-1) - z_wc_mus)
                     * torch.exp(z_wc_log_sigma_invs))
             - z_wc_log_sigma_invs + LOG_PI)
    pc_logit = torch.sum(loglh, dim=-2)
    return {"pc_logit": pc_logit, "pc": torch.softmax(pc_logit, dim=-1)}


def _gaussian(mu: Tensor, log_sigma: Tensor, sample: Optional[Sample],
              name: str) -> Tensor:
    """``mu + eps * exp(0.5 * log_sigma)``, eps the draw ``name``."""
    eps = standard_normal(sample, mu.shape, mu.device, name)
    return mu + eps * torch.exp(0.5 * log_sigma)


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1).to(torch.float32)


class GMVAE(nn.Module):
    """Dense-latent GMVAE: the unified encoder, a 1x1 squeeze to C/8, Dense
    heads for w and z, the prior net p(z | w, c) from ``w_sampled``, and the
    decoder from ``z_sampled`` through Dense back up and a 1x1 expand."""

    def __init__(self, image_size: int = 128, channels: int = 1,
                 intermediate_resolution: int = 8, dim_c: int = 6,
                 dim_z: int = 1, dim_w: int = 1, dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim_c, self.dim_z = dim_c, dim_z
        self.dropout_rate = dropout_rate
        self.encoder = UnifiedEncoder(
            image_size, channels, intermediate_resolution, dtype=dtype)
        c = self.encoder.out_channels
        spatial = image_size // 2 ** self.encoder.n
        self.reshape = (spatial, spatial, c // 8)  # NHWC, as Flax
        flat = math.prod(self.reshape)
        self.intermediate_conv = Conv2d(c, c // 8, 1, 1, dtype)
        self.w_mu_layer = Linear(flat, dim_w, dtype)
        self.w_log_sigma_layer = Linear(flat, dim_w, dtype)
        self.z_mu_layer = Linear(flat, dim_z, dtype)
        self.z_log_sigma_layer = Linear(flat, dim_z, dtype)
        self.z_wc_mu_layer = Linear(dim_w, dim_z * dim_c, dtype)
        self.z_wc_log_sigma_layer = Linear(dim_w, dim_z * dim_c, dtype)
        self.z_wc_log_sigma_inv_bias = nn.Parameter(
            torch.full((dim_z * dim_c,), SIGMA_INV_BIAS_INIT))
        self.dec_dense = Linear(dim_z, flat, dtype)
        self.intermediate_conv_reverse = Conv2d(c // 8, c, 1, 1, dtype)
        self.decoder = UnifiedDecoder(c, image_size, channels,
                                      intermediate_resolution, dtype=dtype)

    def init_bare_parameters(self) -> None:
        with torch.no_grad():
            self.z_wc_log_sigma_inv_bias.fill_(SIGMA_INV_BIAS_INIT)

    def forward(self, x: Tensor,
                dropout_generator: Optional[RandomSource] = None,
                sample: Optional[Sample] = None) -> Dict[str, Tensor]:
        flat = flatten_nhwc(self.intermediate_conv(
            self.encoder(x.permute(0, 3, 1, 2))))

        def head(layer: nn.Module, drop: bool = True) -> Tensor:
            out = layer(flat)
            if drop:
                out = dropout(out, self.dropout_rate, dropout_generator)
            return out.to(torch.float32)

        w_mu, w_log_sigma = head(self.w_mu_layer), head(self.w_log_sigma_layer)
        w_sampled = _gaussian(w_mu, w_log_sigma, sample, "w")
        z_mu = head(self.z_mu_layer)
        # reference quirk: no dropout on z_log_sigma
        z_log_sigma = head(self.z_log_sigma_layer, drop=False)
        z_sampled = _gaussian(z_mu, z_log_sigma, sample, "z")

        shape = (-1, self.dim_z, self.dim_c)
        z_wc_mus = self.z_wc_mu_layer(w_sampled).to(torch.float32).reshape(
            shape)
        z_wc_log_sigma_invs = (
            self.z_wc_log_sigma_layer(w_sampled).to(torch.float32)
            + self.z_wc_log_sigma_inv_bias).reshape(shape)
        z_wc_sampled = z_wc_mus + standard_normal(
            sample, z_wc_mus.shape, x.device, "z_wc") * torch.exp(
                z_wc_log_sigma_invs)

        dec = dropout(self.dec_dense(z_sampled), self.dropout_rate,
                      dropout_generator)
        xz_mu = self.decoder(self.intermediate_conv_reverse(
            unflatten_nhwc(dec, self.reshape))).permute(0, 2, 3, 1)
        out = dict(w_mu=w_mu, w_log_sigma=w_log_sigma, w_sampled=w_sampled,
                   z_mu=z_mu, z_log_sigma=z_log_sigma, z_sampled=z_sampled,
                   z_wc_mus=z_wc_mus, z_wc_log_sigma_invs=z_wc_log_sigma_invs,
                   z_wc_sampled=z_wc_sampled, xz_mu=xz_mu)
        out.update(_mixture_posterior(z_sampled, z_wc_mus,
                                      z_wc_log_sigma_invs))
        out["x_hat"] = xz_mu
        return out


class _SpatialGMVAEHeads(nn.Module):
    """The spatial variants' latent heads and prior net, 1x1 convolutions:
    w and z heads from the features, ``p_z_wc_conv`` (64, ReLU) from
    ``w_sampled``, then the ``z_wc`` mean and log-sigma heads."""

    def __init__(self, in_channels: int, dim_c: int, dim_z: int, dim_w: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim_c, self.dim_z = dim_c, dim_z
        self.w_mu = Conv2d(in_channels, dim_w, 1, 1, dtype)
        self.w_log_sigma = Conv2d(in_channels, dim_w, 1, 1, dtype)
        self.z_mu = Conv2d(in_channels, dim_z, 1, 1, dtype)
        self.z_log_sigma = Conv2d(in_channels, dim_z, 1, 1, dtype)
        self.p_z_wc_conv = Conv2d(dim_w, 64, 1, 1, dtype)
        self.z_wc_mu = Conv2d(64, dim_z * dim_c, 1, 1, dtype)
        self.z_wc_log_sigma = Conv2d(64, dim_z * dim_c, 1, 1, dtype)
        self.z_wc_log_sigma_inv_bias = nn.Parameter(
            torch.full((dim_z * dim_c,), SIGMA_INV_BIAS_INIT))

    def init_bare_parameters(self) -> None:
        with torch.no_grad():
            self.z_wc_log_sigma_inv_bias.fill_(SIGMA_INV_BIAS_INIT)

    def forward(self, enc: Tensor, sample: Optional[Sample]
                ) -> Dict[str, Tensor]:
        """enc: (B, C, h, w) -> the latent outputs, NHWC float32."""
        w_mu, w_log_sigma = _nhwc(self.w_mu(enc)), _nhwc(
            self.w_log_sigma(enc))
        w_sampled = _gaussian(w_mu, w_log_sigma, sample, "w")
        z_mu, z_log_sigma = _nhwc(self.z_mu(enc)), _nhwc(
            self.z_log_sigma(enc))
        z_sampled = _gaussian(z_mu, z_log_sigma, sample, "z")

        mid = F.relu(self.p_z_wc_conv(w_sampled.permute(0, 3, 1, 2)))
        shape = tuple(mid.shape[:1]) + tuple(mid.shape[2:]) + (
            self.dim_z, self.dim_c)
        z_wc_mus = _nhwc(self.z_wc_mu(mid)).reshape(shape)
        z_wc_log_sigma_invs = (_nhwc(self.z_wc_log_sigma(mid))
                               + self.z_wc_log_sigma_inv_bias).reshape(shape)
        z_wc_sampled = z_wc_mus + standard_normal(
            sample, shape, enc.device, "z_wc") * torch.exp(
                z_wc_log_sigma_invs)
        out = dict(w_mu=w_mu, w_log_sigma=w_log_sigma, w_sampled=w_sampled,
                   z_mu=z_mu, z_log_sigma=z_log_sigma, z_sampled=z_sampled,
                   z_wc_mus=z_wc_mus, z_wc_log_sigma_invs=z_wc_log_sigma_invs,
                   z_wc_sampled=z_wc_sampled)
        out.update(_mixture_posterior(z_sampled, z_wc_mus,
                                      z_wc_log_sigma_invs))
        return out


class GMVAESpatial(nn.Module):
    """Spatial-latent GMVAE: the unified encoder, the spatial heads, and the
    unified decoder reading the encoder features (reference quirk).  It has
    no dropout (``dropout_rate`` is unused)."""

    def __init__(self, image_size: int = 128, channels: int = 1,
                 intermediate_resolution: int = 8, dim_c: int = 9,
                 dim_z: int = 1, dim_w: int = 1, dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = UnifiedEncoder(
            image_size, channels, intermediate_resolution, dtype=dtype)
        c = self.encoder.out_channels
        self.heads = _SpatialGMVAEHeads(c, dim_c, dim_z, dim_w, dtype)
        self.decoder = UnifiedDecoder(c, image_size, channels,
                                      intermediate_resolution, dtype=dtype)

    def forward(self, x: Tensor,
                dropout_generator: Optional[RandomSource] = None,
                sample: Optional[Sample] = None) -> Dict[str, Tensor]:
        enc = self.encoder(x.permute(0, 3, 1, 2))
        out = self.heads(enc, sample)
        out["xz_mu"] = out["x_hat"] = self.decoder(enc).permute(0, 2, 3, 1)
        return out


class GMVAEYou(nn.Module):
    """You et al.'s GMVAE: six 64-filter 3x3 convolutions (strides 2, 1, 1,
    2, 1, 1), the spatial heads, and a decoder from ``z_sampled``: conv,
    two stride-1 3x3 transposed convolutions, nearest x2, conv, two more,
    nearest x2, ``dec_conv_10`` (no activation), ``xz_mu_layer``; ReLU
    elsewhere.  ``intermediate_resolution`` and ``dropout_rate`` are
    unused."""

    STRIDES = (2, 1, 1, 2, 1, 1)

    def __init__(self, image_size: int = 128, channels: int = 1,
                 intermediate_resolution: int = 8, dim_c: int = 9,
                 dim_z: int = 1, dim_w: int = 1, dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channels
        for i, s in enumerate(self.STRIDES):
            self.add_module(f"enc_conv_{i + 1}", Conv2d(c, 64, 3, s, dtype))
            c = 64
        self.heads = _SpatialGMVAEHeads(64, dim_c, dim_z, dim_w, dtype)
        self.dec_conv_8 = Conv2d(dim_z, 64, 3, 1, dtype)
        self.dec_conv_9 = Conv2d(64, 64, 3, 1, dtype)
        self.dec_conv_10 = Conv2d(64, 64, 3, 1, dtype)
        for i in range(1, 5):
            self.add_module(f"dec_convT_{i}",
                            ConvTranspose2d(64, 64, 3, dtype, stride=1))
        self.xz_mu_layer = Conv2d(64, channels, 3, 1, dtype)

    def forward(self, x: Tensor,
                dropout_generator: Optional[RandomSource] = None,
                sample: Optional[Sample] = None) -> Dict[str, Tensor]:
        h = x.permute(0, 3, 1, 2)
        for i in range(len(self.STRIDES)):
            h = F.relu(getattr(self, f"enc_conv_{i + 1}")(h))
        out = self.heads(h, sample)
        v = F.relu(self.dec_conv_8(out["z_sampled"].permute(0, 3, 1, 2)))
        v = F.relu(self.dec_convT_2(F.relu(self.dec_convT_1(v))))
        v = F.relu(self.dec_conv_9(upsample_nearest2x(v)))
        v = F.relu(self.dec_convT_4(F.relu(self.dec_convT_3(v))))
        v = self.dec_conv_10(upsample_nearest2x(v))
        out["xz_mu"] = out["x_hat"] = self.xz_mu_layer(v).to(
            torch.float32).permute(0, 2, 3, 1)
        return out
