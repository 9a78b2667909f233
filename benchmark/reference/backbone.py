"""The unified backbone of Baur et al. (the reference repository's
``models/autoencoder.py`` and ``variational_autoencoder.py``), in plain
float32 over explicit parameters.

Encoder: per stage a 5x5 stride-2 SAME convolution to min(128, 32 * 2^i)
filters, BatchNorm, LeakyReLU 0.3, down to ``intermediateResolutions``.
Bottleneck: a 1x1 convolution to C/8 channels, flattened in (h, w, c)
order; the AE's dense z (dropout) and dense back; the VAE's dense mu and
log-sigma heads (dropout on each), z = mu + eps * exp(log-sigma), dense
back (dropout); unflattened, a 1x1 convolution back to C.  Decoder:
BatchNorm, ReLU, per stage a 5x5 stride-2 SAME transposed convolution to
max(32, 128 / 2^i) filters, BatchNorm, LeakyReLU 0.3, then a 1x1
convolution to the image's channels.  The AE's decoder-side dropout never
fires (the reference calls it without its training flag).

Parameter names are the leaves' names in the port's ``state_dict``, so the
harness hands both sides one dict.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from benchmark.reference import layers as R

Tensor = torch.Tensor
Leaf = Tuple[str, Tuple[int, ...], str]  # name, shape, init


def _conv_leaves(name: str, cin: int, cout: int, k: int) -> List[Leaf]:
    return [(f"{name}.weight", (cout, cin, k, k), "glorot"),
            (f"{name}.bias", (cout,), "zeros")]


def _norm_leaves(name: str, c: int) -> List[Leaf]:
    return [(f"{name}.weight", (c,), "ones"), (f"{name}.bias", (c,), "zeros")]


def _norm_buffers(name: str, c: int) -> List[Leaf]:
    return [(f"{name}.running_mean", (c,), "zeros"),
            (f"{name}.running_var", (c,), "ones")]


def encoder_channels(cfg: Dict) -> List[int]:
    n = R.stages(cfg["outputWidth"], cfg["intermediateResolutions"][0])
    return [int(min(128, 32 * 2 ** i)) for i in range(n)]


def decoder_channels(cfg: Dict) -> List[int]:
    n = R.stages(cfg["outputWidth"], cfg["intermediateResolutions"][0])
    return [int(max(32, 128 // 2 ** i)) for i in range(n)]


def leaves(cfg: Dict, variational: bool) -> Tuple[List[Leaf], List[Leaf]]:
    """(parameters, buffers) of the backbone: names, shapes, inits."""
    params, bufs = [], []
    c = cfg["numChannels"]
    for i, f in enumerate(encoder_channels(cfg)):
        params += _conv_leaves(f"encoder.enc_conv_{i}", c, f, 5)
        params += _norm_leaves(f"encoder.enc_norm_{i}", f)
        bufs += _norm_buffers(f"encoder.enc_norm_{i}", f)
        c = f
    sq = c // 8
    side = cfg["intermediateResolutions"][0]
    flat = side * side * sq
    z = cfg["zDim"]
    params += _conv_leaves("bottleneck.intermediate_conv", c, sq, 1)
    heads = ("mu_layer", "sigma_layer") if variational else ("z_layer",)
    for h in heads:
        params += [(f"bottleneck.{h}.weight", (z, flat), "glorot"),
                   (f"bottleneck.{h}.bias", (z,), "zeros")]
    params += [("bottleneck.dec_dense.weight", (flat, z), "glorot"),
               ("bottleneck.dec_dense.bias", (flat,), "zeros")]
    params += _conv_leaves("bottleneck.intermediate_conv_reverse", sq, c, 1)
    params += _norm_leaves("decoder.dec_norm_in", c)
    bufs += _norm_buffers("decoder.dec_norm_in", c)
    for i, f in enumerate(decoder_channels(cfg)):
        params += [(f"decoder.dec_convT_{i}.weight", (c, f, 5, 5), "glorot"),
                   (f"decoder.dec_convT_{i}.bias", (f,), "zeros")]
        params += _norm_leaves(f"decoder.dec_norm_{i}", f)
        bufs += _norm_buffers(f"decoder.dec_norm_{i}", f)
        c = f
    params += _conv_leaves("decoder.dec_conv_final", c, cfg["numChannels"],
                           1)
    return params, bufs


class Net:
    """One forward over parameters ``p`` and BatchNorm statistics ``b``
    (updated in place in training, as the running averages move with
    ``momentum``, 0.99, towards the batch's biased statistics; momentum 0
    sets them to the batch's)."""

    def __init__(self, p: Dict[str, Tensor], b: Dict[str, Tensor],
                 train: bool, precision: str, momentum: float = 0.99):
        self.p, self.b, self.train, self.precision = p, b, train, precision
        self.momentum = momentum

    def norm(self, name: str, x: Tensor) -> Tensor:
        y, mean, var = R.batchnorm(
            x, self.p[f"{name}.weight"], self.p[f"{name}.bias"],
            self.b[f"{name}.running_mean"], self.b[f"{name}.running_var"],
            self.train)
        if self.train:
            for key, v in (("running_mean", mean), ("running_var", var)):
                self.b[f"{name}.{key}"] = (
                    self.momentum * self.b[f"{name}.{key}"]
                    + (1.0 - self.momentum) * v)
        return y

    def conv(self, name: str, x: Tensor, stride: int) -> Tensor:
        return R.conv(x, self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                      stride, self.precision)

    def dense(self, name: str, x: Tensor) -> Tensor:
        return R.dense(x, self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                       self.precision)

    def encode(self, x_nhwc: Tensor) -> Tensor:
        h = x_nhwc.permute(0, 3, 1, 2)
        i = 0
        while f"encoder.enc_conv_{i}.weight" in self.p:
            h = R.leaky_relu(self.norm(f"encoder.enc_norm_{i}",
                                       self.conv(f"encoder.enc_conv_{i}", h,
                                                 2)))
            i += 1
        return h

    def squeeze(self, h: Tensor) -> Tuple[Tensor, Tuple[int, int, int]]:
        s = self.conv("bottleneck.intermediate_conv", h, 1)
        shape = (s.shape[2], s.shape[3], s.shape[1])
        return s.permute(0, 2, 3, 1).reshape(s.shape[0], -1), shape

    def expand(self, flat: Tensor, shape: Tuple[int, int, int]) -> Tensor:
        h = flat.reshape((flat.shape[0],) + shape).permute(0, 3, 1, 2)
        return self.conv("bottleneck.intermediate_conv_reverse", h, 1)

    def decode(self, h: Tensor) -> Tensor:
        h = torch.relu(self.norm("decoder.dec_norm_in", h))
        i = 0
        while f"decoder.dec_convT_{i}.weight" in self.p:
            h = R.conv_transpose(h, self.p[f"decoder.dec_convT_{i}.weight"],
                                 self.p[f"decoder.dec_convT_{i}.bias"], 2,
                                 self.precision)
            h = R.leaky_relu(self.norm(f"decoder.dec_norm_{i}", h))
            i += 1
        return self.conv("decoder.dec_conv_final", h, 1).permute(0, 2, 3, 1)

    def autoencoder(self, x: Tensor, rate: float,
                    dropout: Optional[torch.Generator]) -> Dict[str, Tensor]:
        flat, shape = self.squeeze(self.encode(x))
        z = R.dropout(self.dense("bottleneck.z_layer", flat), rate, dropout)
        h = self.expand(self.dense("bottleneck.dec_dense", z), shape)
        return {"z": z, "x_hat": self.decode(h)}

    def vae(self, x: Tensor, rate: float, dropout: Optional[torch.Generator],
            sample: torch.Generator) -> Dict[str, Tensor]:
        """Draws in order: the mu head's dropout, the log-sigma head's,
        eps from ``sample``, the dense-back dropout."""
        flat, shape = self.squeeze(self.encode(x))
        z_mu = R.dropout(self.dense("bottleneck.mu_layer", flat), rate,
                         dropout)
        z_log_sigma = R.dropout(self.dense("bottleneck.sigma_layer", flat),
                                rate, dropout)
        z_sigma = torch.exp(z_log_sigma)
        eps = torch.randn(tuple(z_sigma.shape), generator=sample,
                          device=z_sigma.device)
        z = z_mu + eps * z_sigma
        dec = R.dropout(self.dense("bottleneck.dec_dense", z), rate, dropout)
        return {"z_mu": z_mu, "z_log_sigma": z_log_sigma, "z_sigma": z_sigma,
                "x_hat": self.decode(self.expand(dec, shape))}


def l1_per_sample(x: Tensor, x_hat: Tensor) -> Tensor:
    return torch.abs(x - x_hat).sum(dim=(1, 2, 3))


def kl_per_sample(z_mu: Tensor, z_sigma: Tensor) -> Tensor:
    s2 = z_sigma ** 2
    return 0.5 * (z_mu ** 2 + s2 - torch.log(s2) - 1.0).sum(dim=1)


def total_variation(images: Tensor) -> Tensor:
    """Per-sample anisotropic TV of NHWC images."""
    dh = torch.abs(images[:, 1:] - images[:, :-1]).sum(dim=(1, 2, 3))
    dw = torch.abs(images[:, :, 1:] - images[:, :, :-1]).sum(dim=(1, 2, 3))
    return dh + dw
