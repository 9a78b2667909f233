"""Shared backbone layers of the port: the parity paths of the unified
encoder, dense bottleneck and unified decoder.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/models/
layers.py`.  Layouts inside the modules are NCHW; the models take and give
NHWC like the JAX package.  Module and parameter names follow the Flax tree
(``enc_conv_0``, ``dec_convT_1``, ``z_layer``, ...), so ``models/convert.py``
maps a Flax checkpoint one entry at a time.

Numerics that must match Flax:
  * SAME convolutions pad like TensorFlow: for k=5, s=2 on an even size
    that is (1, 2), which ``padding="same"`` cannot express under stride 2;
  * SAME transposed convolutions pad the dilated input by (3, 2) for k=5,
    s=2; here that is ``conv_transpose2d(padding=1)`` followed by cropping
    the last row and column, with the kernel flipped (done by the converter);
  * BatchNorm eps is 1e-3; Flax's momentum 0.99 is torch's 0.01;
  * the dense bottleneck flattens NHWC, as Flax does;
  * parameters are float32, compute runs in the config's compute dtype,
    and the decoder's output is cast to float32.

The space-to-depth stem, the depth-to-space head and spatial LayerNorm are
not ported yet (``models/registry.py`` rejects configs that ask for them).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_SLOPE = 0.3  # keras LeakyReLU default alpha
BN_EPS = 1e-3  # tf.layers BatchNormalization default epsilon
BN_MOMENTUM = 0.99  # Flax convention; torch's momentum is 1 - this


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


def num_scale_stages(width: int, intermediate_resolution: int) -> int:
    """log2(width) - log2(intermediate) stages."""
    return int(math.log2(width) - math.log2(float(intermediate_resolution)))


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TensorFlow/Flax SAME padding (before, after) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawn from an explicit generator; identity when no
    generator is given (deterministic inference)."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Conv2d(nn.Conv2d):
    """Flax ``nn.Conv(padding="SAME")``: TF SAME padding, float32 params,
    compute in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=0)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        ph = _same_pads(x.shape[-2], k, s)
        pw = _same_pads(x.shape[-1], k, s)
        x = x.to(self.compute_dtype)
        if any(ph + pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight.to(self.compute_dtype),
                        self.bias.to(self.compute_dtype), s)


class ConvTranspose2d(nn.ConvTranspose2d):
    """Flax ``nn.ConvTranspose(kernel 5, strides 2, padding="SAME")``:
    output exactly 2x the input.  The weight is torch's (in, out, kh, kw)
    and holds the Flax kernel flipped on both spatial axes."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, 5, stride=2, padding=1)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[-2:]
        y = F.conv_transpose2d(
            x.to(self.compute_dtype), self.weight.to(self.compute_dtype),
            self.bias.to(self.compute_dtype), stride=2, padding=1)
        # padding=1 pads the dilated input by (3, 3); Flax pads (3, 2)
        return y[..., : 2 * H, : 2 * W]


class Linear(nn.Linear):
    """Flax ``nn.Dense``: float32 params, compute in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.compute_dtype),
                        self.weight.to(self.compute_dtype),
                        self.bias.to(self.compute_dtype))


class Norm(nn.BatchNorm2d):
    """BatchNorm (eps 1e-3, Flax momentum 0.99).  Normalises in float32 and
    returns the input's dtype, like Flax's BatchNorm with a compute dtype.

    In train mode it normalises with the biased batch statistics and moves
    ``running_mean``/``running_var`` towards the *biased* batch mean and
    variance, as Flax does; ``nn.BatchNorm2d`` would move ``running_var``
    towards the unbiased n/(n-1) variance and drift from the JAX package."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if not self.training:
            return super().forward(xf).to(x.dtype)
        y = F.batch_norm(xf, None, None, self.weight, self.bias,
                         training=True, eps=self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(BN_MOMENTUM).add_(mean,
                                                     alpha=1.0 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var,
                                                    alpha=1.0 - BN_MOMENTUM)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


class UnifiedEncoder(nn.Module):
    """Strided-conv pyramid down to ``intermediate_resolution``: per stage
    Conv(k5, s2, SAME, min(128, 32 * 2^i) filters) -> Norm -> LeakyReLU."""

    def __init__(self, image_width: int, in_channels: int = 1,
                 intermediate_resolution: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = num_scale_stages(image_width, intermediate_resolution)
        c = in_channels
        for i in range(self.n):
            filters = int(min(128, 32 * (2 ** i)))
            self.add_module(f"enc_conv_{i}", Conv2d(c, filters, 5, 2, dtype))
            self.add_module(f"enc_norm_{i}", Norm(filters))
            c = filters
        self.out_channels = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"enc_conv_{i}")(x)
            x = leaky_relu(getattr(self, f"enc_norm_{i}")(x))
        return x


class DenseBottleneck(nn.Module):
    """1x1-conv channel squeeze (C -> C/8) -> NHWC flatten -> Dense(zDim)
    with dropout -> Dense back -> 1x1 expand to C.  Returns (z, features).

    ``decoder_dropout=False`` reproduces the AE quirk: the reference's
    decoder-dense dropout call lacks the training flag and never fires."""

    def __init__(self, channels: int, spatial: int, z_dim: int,
                 dropout_rate: float = 0.2, decoder_dropout: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        squeezed = channels // 8
        self.reshape = (spatial, spatial, squeezed)  # NHWC, as Flax
        flat = math.prod(self.reshape)
        self.dropout_rate = dropout_rate
        self.decoder_dropout = decoder_dropout
        self.intermediate_conv = Conv2d(channels, squeezed, 1, 1, dtype)
        self.z_layer = Linear(flat, z_dim, dtype)
        self.dec_dense = Linear(z_dim, flat, dtype)
        self.intermediate_conv_reverse = Conv2d(squeezed, channels, 1, 1,
                                                dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        squeezed = self.intermediate_conv(x)
        flat = squeezed.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        z = dropout(self.z_layer(flat), self.dropout_rate, generator)
        dec = self.dec_dense(z)
        if self.decoder_dropout:
            dec = dropout(dec, self.dropout_rate, generator)
        dec = dec.reshape((x.shape[0],) + self.reshape).permute(0, 3, 1, 2)
        return z.to(torch.float32), self.intermediate_conv_reverse(dec)


class UnifiedDecoder(nn.Module):
    """Mirrored pyramid up to ``output_width``: Norm -> ReLU ->
    [ConvT(k5, s2, max(32, 128 / 2^i)) -> Norm -> LeakyReLU] x n ->
    1x1 conv -> float32."""

    def __init__(self, in_channels: int, output_width: int,
                 output_channels: int = 1, intermediate_resolution: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = num_scale_stages(output_width, intermediate_resolution)
        self.dec_norm_in = Norm(in_channels)
        c = in_channels
        for i in range(self.n):
            filters = int(max(32, 128 // (2 ** i)))
            self.add_module(f"dec_convT_{i}", ConvTranspose2d(c, filters,
                                                              dtype))
            self.add_module(f"dec_norm_{i}", Norm(filters))
            c = filters
        self.dec_conv_final = Conv2d(c, output_channels, 1, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.dec_norm_in(x))
        for i in range(self.n):
            x = getattr(self, f"dec_convT_{i}")(x)
            x = leaky_relu(getattr(self, f"dec_norm_{i}")(x))
        return self.dec_conv_final(x).to(torch.float32)
