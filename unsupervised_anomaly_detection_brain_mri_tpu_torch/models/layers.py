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
  * SAME transposed convolutions (stride 2) are ``conv_transpose2d(
    padding=1)`` with the kernel flipped (done by the converter): for k=5
    Flax pads the dilated input by (3, 2), so the last row and column are
    cropped; for k=4 it pads (2, 2) and nothing is cropped;
  * BatchNorm eps is 1e-3; Flax's momentum 0.99 is torch's 0.01;
  * the dense bottleneck flattens NHWC, as Flax does;
  * parameters are float32, compute runs in the config's compute dtype,
    and the decoder's output is cast to float32.

Random draws (dropout masks, the VAEs' ``eps ~ N(0, 1)``) come from an
explicit source: a ``torch.Generator``, a ``VolumeGenerators`` (one
generator per volume of a padded stack), or, for ``eps`` only, the noise
itself as a tensor.  Given noise is the seam through which tests and the
card-vs-CPU checks feed both sides the same numbers; the training and
evaluation paths always pass generators.

The space-to-depth stem, the depth-to-space head and spatial LayerNorm are
not ported yet (``models/registry.py`` rejects configs that ask for them).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_SLOPE = 0.3  # keras LeakyReLU default alpha
LEAKY_SLOPE_ZIMMERER = 0.2  # tf.nn.leaky_relu default alpha
BN_EPS = 1e-3  # tf.layers BatchNormalization default epsilon
BN_MOMENTUM = 0.99  # Flax convention; torch's momentum is 1 - this


def leaky_relu(x: torch.Tensor, slope: float = LEAKY_SLOPE) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def num_scale_stages(width: int, intermediate_resolution: int) -> int:
    """log2(width) - log2(intermediate) stages."""
    return int(math.log2(width) - math.log2(float(intermediate_resolution)))


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TensorFlow/Flax SAME padding (before, after) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class VolumeGenerators:
    """The generators of a stack of ``len(generators)`` volumes, each padded
    to ``slices`` rows of which the first ``counts[k]`` are real.

    A draw for the stacked batch (K * slices, ...) takes volume k's real
    rows from ``generators[k]`` at their own shape (S_k, ...) and leaves the
    padding rows zero, so every generator sees exactly the draws of a call
    on its volume alone."""

    def __init__(self, generators: Sequence[torch.Generator],
                 counts: Sequence[int], slices: int):
        if len(generators) != len(counts) or max(counts) > slices:
            raise ValueError(f"{len(generators)} generators for volumes of "
                             f"{list(counts)} slices padded to {slices}")
        self.generators = list(generators)
        self.counts = [int(n) for n in counts]
        self.slices = int(slices)

    def draw(self, fn: Callable, shape: Sequence[int],
             device: torch.device) -> torch.Tensor:
        shape = tuple(shape)
        if shape[0] != len(self.generators) * self.slices:
            raise ValueError(f"a draw of {shape} for {len(self.generators)} "
                             f"volumes of {self.slices} rows")
        out = torch.zeros(shape, device=device)
        rows = out.view((len(self.generators), self.slices) + shape[1:])
        for k, (g, n) in enumerate(zip(self.generators, self.counts)):
            rows[k, :n] = fn((n,) + shape[1:], generator=g, device=device)
        return out


RandomSource = Union[torch.Generator, VolumeGenerators]
# eps may also be given as a tensor (the noise seam)
Sample = Union[torch.Generator, VolumeGenerators, torch.Tensor]


def draw(fn: Callable, source: RandomSource, shape: Sequence[int],
          device: torch.device) -> torch.Tensor:
    if isinstance(source, VolumeGenerators):
        return source.draw(fn, shape, device)
    if isinstance(source, torch.Generator):
        return fn(tuple(shape), generator=source, device=device)
    raise TypeError(f"expected a torch.Generator or VolumeGenerators, got "
                    f"{type(source).__name__} (given noise drives eps only, "
                    "never dropout)")


def standard_normal(sample: Optional[Sample], shape: Sequence[int],
                    device: torch.device) -> torch.Tensor:
    """float32 N(0, 1) of ``shape``: drawn from ``sample``, or ``sample``
    itself when it is a tensor (given noise)."""
    if isinstance(sample, torch.Tensor):
        if tuple(sample.shape) != tuple(shape):
            raise ValueError(f"given noise has shape {tuple(sample.shape)}, "
                             f"the draw needs {tuple(shape)}")
        return sample.to(device=device, dtype=torch.float32)
    if sample is None:
        raise ValueError("this model draws eps ~ N(0, 1) on every forward, "
                         "in eval mode too: pass a generator or the noise")
    return draw(torch.randn, sample, shape, device)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[RandomSource]) -> torch.Tensor:
    """Inverted dropout drawn from an explicit source; identity when none
    is given (deterministic inference)."""
    if generator is None or rate == 0.0:
        return x
    keep = draw(torch.rand, generator, x.shape, x.device) >= rate
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
    """Flax ``nn.ConvTranspose(kernel 5 or 4, strides 2, padding="SAME")``:
    output exactly 2x the input.  The weight is torch's (in, out, kh, kw)
    and holds the Flax kernel flipped on both spatial axes."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, dtype: torch.dtype = torch.float32):
        if kernel_size not in (4, 5):
            raise ValueError(f"SAME ConvTranspose of kernel {kernel_size}")
        super().__init__(in_channels, out_channels, kernel_size, stride=2,
                         padding=1)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[-2:]
        y = F.conv_transpose2d(
            x.to(self.compute_dtype), self.weight.to(self.compute_dtype),
            self.bias.to(self.compute_dtype), stride=2, padding=1)
        # k=5: padding=1 pads the dilated input by (3, 3), Flax by (3, 2);
        # k=4: both pad (2, 2) and the crop keeps everything
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


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H * W * C) in Flax's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def unflatten_nhwc(x: torch.Tensor, shape: Tuple[int, int, int]
                   ) -> torch.Tensor:
    """(B, H * W * C) in NHWC order -> (B, C, H, W); ``shape`` is (H, W, C)."""
    return x.reshape((x.shape[0],) + tuple(shape)).permute(0, 3, 1, 2)


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
                generator: Optional[RandomSource] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        flat = flatten_nhwc(self.intermediate_conv(x))
        z = dropout(self.z_layer(flat), self.dropout_rate, generator)
        dec = self.dec_dense(z)
        if self.decoder_dropout:
            dec = dropout(dec, self.dropout_rate, generator)
        return (z.to(torch.float32),
                self.intermediate_conv_reverse(unflatten_nhwc(dec,
                                                              self.reshape)))


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
            self.add_module(f"dec_convT_{i}",
                            ConvTranspose2d(c, filters, dtype=dtype))
            self.add_module(f"dec_norm_{i}", Norm(filters))
            c = filters
        self.dec_conv_final = Conv2d(c, output_channels, 1, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.dec_norm_in(x))
        for i in range(self.n):
            x = getattr(self, f"dec_convT_{i}")(x)
            x = leaky_relu(getattr(self, f"dec_norm_{i}")(x))
        return self.dec_conv_final(x).to(torch.float32)
