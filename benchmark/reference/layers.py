"""Plain float32 layers of the unified backbone, as functions of explicit
parameters.

  * Convolutions pad as TensorFlow's SAME: ``ceil(n / s)`` outputs, the
    odd pixel of padding after.
  * A SAME transposed convolution of stride s is, by definition, the
    input dilated by s (zeros between pixels), padded as lax's SAME rule
    pads it ((3, 2) for kernel 5, stride 2), and correlated with the
    kernel flipped in space and transposed in its channel axes
    (``conv_transpose_dilated``); ``conv_transpose`` computes the same
    with ``conv_transpose2d``.  Kernels are held as (in, out, k, k).
  * BatchNorm has eps 1e-3; in training it normalises with the batch's
    biased statistics, in evaluation with the running ones.
  * Dropout is inverted: an element is kept where a U[0, 1) draw is at
    least the rate, and scaled by 1 / (1 - rate).

Every draw is made with ``torch.rand``/``torch.randn`` from the generator
the caller passes, in the order the forward needs them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
BN_EPS = 1e-3
LEAKY = 0.3
FP8_MAX = 448.0  # largest float8 e4m3 value


class float32_products:
    """Float32 products in float32 while the reference runs: TF32, which
    the card's convolutions take by default, is off (and put back)."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


def quantize(t: Tensor, precision: str) -> Tensor:
    """``t`` itself in float32; with ``fp8`` rounded to float8 e4m3 after
    scaling its largest magnitude to the format's largest value (the
    rounding is passed through unchanged by the backward).  The control
    rounds every product's operands and its result so: the activations
    that the configuration holds in bfloat16 are held one step lower."""
    if precision == "float32":
        return t
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    d = t.detach()
    scale = FP8_MAX / d.abs().amax().clamp_min(1e-30)
    q = (d * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return t + (q - d)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv(x: Tensor, w: Tensor, b: Tensor, stride: int,
         precision: str = "float32") -> Tensor:
    """SAME convolution; ``w`` is (out, in, k, k)."""
    k = w.shape[-1]
    ph = same_pads(x.shape[-2], k, stride)
    pw = same_pads(x.shape[-1], k, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return quantize(F.conv2d(quantize(x, precision), quantize(w, precision),
                             b, stride), precision)


def convt_pads(kernel: int, stride: int) -> Tuple[int, int]:
    """lax's SAME padding of a transposed convolution's dilated input."""
    total = kernel + stride - 2
    before = kernel - 1 if stride > kernel - 1 else -(-total // 2)
    return before, total - before


def conv_transpose_dilated(x: Tensor, w: Tensor, b: Tensor,
                           stride: int = 2) -> Tensor:
    """SAME transposed convolution by its definition: the input dilated by
    ``stride``, padded by lax's SAME rule, correlated with the kernel
    flipped in space and transposed in its channel axes; ``w`` is (in,
    out, k, k).  Four times the products of ``conv_transpose`` at stride
    2 (most are with zeros), so the harness computes with the other and
    the tests hold the two equal."""
    B, C, H, W = x.shape
    k = w.shape[-1]
    dil = x.new_zeros((B, C, (H - 1) * stride + 1, (W - 1) * stride + 1))
    dil[:, :, ::stride, ::stride] = x
    lo, hi = convt_pads(k, stride)
    dil = F.pad(dil, (lo, hi, lo, hi))
    return F.conv2d(dil, torch.flip(w, dims=(2, 3)).transpose(0, 1), b)


def conv_transpose(x: Tensor, w: Tensor, b: Tensor, stride: int = 2,
                   precision: str = "float32") -> Tensor:
    """SAME transposed convolution, output ``stride`` x the input; ``w``
    is (in, out, k, k).  ``conv_transpose2d`` pads the dilated input by
    k - 1 - padding on both sides: padding k - 1 - before gives lax's pad
    before, and the rows past ``stride`` x the input are cropped, which
    leaves lax's pad after (the pad after is never the larger)."""
    H, W = x.shape[-2:]
    k = w.shape[-1]
    lo, hi = convt_pads(k, stride)
    if hi > lo:
        raise ValueError(f"kernel {k} at stride {stride}: pad after > before")
    y = F.conv_transpose2d(quantize(x, precision), quantize(w, precision), b,
                           stride=stride, padding=k - 1 - lo)
    return quantize(y[..., : stride * H, : stride * W], precision)


def dense(x: Tensor, w: Tensor, b: Tensor, precision: str = "float32"
          ) -> Tensor:
    return quantize(quantize(x, precision) @ quantize(w, precision).t() + b,
                    precision)


def batchnorm(x: Tensor, weight: Tensor, bias: Tensor, mean: Tensor,
              var: Tensor, train: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """(y, batch mean, batch biased variance) in training, (y, mean, var)
    of the running statistics in evaluation."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
    y = ((x - mean[None, :, None, None])
         / torch.sqrt(var[None, :, None, None] + BN_EPS))
    return (y * weight[None, :, None, None] + bias[None, :, None, None],
            mean.detach(), var.detach())


def leaky_relu(x: Tensor, slope: float = LEAKY) -> Tensor:
    return torch.where(x > 0, x, slope * x)


def dropout(x: Tensor, rate: float, generator: Optional[torch.Generator]
            ) -> Tensor:
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(tuple(x.shape), generator=generator,
                      device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def stages(width: int, intermediate: int) -> int:
    return int(round(math.log2(width / intermediate)))
