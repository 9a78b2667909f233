"""ResNet stacks of Chen's constrained AAE and of Schlegl's fAnoGAN.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/models/
resnet.py`, with its module names (``stem``, ``res1``-``res4``, ``conv1``,
``conv2``, ``shortcut``, ``ln1``, ``ln2``, ``ln_out``, ``head``).  NCHW
inside, as the rest of the port's backbones; the activation is ReLU.

  * down block: LN -> ReLU -> Conv3x3 -> LN -> ReLU -> Conv3x3 s2, plus the
    shortcut Conv1x1 -> 2x2 average pool;
  * same block: LN -> ReLU -> Conv3x3 -> LN -> ReLU -> Conv3x3 (a stride-1
    ConvT3x3 with ``transpose_second``), plus the identity;
  * up block: LN -> ReLU -> Conv3x3 -> LN -> ReLU -> ConvT3x3 s2, plus the
    shortcut ConvT1x1 s2.

LN is ``SpatialLayerNorm`` (over H and W, per-channel scale and bias, eps
1e-3).  The ConvTs named ``conv2`` and ``shortcut`` are ``ConvTranspose2d``
modules, which is how ``models/convert.py`` knows to flip their kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    SpatialLayerNorm,
)

Tensor = torch.Tensor


class ResBlockDown(nn.Module):
    """Stride-2 residual downsampling block (encoder, critic)."""

    def __init__(self, in_channels: int, filters: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln1 = SpatialLayerNorm(in_channels)
        self.conv1 = Conv2d(in_channels, filters, 3, 1, dtype)
        self.ln2 = SpatialLayerNorm(filters)
        self.conv2 = Conv2d(filters, filters, 3, 2, dtype)
        self.shortcut = Conv2d(in_channels, filters, 1, 1, dtype)

    def forward(self, x: Tensor) -> Tensor:
        h = self.conv1(F.relu(self.ln1(x)))
        h = self.conv2(F.relu(self.ln2(h)))
        return h + F.avg_pool2d(self.shortcut(x), 2)


class ResBlockSame(nn.Module):
    """Resolution-preserving residual block with the identity shortcut."""

    def __init__(self, filters: int, transpose_second: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln1 = SpatialLayerNorm(filters)
        self.conv1 = Conv2d(filters, filters, 3, 1, dtype)
        self.ln2 = SpatialLayerNorm(filters)
        self.conv2 = (ConvTranspose2d(filters, filters, 3, dtype, stride=1)
                      if transpose_second
                      else Conv2d(filters, filters, 3, 1, dtype))

    def forward(self, x: Tensor) -> Tensor:
        h = self.conv1(F.relu(self.ln1(x)))
        return self.conv2(F.relu(self.ln2(h))) + x


class ResBlockUp(nn.Module):
    """Stride-2 transposed-conv residual upsampling block (decoder,
    generator)."""

    def __init__(self, in_channels: int, filters: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln1 = SpatialLayerNorm(in_channels)
        self.conv1 = Conv2d(in_channels, filters, 3, 1, dtype)
        self.ln2 = SpatialLayerNorm(filters)
        self.conv2 = ConvTranspose2d(filters, filters, 3, dtype, stride=2)
        self.shortcut = ConvTranspose2d(in_channels, filters, 1, dtype,
                                        stride=2)

    def forward(self, x: Tensor) -> Tensor:
        h = self.conv1(F.relu(self.ln1(x)))
        return self.conv2(F.relu(self.ln2(h))) + self.shortcut(x)


class ResNetEncoder(nn.Module):
    """Chen's encoder and Schlegl's critic trunk: a 3x3 stem (``dim``),
    down blocks to 2, 4 and 8 ``dim``, and a same block; (B, C, H, W) ->
    (B, 8 dim, H / 8, W / 8)."""

    def __init__(self, dim: int = 64, in_channels: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem = Conv2d(in_channels, dim, 3, 1, dtype)
        self.res1 = ResBlockDown(dim, 2 * dim, dtype)
        self.res2 = ResBlockDown(2 * dim, 4 * dim, dtype)
        self.res3 = ResBlockDown(4 * dim, 8 * dim, dtype)
        self.res4 = ResBlockSame(8 * dim, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        return self.res4(self.res3(self.res2(self.res1(self.stem(x)))))


class ResNetDecoder(nn.Module):
    """Chen's decoder and Schlegl's generator: a same block whose second
    conv is a ConvT, up blocks to 4, 2 and 1 ``dim``, LN -> ReLU and a 1x1
    head; (B, 8 dim, h, w) -> (B, out_channels, 8 h, 8 w) float32, through
    tanh with ``final_tanh``."""

    def __init__(self, dim: int = 64, out_channels: int = 1,
                 final_tanh: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.final_tanh = final_tanh
        self.res1 = ResBlockSame(8 * dim, transpose_second=True, dtype=dtype)
        self.res2 = ResBlockUp(8 * dim, 4 * dim, dtype)
        self.res3 = ResBlockUp(4 * dim, 2 * dim, dtype)
        self.res4 = ResBlockUp(2 * dim, dim, dtype)
        self.ln_out = SpatialLayerNorm(dim)
        self.head = Conv2d(dim, out_channels, 1, 1, dtype)

    def forward(self, x: Tensor) -> Tensor:
        # a dense layer's NHWC unflatten leaves channels-last strides, on
        # which torch 2.9's CPU (oneDNN) backward of this stack crashes
        h = self.res4(self.res3(self.res2(self.res1(x.contiguous()))))
        h = self.head(F.relu(self.ln_out(h))).to(torch.float32)
        return torch.tanh(h) if self.final_tanh else h
