"""Gulrajani et al.'s residual networks (Improved Training of Wasserstein
GANs, arXiv:1704.00028) as Schlegl et al.'s f-AnoGAN (Medical Image
Analysis 54, 2019) builds them in Baur et al.'s code
(``mains/main_fAnoGAN_schlegl.py``), in plain float32 over explicit
parameters.  Tensors are NCHW inside.

  * Down block: LN -> ReLU -> Conv3x3 -> LN -> ReLU -> Conv3x3 stride 2,
    plus the shortcut Conv1x1 -> 2x2 mean pool.
  * Same block: LN -> ReLU -> Conv3x3 -> LN -> ReLU -> Conv3x3 (a stride-1
    transposed Conv3x3 where ``transpose`` is set), plus the identity.
  * Up block: LN -> ReLU -> Conv3x3 -> LN -> ReLU -> transposed Conv3x3
    stride 2, plus the shortcut transposed Conv1x1 stride 2.
  * Critic trunk (``encoder``): a 3x3 stem to ``dim``, down blocks to 2,
    4 and 8 ``dim``, a same block.  Generator (``decoder``): a same block
    with a transposed second conv, up blocks to 4, 2 and 1 ``dim``, LN ->
    ReLU and a 1x1 head.
  * LN normalises each (sample, channel) over (H, W) with a per-channel
    scale and bias, eps 1e-3, the variance as max(0, E[x^2] - E[x]^2)
    (Flax's ``LayerNorm``, which the networks were first written in).
  * Convolutions pad as TensorFlow's SAME; a SAME transposed convolution
    pads its dilated input as lax's rule: (1, 1) for k3 s1, (2, 1) for
    k3 s2, (0, 1) for k1 s2.  Transposed kernels are (in, out, k, k).

Departures from Gulrajani's networks, all Baur et al.'s: the down block's
second conv is strided where Gulrajani's convolves and then mean-pools; the
up blocks are transposed convolutions where Gulrajani's upsample by depth
to space and convolve; the normalisation is this LN in both networks where
Gulrajani's generator takes BatchNorm and his critic a LayerNorm over (C,
H, W).  The shortcut's 1x1 conv before the pool equals Gulrajani's pool
before the conv.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import layers as R

Tensor = torch.Tensor
Leaf = Tuple[str, Tuple[int, ...], str]
LN_EPS = 1e-3


def layer_norm(x: Tensor, weight: Tensor, bias: Tensor) -> Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = torch.clamp((x * x).mean(dim=(2, 3), keepdim=True) - mean * mean,
                      min=0.0)
    return ((x - mean) / torch.sqrt(var + LN_EPS) * weight[:, None, None]
            + bias[:, None, None])


def conv_transpose(x: Tensor, w: Tensor, b: Tensor, stride: int,
                   precision: str = "float32") -> Tensor:
    """SAME transposed convolution, output ``stride`` x the input:
    ``conv_transpose2d`` pads the dilated input by k - 1 - padding on both
    sides, so padding k - 1 - before gives lax's pad before; the rows past
    ``stride`` x the input are cropped, and ``output_padding`` adds the
    rows where lax's pad after is the larger (k1 s2)."""
    H, W = x.shape[-2:]
    k = w.shape[-1]
    lo, hi = R.convt_pads(k, stride)
    y = F.conv_transpose2d(R.quantize(x, precision), R.quantize(w, precision),
                           b, stride=stride, padding=k - 1 - lo,
                           output_padding=max(hi - lo, 0))
    return R.quantize(y[..., : stride * H, : stride * W], precision)


def _conv(p: Dict[str, Tensor], name: str, x: Tensor, stride: int,
          precision: str) -> Tensor:
    return R.conv(x, p[f"{name}.weight"], p[f"{name}.bias"], stride,
                  precision)


def _convt(p: Dict[str, Tensor], name: str, x: Tensor, stride: int,
           precision: str) -> Tensor:
    return conv_transpose(x, p[f"{name}.weight"], p[f"{name}.bias"], stride,
                          precision)


def _ln_relu(p: Dict[str, Tensor], name: str, x: Tensor) -> Tensor:
    return torch.relu(layer_norm(x, p[f"{name}.weight"], p[f"{name}.bias"]))


def down(p: Dict[str, Tensor], name: str, x: Tensor, precision: str
         ) -> Tensor:
    h = _conv(p, f"{name}.conv1", _ln_relu(p, f"{name}.ln1", x), 1,
              precision)
    h = _conv(p, f"{name}.conv2", _ln_relu(p, f"{name}.ln2", h), 2,
              precision)
    return h + F.avg_pool2d(_conv(p, f"{name}.shortcut", x, 1, precision), 2)


def same(p: Dict[str, Tensor], name: str, x: Tensor, transpose: bool,
         precision: str) -> Tensor:
    h = _conv(p, f"{name}.conv1", _ln_relu(p, f"{name}.ln1", x), 1,
              precision)
    h = _ln_relu(p, f"{name}.ln2", h)
    second = _convt if transpose else _conv
    return second(p, f"{name}.conv2", h, 1, precision) + x


def up(p: Dict[str, Tensor], name: str, x: Tensor, precision: str
       ) -> Tensor:
    h = _conv(p, f"{name}.conv1", _ln_relu(p, f"{name}.ln1", x), 1,
              precision)
    return (_convt(p, f"{name}.conv2", _ln_relu(p, f"{name}.ln2", h), 2,
                   precision)
            + _convt(p, f"{name}.shortcut", x, 2, precision))


def encoder(p: Dict[str, Tensor], name: str, x: Tensor, precision: str
            ) -> Tensor:
    """(B, C, H, W) -> (B, 8 dim, H / 8, W / 8)."""
    h = _conv(p, f"{name}.stem", x, 1, precision)
    for i in (1, 2, 3):
        h = down(p, f"{name}.res{i}", h, precision)
    return same(p, f"{name}.res4", h, False, precision)


def decoder(p: Dict[str, Tensor], name: str, x: Tensor, precision: str
            ) -> Tensor:
    """(B, 8 dim, h, w) -> (B, out, 8 h, 8 w), before any output
    nonlinearity."""
    h = same(p, f"{name}.res1", x, True, precision)
    for i in (2, 3, 4):
        h = up(p, f"{name}.res{i}", h, precision)
    return _conv(p, f"{name}.head", _ln_relu(p, f"{name}.ln_out", h), 1,
                 precision)


def _conv_leaves(name: str, cin: int, cout: int, k: int,
                 transpose: bool = False) -> List[Leaf]:
    shape = (cin, cout, k, k) if transpose else (cout, cin, k, k)
    return [(f"{name}.weight", shape, "glorot"),
            (f"{name}.bias", (cout,), "zeros")]


def _ln_leaves(name: str, c: int) -> List[Leaf]:
    return [(f"{name}.weight", (c,), "ones"), (f"{name}.bias", (c,), "zeros")]


def _block_leaves(name: str, cin: int, cout: int, kind: str) -> List[Leaf]:
    """``kind``: ``down``, ``same``, ``same_t`` (transposed second conv) or
    ``up``."""
    out = (_ln_leaves(f"{name}.ln1", cin)
           + _conv_leaves(f"{name}.conv1", cin, cout, 3)
           + _ln_leaves(f"{name}.ln2", cout)
           + _conv_leaves(f"{name}.conv2", cout, cout, 3,
                          transpose=kind in ("same_t", "up")))
    if kind == "down":
        out += _conv_leaves(f"{name}.shortcut", cin, cout, 1)
    elif kind == "up":
        out += _conv_leaves(f"{name}.shortcut", cin, cout, 1, transpose=True)
    return out


def encoder_leaves(name: str, dim: int, channels: int) -> List[Leaf]:
    out = _conv_leaves(f"{name}.stem", channels, dim, 3)
    c = dim
    for i in (1, 2, 3):
        out += _block_leaves(f"{name}.res{i}", c, 2 * c, "down")
        c *= 2
    return out + _block_leaves(f"{name}.res4", c, c, "same")


def decoder_leaves(name: str, dim: int, channels: int) -> List[Leaf]:
    c = 8 * dim
    out = _block_leaves(f"{name}.res1", c, c, "same_t")
    for i in (2, 3, 4):
        out += _block_leaves(f"{name}.res{i}", c, c // 2, "up")
        c //= 2
    return (out + _ln_leaves(f"{name}.ln_out", c)
            + _conv_leaves(f"{name}.head", c, channels, 1))
