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
  * SAME transposed convolutions are ``conv_transpose2d`` with the kernel
    flipped (done by the converter) and the dilated input padded as lax's
    SAME rule pads it (``convt_same_pads``): (3, 2) for k5 s2, (2, 2) for
    k4 s2, (2, 1) for k3 s2, (0, 1) for k1 s2 and (1, 1) for k3 s1;
  * BatchNorm eps is 1e-3; Flax's momentum 0.99 is torch's 0.01;
  * the dense bottleneck flattens NHWC, as Flax does;
  * parameters are float32, compute runs in the config's compute dtype,
    and the decoder's output is cast to float32.

Also here: the nearest x2 upsample of ``GMVAEYou``, the latent critic
``MLPDiscriminator`` of the adversarial autoencoders (LeakyReLU 0.2, not the
backbone's 0.3), and ``SpatialLayerNorm``, the LayerNorm over (H, W) of the
ResNets and of the image critics' and generators' unified backbones
(``use_batchnorm=False``).

Random draws (dropout masks, the VAEs' ``eps ~ N(0, 1)``, the GMVAEs' three
normals, the critic interpolate's ``eps ~ U[0, 1)``) come from an explicit
source: a ``torch.Generator``, a ``VolumeGenerators`` (one generator per
volume of a padded stack), or, for the noise only, the noise itself: a
tensor, or for a model that makes several named draws (the GMVAEs' ``w``,
``z`` and ``z_wc``) a dict of tensors by draw name.  Given noise is the
seam through which tests and the card-vs-CPU checks feed both sides the
same numbers; the training and evaluation paths always pass generators.

The non-parity options of the JAX package's backbone are here too:
``UnifiedEncoder(space_to_depth_stem=True)`` replaces stage 0 by
``space_to_depth`` (2x2) and a 3x3 stride-1 SAME conv (``enc_conv_0_s2d``),
and ``UnifiedDecoder(depth_to_space_head=True)`` replaces the last ConvT
stage and the 1x1 head by a 3x3 stride-1 SAME conv to ``4 * C_out``
channels at half resolution (``dec_conv_d2s_head``) and ``depth_to_space``
(2x2).  Both pack a 2x2 block in the JAX package's (dy, dx, c) order,
channel ``(dy * 2 + dx) * C + c``; ``F.pixel_unshuffle`` and
``F.pixel_shuffle`` use (c, dy, dx), which agrees only at C = 1.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.collectives import (
    all_gather_batch,
    copy_to_model,
    gather_from_model,
    psum,
)

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


class ShardedSource:
    """One data-parallel rank's share of a random source: the rows
    ``[start, stop)`` of a global batch whose first ``rows`` rows are real
    (the rest pads it to a multiple of the ranks).

    Every draw site states its batch as the draw's leading axis, so a
    non-scalar draw must lead with the shard's rows: it is made for the
    whole real batch from ``source`` and cut to the shard's rows (padding
    rows are zero), so every rank advances ``source`` as one process on
    the whole batch would and its rows get that process's numbers.  A
    scalar draw is made as asked, the same on every rank; any other shape
    raises, since it would diverge from the one-process draw."""

    def __init__(self, source: "RandomSource", rows: int, start: int,
                 stop: int):
        self.source = source
        self.rows, self.start, self.stop = int(rows), int(start), int(stop)

    def draw(self, fn: Callable, shape: Sequence[int],
             device: torch.device) -> torch.Tensor:
        shape = tuple(shape)
        if not shape:
            return draw(fn, self.source, shape, device)
        if shape[0] != self.stop - self.start:
            raise ValueError(f"a draw of shape {shape} on a rank's "
                             f"{self.stop - self.start} rows: a sharded "
                             "draw is a scalar or leads with the rank's "
                             "rows")
        full = draw(fn, self.source, (self.rows,) + shape[1:], device)
        if self.stop > self.rows:
            full = torch.cat([full, full.new_zeros(
                (self.stop - self.rows,) + shape[1:])])
        return full[self.start:self.stop]


RandomSource = Union[torch.Generator, VolumeGenerators, ShardedSource]
# the noise may also be given: a tensor, or tensors by draw name (the seam)
Sample = Union[torch.Generator, VolumeGenerators, ShardedSource,
               torch.Tensor, Mapping[str, torch.Tensor]]


def draw(fn: Callable, source: RandomSource, shape: Sequence[int],
          device: torch.device) -> torch.Tensor:
    if isinstance(source, (VolumeGenerators, ShardedSource)):
        return source.draw(fn, shape, device)
    if isinstance(source, torch.Generator):
        return fn(tuple(shape), generator=source, device=device)
    raise TypeError(f"expected a torch.Generator, VolumeGenerators or "
                    f"ShardedSource, got "
                    f"{type(source).__name__} (given noise drives eps only, "
                    "never dropout)")


def _given(noise: Union[torch.Tensor, Mapping[str, torch.Tensor]],
           shape: Sequence[int], device: torch.device,
           name: Optional[str]) -> torch.Tensor:
    """Given noise for the draw ``name`` of ``shape``: the tensor itself,
    or the dict's entry ``name``."""
    if isinstance(noise, Mapping):
        if name not in noise:
            raise ValueError(f"given noise has draws {sorted(noise)}, the "
                             f"model draws {name!r}")
        noise = noise[name]
    if tuple(noise.shape) != tuple(shape):
        raise ValueError(f"given noise has shape {tuple(noise.shape)}, "
                         f"the draw needs {tuple(shape)}")
    return noise.to(device=device, dtype=torch.float32)


def standard_normal(sample: Optional[Sample], shape: Sequence[int],
                    device: torch.device, name: Optional[str] = None
                    ) -> torch.Tensor:
    """float32 N(0, 1) of ``shape``: drawn from ``sample``, or given noise
    (a tensor, or the entry ``name`` of a dict of tensors)."""
    if isinstance(sample, (torch.Tensor, Mapping)):
        return _given(sample, shape, device, name)
    if sample is None:
        raise ValueError("this model draws eps ~ N(0, 1) on every forward, "
                         "in eval mode too: pass a generator or the noise")
    return draw(torch.randn, sample, shape, device)


def uniform(source: Optional[Sample], shape: Sequence[int],
            device: torch.device) -> torch.Tensor:
    """float32 U[0, 1) of ``shape``: drawn from ``source``, or given as a
    tensor."""
    if isinstance(source, torch.Tensor):
        return _given(source, shape, device, None)
    if source is None:
        raise ValueError("this forward draws eps ~ U[0, 1) for the critic's "
                         "interpolate: pass a generator or the noise")
    return draw(torch.rand, source, shape, device)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[RandomSource]) -> torch.Tensor:
    """Inverted dropout drawn from an explicit source; identity when none
    is given (deterministic inference)."""
    if generator is None or rate == 0.0:
        return x
    keep = draw(torch.rand, generator, x.shape, x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class _ColumnParallel:
    """The tensor-parallel form of a layer (``parallel/sharding.py::
    shard_model`` sets ``tp``, the mesh, and cuts ``weight`` to this
    rank's rows of the out axis ``tp_dim``): the layer computes its shard
    of the output channels without the bias, the model group's shards are
    gathered into the whole output, and the replicated bias is added."""

    tp = None  # the MeshContext of a sharded layer
    tp_dim = 0  # the weight's out axis

    def _parallel(self, op: Callable, x: torch.Tensor, out_dim: int
                  ) -> torch.Tensor:
        y = op(copy_to_model(self.tp, x))
        y = gather_from_model(self.tp, y, out_dim)
        bias = self.bias.to(self.compute_dtype)
        return y + (bias if out_dim == -1 else bias[:, None, None])


class Conv2d(_ColumnParallel, nn.Conv2d):
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
        w = self.weight.to(self.compute_dtype)
        if self.tp is not None:
            return self._parallel(lambda t: F.conv2d(t, w, None, s), x, 1)
        return F.conv2d(x, w, self.bias.to(self.compute_dtype), s)


# (stride, kernel) of the zoo's transposed convolutions, each pinned against
# Flax by a test
CONVT_SHAPES = ((2, 5), (2, 4), (2, 3), (2, 1), (1, 3))


def convt_same_pads(kernel: int, stride: int) -> Tuple[int, int]:
    """lax's SAME padding (before, after) of the dilated input of a
    transposed convolution (``lax._conv_transpose_padding``)."""
    total = kernel + stride - 2
    before = kernel - 1 if stride > kernel - 1 else -(-total // 2)
    return before, total - before


class ConvTranspose2d(_ColumnParallel, nn.ConvTranspose2d):
    """Flax ``nn.ConvTranspose(padding="SAME")``: output ``stride`` x the
    input.  The weight is torch's (in, out, kh, kw) and holds the Flax
    kernel flipped on both spatial axes.

    torch's ``padding`` p pads the dilated input by k - 1 - p on both
    sides and ``output_padding`` adds rows after; so p is set from lax's
    pad before, and lax's pad after is reached by ``output_padding`` (k1
    s2) or by cropping the last rows and columns (k5 s2, k3 s2)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, dtype: torch.dtype = torch.float32,
                 stride: int = 2):
        if (stride, kernel_size) not in CONVT_SHAPES:
            raise ValueError(f"SAME ConvTranspose of kernel {kernel_size} "
                             f"at stride {stride}")
        before, after = convt_same_pads(kernel_size, stride)
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=kernel_size - 1 - before)
        self.extra = max(after - before, 0)
        self.compute_dtype = dtype

    tp_dim = 1  # the weight is (in, out, kh, kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[-2:]
        s = self.stride[0]
        w = self.weight.to(self.compute_dtype)

        def convt(t: torch.Tensor, bias: Optional[torch.Tensor]
                  ) -> torch.Tensor:
            y = F.conv_transpose2d(t, w, bias, stride=s,
                                   padding=self.padding,
                                   output_padding=self.extra)
            return y[..., : s * H, : s * W]

        x = x.to(self.compute_dtype)
        if self.tp is not None:
            return self._parallel(lambda t: convt(t, None), x, 1)
        return convt(x, self.bias.to(self.compute_dtype))


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W), output row and column i read input
    i // 2: ``jax.image.resize(method="nearest")`` at an exact factor 2."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class Linear(_ColumnParallel, nn.Linear):
    """Flax ``nn.Dense``: float32 params, compute in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        w = self.weight.to(self.compute_dtype)
        if self.tp is not None:
            return self._parallel(lambda t: F.linear(t, w), x, -1)
        return F.linear(x, w, self.bias.to(self.compute_dtype))


class Norm(nn.BatchNorm2d):
    """BatchNorm (eps 1e-3, Flax momentum 0.99).  Normalises in float32 and
    returns the input's dtype, like Flax's BatchNorm with a compute dtype.

    In train mode it normalises with the biased batch statistics and moves
    ``running_mean``/``running_var`` towards the *biased* batch mean and
    variance, as Flax does; ``nn.BatchNorm2d`` would move ``running_var``
    towards the unbiased n/(n-1) variance and drift from the JAX package.

    ``mesh`` (set by a trainer under a data-parallel mesh of more than one
    rank) makes the train-mode statistics global over the data group, as
    the JAX package's BatchNorm is under SPMD (``_GlobalBatchNorm``); it
    is not ``nn.SyncBatchNorm``, whose running variance is the unbiased
    one."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)
        self.mesh = None

    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(mean,
                                                     alpha=1.0 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var,
                                                    alpha=1.0 - BN_MOMENTUM)
            self.num_batches_tracked.add_(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if not self.training:
            return super().forward(xf).to(x.dtype)
        if self.mesh is not None and self.mesh.parallel:
            y, mean, var = _GlobalBatchNorm.apply(xf, self.weight, self.bias,
                                                  self.mesh, self.eps)
            self._track(mean, var)
            return y.to(x.dtype)
        y = F.batch_norm(xf, None, None, self.weight, self.bias,
                         training=True, eps=self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
        self._track(mean, var)
        return y.to(x.dtype)


def _channel(t: torch.Tensor) -> torch.Tensor:
    return t[None, :, None, None]


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of one rank's rows with the statistics of the
    whole data group's batch.

    Forward: each rank's per-channel count, mean and centred sum of squares
    are gathered in one collective and combined (Chan's pairwise rule), so
    the variance does not cancel as E[x^2] - E[x]^2 would.  Backward: the
    two per-channel sums of the input gradient, sum(dy) and sum(dy * x_hat),
    are summed over the group in one all-reduce, as in ``SyncBatchNorm``;
    the rank's weight and bias gradients stay its own, and the trainer's
    gradient mean over the group completes them.  Returns (y, mean, biased
    variance)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mesh, eps):
        count = x.numel() // x.shape[1]
        var_l, mean_l = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        parts = all_gather_batch(mesh, torch.stack(
            [torch.full_like(mean_l, count), mean_l, var_l * count])[None])
        counts, means, m2s = parts[:, 0], parts[:, 1], parts[:, 2]
        n = counts.sum(0)
        mean = (counts * means).sum(0) / n
        var = (m2s.sum(0) + (counts * torch.square(means - mean)).sum(0)) / n
        invstd = torch.rsqrt(var + eps)
        x_hat = (x - _channel(mean)) * _channel(invstd)
        ctx.save_for_backward(x_hat, weight, invstd, n)
        ctx.mesh = mesh
        ctx.mark_non_differentiable(mean, var)
        return x_hat * _channel(weight) + _channel(bias), mean, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, _dmean, _dvar):
        x_hat, weight, invstd, n = ctx.saved_tensors
        sum_dy = dy.sum((0, 2, 3))
        sum_dy_xhat = (dy * x_hat).sum((0, 2, 3))
        grad_x = None
        if ctx.needs_input_grad[0]:
            sums = psum(ctx.mesh, torch.stack([sum_dy, sum_dy_xhat])) / n
            grad_x = _channel(weight * invstd) * (
                dy - _channel(sums[0]) - x_hat * _channel(sums[1]))
        return grad_x, sum_dy_xhat, sum_dy, None, None


class SpatialLayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(reduction_axes=(-3, -2), feature_axes=-1,
    epsilon=1e-3)`` on NCHW: normalises each (sample, channel) over (H, W),
    with per-channel ``weight`` and ``bias`` (Flax's ``scale`` and
    ``bias``), statistics in float32, and returns the input's dtype.

    The variance is Flax's default ``use_fast_variance=True`` formula,
    var = max(0, E[x^2] - E[x]^2), written out in torch ops (it is not
    ``nn.LayerNorm``, which normalises over C, H and W, and not
    ``F.group_norm``, whose CPU kernel sums in another order).  On inputs
    whose mean is large against their spread the formula cancels: at
    x = 50 + N(0, 1) over 8 x 8 Flax's own float32 output lies more than
    1e-5 from the exact one, and a different summation order of the same
    formula (XLA on the CPU adds the H x W values in sequence; torch does
    not) lands elsewhere inside that error; where every sum is exact the
    port equals Flax within 1e-5 (``tests/test_torch_resnet.py``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = xf.mean((2, 3), keepdim=True)
        mean2 = torch.square(xf).mean((2, 3), keepdim=True)
        var = torch.clamp(mean2 - torch.square(mean), min=0.0)
        mul = torch.rsqrt(var + BN_EPS) * self.weight[:, None, None]
        return ((xf - mean) * mul + self.bias[:, None, None]).to(x.dtype)


def make_norm(channels: int, use_batchnorm: bool = True) -> nn.Module:
    """The JAX package's ``Norm``: BatchNorm, or with ``use_batchnorm=False``
    the spatial LayerNorm (the Flax ``LayerNorm_0`` level is dropped)."""
    return Norm(channels) if use_batchnorm else SpatialLayerNorm(channels)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(B, C, H, W) -> (B, C * b * b, H / b, W / b): each b x b block packed
    into channels in the JAX package's (dy, dx, c) order, channel
    ``(dy * b + dx) * C + c``."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // block, block, W // block, block)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(B, C * block * block,
                                               H // block, W // block)


def depth_to_space(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(B, C * b * b, H, W) -> (B, C, H * b, W * b): the inverse of
    ``space_to_depth``."""
    B, C, H, W = x.shape
    c = C // (block * block)
    x = x.reshape(B, block, block, c, H, W)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(B, c, H * block, W * block)


class UnifiedEncoder(nn.Module):
    """Strided-conv pyramid down to ``intermediate_resolution``: per stage
    Conv(k5, s2, SAME, min(128, 32 * 2^i) filters) -> Norm -> LeakyReLU.
    ``space_to_depth_stem`` (non-parity) makes stage 0 ``space_to_depth``
    (2x2) -> Conv(k3, s1, SAME) named ``enc_conv_0_s2d``; same shapes
    after it."""

    def __init__(self, image_width: int, in_channels: int = 1,
                 intermediate_resolution: int = 8,
                 dtype: torch.dtype = torch.float32,
                 use_batchnorm: bool = True,
                 space_to_depth_stem: bool = False):
        super().__init__()
        self.n = num_scale_stages(image_width, intermediate_resolution)
        self.s2d_stem = space_to_depth_stem and self.n > 0
        c = in_channels
        for i in range(self.n):
            filters = int(min(128, 32 * (2 ** i)))
            if i == 0 and self.s2d_stem:
                self.enc_conv_0_s2d = Conv2d(4 * c, filters, 3, 1, dtype)
            else:
                self.add_module(f"enc_conv_{i}",
                                Conv2d(c, filters, 5, 2, dtype))
            self.add_module(f"enc_norm_{i}", make_norm(filters,
                                                       use_batchnorm))
            c = filters
        self.out_channels = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            if i == 0 and self.s2d_stem:
                x = self.enc_conv_0_s2d(space_to_depth(x, 2))
            else:
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
    1x1 conv -> float32.  ``depth_to_space_head`` (non-parity) runs n - 1
    ConvT stages, then Conv(k3, s1, SAME, 4 * C_out) named
    ``dec_conv_d2s_head`` at half resolution and ``depth_to_space`` (2x2)."""

    def __init__(self, in_channels: int, output_width: int,
                 output_channels: int = 1, intermediate_resolution: int = 8,
                 dtype: torch.dtype = torch.float32,
                 use_batchnorm: bool = True,
                 depth_to_space_head: bool = False):
        super().__init__()
        n = num_scale_stages(output_width, intermediate_resolution)
        self.d2s_head = depth_to_space_head and n > 0
        self.n = n - 1 if self.d2s_head else n
        self.dec_norm_in = make_norm(in_channels, use_batchnorm)
        c = in_channels
        for i in range(self.n):
            filters = int(max(32, 128 // (2 ** i)))
            self.add_module(f"dec_convT_{i}",
                            ConvTranspose2d(c, filters, dtype=dtype))
            self.add_module(f"dec_norm_{i}", make_norm(filters,
                                                       use_batchnorm))
            c = filters
        if self.d2s_head:
            self.dec_conv_d2s_head = Conv2d(c, 4 * output_channels, 3, 1,
                                            dtype)
        else:
            self.dec_conv_final = Conv2d(c, output_channels, 1, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.dec_norm_in(x))
        for i in range(self.n):
            x = getattr(self, f"dec_convT_{i}")(x)
            x = leaky_relu(getattr(self, f"dec_norm_{i}")(x))
        if self.d2s_head:
            x = depth_to_space(self.dec_conv_d2s_head(x), 2)
        else:
            x = self.dec_conv_final(x)
        return x.to(torch.float32)


class MLPDiscriminator(nn.Module):
    """Latent critic of the adversarial autoencoders: Dense ``hidden[i]``
    (``disc_dense_{i}``) with LeakyReLU 0.2 (``tf.nn.leaky_relu``, not the
    backbone's 0.3), then Dense 1 (``disc_out``); output float32."""

    def __init__(self, in_features: int, hidden: Sequence[int] = (50, 50),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = tuple(hidden)
        n = in_features
        for i, width in enumerate(self.hidden):
            self.add_module(f"disc_dense_{i}", Linear(n, width, dtype))
            n = width
        self.disc_out = Linear(n, 1, dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = z
        for i in range(len(self.hidden)):
            h = leaky_relu(getattr(self, f"disc_dense_{i}")(h),
                           LEAKY_SLOPE_ZIMMERER)
        return self.disc_out(h).to(torch.float32)
