"""The input gradient of the encoder's 1-channel stem convolution: the
hand-written CUDA kernel and its plain twin.

``UnifiedEncoder``'s stage 0 is a SAME 5x5 stride-2 convolution from one
channel to 32.  Where a call can need the gradient of its input and
nothing else (the input restoration: eval mode, frozen weights, the
input requiring grad), the encoder runs the layer through
``models/layers.py::_StemConv``, whose backward gives the input's float32
gradient from one of these:

  * ``stem_input_grad_cuda`` launches ``csrc/stem_dgrad.cu`` on a CUDA
    tensor (parity-split taps, the crop and the cast folded into its store;
    see the note at the top of the source);
  * ``stem_input_grad_plain`` is the plain PyTorch version:
    ``torch.nn.grad.conv2d_input`` on the padded input's shape, cropped and
    cast, as autograd differentiates the layer's cast, pad and convolution.

Each kernel launch (never a plain-version call) adds one to the trace
counter ``stem_dgrad_kernel`` (``utils/trace.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops._build import (
    load_library,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import trace

Pads = Tuple[int, int]
_STRIDE = 2
_KERNEL = 5
_VECTOR_BYTES = 16  # grad_out's rows are read 16 bytes a thread
# csrc/stem_dgrad.cu's layouts of NCHW grad_out: rows of whole 16-byte
# vectors, or any other
_NCHW_VECTORS, _NCHW = 0, 1


def _check_weight(weight: torch.Tensor) -> None:
    if weight.ndim != 4 or tuple(weight.shape[1:]) != (1, _KERNEL, _KERNEL):
        raise ValueError(f"expected a (C, 1, {_KERNEL}, {_KERNEL}) weight, "
                         f"got {tuple(weight.shape)}")


def stem_input_grad_plain(grad_out: torch.Tensor, weight: torch.Tensor,
                          size: Tuple[int, int], ph: Pads, pw: Pads
                          ) -> torch.Tensor:
    """(B, 1, H, W) float32 gradient of a (B, 1, H, W) input padded by
    ``ph``/``pw`` and convolved (5x5, stride 2) with ``weight`` (C, 1, 5, 5),
    from the output's gradient ``grad_out`` (B, C, OH, OW), computed in
    ``grad_out``'s dtype."""
    _check_weight(weight)
    H, W = size
    padded = (grad_out.shape[0], 1, H + sum(ph), W + sum(pw))
    grad = torch.nn.grad.conv2d_input(padded, weight, grad_out, _STRIDE)
    return grad[:, :, ph[0]:ph[0] + H, pw[0]:pw[0] + W].to(torch.float32)


def stem_input_grad_cuda(grad_out: torch.Tensor, weight: torch.Tensor,
                         size: Tuple[int, int], ph: Pads, pw: Pads
                         ) -> torch.Tensor:
    """``stem_input_grad_plain`` in float32 by the hand-written kernel
    ``csrc/stem_dgrad.cu``: ``grad_out`` (B, C, OH, OW) and ``weight``
    (C, 1, 5, 5) on one CUDA device, both bf16 or both float32, and SAME
    pads of 1 or 2 before the input.  ``grad_out`` NCHW-contiguous (the
    served layout) is read as it is, any other layout made contiguous.
    Launches on the current stream of the current device, which is
    ``grad_out``'s in autograd's backward; raises on any other input and
    on a failed build or launch (a stream of another device included)."""
    _check_weight(weight)
    if not (grad_out.is_cuda and weight.device == grad_out.device):
        raise ValueError("the stem's input-gradient kernel needs grad_out "
                         "and weight on one CUDA device")
    if grad_out.dtype not in (torch.bfloat16, torch.float32) or (
            weight.dtype != grad_out.dtype):
        raise ValueError(f"expected bf16 or float32 grad_out and weight of "
                         f"one dtype, got {grad_out.dtype} and "
                         f"{weight.dtype}")
    B, C, OH, OW = grad_out.shape
    H, W = size
    if weight.shape[0] != C:
        raise ValueError(f"grad_out has {C} channels, the weight "
                         f"{weight.shape[0]}")
    if (OH, OW) != ((H + sum(ph) - _KERNEL) // _STRIDE + 1,
                    (W + sum(pw) - _KERNEL) // _STRIDE + 1):
        raise ValueError(f"grad_out {tuple(grad_out.shape)} is not the "
                         f"output of a ({H}, {W}) input padded by {ph}, "
                         f"{pw}")
    if not (1 <= ph[0] <= 2 and 1 <= pw[0] <= 2):
        raise ValueError(f"expected SAME pads of 1 or 2 before the input, "
                         f"got {ph}, {pw}")
    grad_out = grad_out.contiguous()
    weight = weight.contiguous()
    layout = (_NCHW_VECTORS
              if OW * grad_out.element_size() % _VECTOR_BYTES == 0
              and grad_out.data_ptr() % _VECTOR_BYTES == 0 else _NCHW)
    out = torch.empty((B, 1, H, W), dtype=torch.float32,
                      device=grad_out.device)
    if out.numel() == 0:
        return out
    rc = load_library().uad_stem_dgrad(
        grad_out.data_ptr(), weight.data_ptr(), out.data_ptr(),
        B, C, H, W, OH, OW, ph[0], pw[0],
        int(grad_out.dtype == torch.bfloat16), layout,
        torch.cuda.current_stream(grad_out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stem_dgrad kernel launch failed: CUDA error {rc}")
    trace.count("stem_dgrad_kernel")
    return out
