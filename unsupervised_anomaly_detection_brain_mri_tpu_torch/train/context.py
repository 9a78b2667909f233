"""Context-encoder masking: zero 1-3 random 20x20 boxes inside each
sample's brain bounding box.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/train/
context.py`.  Each sample gets its own mask (the JAX package's documented
fix of the reference, which multiplied every sample with the last sample's
mask).  The draws come from the trainer's generator
(``context_mask_draws``); the geometry is a function of the draws
(``apply_context_masks``), so a test can give both packages the same
draws.
"""

from __future__ import annotations

from typing import Tuple

import torch

from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    RandomSource,
    draw,
)

Tensor = torch.Tensor


def brain_bbox(mask: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-sample bounding box (r0, r1, c0, c1) of a boolean (B, H, W)
    mask; an empty mask gives the full image."""
    rows = mask.any(dim=2).to(torch.uint8)  # (B, H)
    cols = mask.any(dim=1).to(torch.uint8)  # (B, W)
    H, W = mask.shape[1], mask.shape[2]
    # argmax returns the first maximum, as jnp.argmax does
    r0 = torch.argmax(rows, dim=1)
    r1 = H - 1 - torch.argmax(rows.flip(1), dim=1)
    c0 = torch.argmax(cols, dim=1)
    c1 = W - 1 - torch.argmax(cols.flip(1), dim=1)
    return r0, r1, c0, c1


def context_mask_draws(generator: RandomSource, batch: int,
                       max_boxes: int, device: torch.device
                       ) -> Tuple[Tensor, Tensor]:
    """(n_boxes (B,) uniform in 1..max_boxes, u (B, max_boxes, 2) uniform
    in [0, 1)), the JAX package's ``randint`` and ``uniform`` draws."""
    n_boxes = draw(lambda shape, **kw: torch.randint(1, max_boxes + 1,
                                                      shape, **kw),
                    generator, (batch,), device)
    u = draw(torch.rand, generator, (batch, max_boxes, 2), device)
    return n_boxes, u


def apply_context_masks(images: Tensor, brainmask: Tensor, n_boxes: Tensor,
                        u: Tensor, box_size: int = 20) -> Tensor:
    """``images`` (B, H, W, C) with the first ``n_boxes[b]`` of sample b's
    ``box_size``^2 boxes zeroed.  Box corners are uniform (``u``) in
    [r0, r1 - box] x [c0, c1 - box] of the sample's brain bounding box; a
    sample whose box does not fit keeps its image."""
    B, H, W, _ = images.shape
    max_boxes = u.shape[1]
    r0, r1, c0, c1 = brain_bbox(brainmask.to(torch.bool))
    r_span = torch.clamp_min(r1 - box_size - r0, 0)
    c_span = torch.clamp_min(c1 - box_size - c0, 0)
    # float32 products truncated toward zero, as JAX's astype(int32)
    br = r0[:, None] + (u[..., 0] * (r_span[:, None] + 1)).to(torch.int64)
    bc = c0[:, None] + (u[..., 1] * (c_span[:, None] + 1)).to(torch.int64)
    valid = ((r0 < r1 - box_size) & (c0 < c1 - box_size))[:, None]
    active = (torch.arange(max_boxes, device=u.device)[None, :]
              < n_boxes[:, None].to(torch.int64)) & valid  # (B, boxes)
    rr = torch.arange(H, device=images.device)[None, None, :, None]
    cc = torch.arange(W, device=images.device)[None, None, None, :]
    br, bc = br[:, :, None, None], bc[:, :, None, None]
    in_box = ((rr >= br) & (rr < br + box_size) & (cc >= bc)
              & (cc < bc + box_size) & active[:, :, None, None])
    keep = ~in_box.any(dim=1)  # (B, H, W)
    return images * keep[..., None].to(images.dtype)


def random_context_masks(generator: RandomSource, images: Tensor,
                         brainmask: Tensor, max_boxes: int = 3,
                         box_size: int = 20) -> Tensor:
    """``images`` with 1..max_boxes random ``box_size``^2 boxes zeroed per
    sample.  images: (B, H, W, C); brainmask: (B, H, W), bool or float."""
    n_boxes, u = context_mask_draws(generator, images.shape[0], max_boxes,
                                    images.device)
    return apply_context_masks(images, brainmask, n_boxes, u, box_size)
