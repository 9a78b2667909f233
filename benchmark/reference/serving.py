"""The reference's serving pipeline for one raw scan (H, W, S), written
from the published protocol:

  1. clamp at the 99.8th percentile, divide by the maximum;
  2. resize each axial slice to the model's size with SciPy's spline zoom
     (order 3), giving (S, h, w);
  3. brain mask: voxels above 0.05, eroded 12 times per slice by the
     3 x 3 cross (border 0); the hyperintensity prior's cut is the 0.9
     quantile of the normalised scan;
  4. reconstruct (the configuration's rule), residual ``max(x - rec, 0)``
     inside the eroded mask, zeroed where the input lies under the prior's
     cut, then the 5 x 5 x 5 median with mirrored borders (the edge voxel
     repeated);
  5. per-slice scores: the map's maximum; mask: the map above the
     threshold, 26-connected components of more than ``minLesionSize``
     voxels kept (SciPy's labelling).

The median runs on the device from unfolded windows (``torch.median`` of
125 values); everything else is NumPy and SciPy on the host.  With
``low=True`` the host arrays are rounded to bfloat16 after each stage,
one step below their float32 (the control).
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict, Optional

import numpy as np
import torch
from scipy import ndimage as ndi

Tensor = torch.Tensor

CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)


def bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bfloat16 and back to float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def eroded_mask(x: np.ndarray, erosions: int = 12) -> np.ndarray:
    return ndi.binary_erosion(x > 0.05, structure=CROSS[None],
                              iterations=erosions, border_value=0)


def prepare(scan: np.ndarray, size: int, upper: float = 99.8,
            low: bool = False) -> Dict[str, object]:
    v = np.nan_to_num(scan.astype(np.float32))
    v = np.clip(v, None, np.percentile(v, upper))
    if v.max() > 0:
        v = v / v.max()
    H, W, S = v.shape
    zoom = (size / H, size / W)
    x = np.stack([ndi.zoom(v[:, :, s], zoom) for s in range(S)]
                 ).astype(np.float32)
    if low:
        x = bf16(x)
    return {"x": x, "eroded": eroded_mask(x),
            "prior_q": float(np.quantile(v, 0.9))}


def median5(vol: Tensor, chunk: int = 8) -> Tensor:
    """Exact 5^3 median of an (S, H, W) float32 tensor, borders mirrored
    with the edge repeated."""
    S, H, W = vol.shape
    padded = torch.from_numpy(np.pad(vol.cpu().numpy(), 2,
                                     mode="symmetric")).to(vol.device)
    out = torch.empty_like(vol)
    for s0 in range(0, S, chunk):
        slab = padded[s0: min(S, s0 + chunk) + 4]
        win = slab.unfold(0, 5, 1).unfold(1, 5, 1).unfold(2, 5, 1)
        out[s0: s0 + win.shape[0]] = win.reshape(
            win.shape[:3] + (125,)).median(dim=-1).values
    return out


def postprocess(x: Tensor, rec: Tensor, eroded: np.ndarray, prior_q: float,
                low: bool = False) -> np.ndarray:
    """The anomaly map of input ``x`` and reconstruction ``rec`` (S, H, W)
    on the device."""
    diff = torch.clamp(x - rec, min=0.0) * torch.from_numpy(eroded).to(
        x.device, torch.float32)
    q = torch.tensor(prior_q, dtype=torch.float32, device=x.device)
    diff = torch.where(x < q, torch.zeros_like(diff), diff)
    if low:
        diff = diff.to(torch.bfloat16).to(torch.float32)
    return median5(diff.contiguous()).cpu().numpy()


def filter_components(binary: np.ndarray, min_size: int) -> np.ndarray:
    """``binary`` with its 26-connected components of at most ``min_size``
    voxels removed, as float32 0/1."""
    labels, _ = ndi.label(binary, structure=np.ones((3, 3, 3), bool))
    sizes = np.bincount(labels.ravel())
    keep = (sizes[labels] > min_size) & (labels > 0)
    return keep.astype(np.float32)


def slice_scores(amap: np.ndarray) -> np.ndarray:
    """Each slice's score: the map's maximum over it."""
    return amap.reshape(amap.shape[0], -1).max(axis=1)


def answer(amap: np.ndarray, threshold: float, min_size: int
           ) -> Dict[str, np.ndarray]:
    return {"anomaly_map": amap,
            "scores": slice_scores(amap),
            "mask": filter_components(amap > np.float32(threshold),
                                      min_size)}


def serve(model: ModuleType, cfg: Dict, p: Dict[str, Tensor],
          b: Dict[str, Tensor], scan: np.ndarray, threshold: float,
          generator: torch.Generator, precision: str = "float32",
          min_size: int = 7, capture: Optional[Dict] = None
          ) -> Dict[str, np.ndarray]:
    """The anomaly map, per-slice scores and mask of one scan.  With
    ``precision="fp8"`` (the control) the networks run in float8 and the
    host stages in bfloat16; ``capture`` is passed to a stepwise
    reconstruction."""
    low = precision != "float32"
    device = next(iter(p.values())).device
    prep = prepare(scan, cfg["outputWidth"], low=low)
    x = torch.from_numpy(prep["x"]).to(device)
    kwargs = {} if capture is None else {"capture": capture}
    rec = model.reconstruct(p, b, x[..., None], cfg, generator, precision,
                            **kwargs)[..., 0]
    out = answer(postprocess(x, rec, prep["eroded"], prep["prior_q"], low),
                 threshold, min_size)
    out["reconstruction"] = rec.cpu().numpy()
    out["x"] = x
    return out
