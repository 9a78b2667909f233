"""The card: the check that there is one, its description, peaks and
synchronisation.

A measurement never falls back to the CPU: ``require_cuda`` raises when
``torch.cuda.is_available()`` is false or fewer cards are visible than the
cell asks for.  The CPU tests replace ``require_cuda`` to drive the rest of
a run on the CPU at a small size.
"""

from __future__ import annotations

import subprocess
from typing import Any, Dict, Tuple

import torch

# NVIDIA's data sheet, H100 SXM5, dense rates at the 700 W limit:
# bf16 FLOP/s, HBM bytes/s
PEAKS = {
    "h100 sxm": (989e12, 3.35e12),
    "h100 pcie": (756e12, 2.0e12),
}


def require_cuda(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this "
                           "benchmark measures the port on an NVIDIA GPU")
    if torch.cuda.device_count() < chips:
        raise RuntimeError(f"the cell needs {chips} cards, "
                           f"{torch.cuda.device_count()} are visible")
    return torch.device("cuda", 0)


def peaks(kind: str) -> Tuple[float, float]:
    """(dense bf16 FLOP/s, HBM bytes/s) of a card named ``kind``
    (``torch.cuda.get_device_name()``).  An H100 named for HBM3 is the SXM
    part.  Raises for a card without a row: no share of a peak is
    reported against a guess."""
    k = kind.lower()
    if "h100" in k:
        if "pcie" in k:
            return PEAKS["h100 pcie"]
        if "hbm3" in k or "sxm" in k:
            return PEAKS["h100 sxm"]
    raise KeyError(f"no published peaks for the card {kind!r}")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or what
    went wrong reading them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def describe(device: torch.device, count: int) -> Dict[str, Any]:
    """The result's ``device`` object (without the traced fields)."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                device))}
