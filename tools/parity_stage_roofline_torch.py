#!/usr/bin/env python
"""Per-stage roofline of the parity AE train step on the port (counterpart
of ``tools/parity_stage_roofline.py``).

Times each stage of the flagship parity autoencoder (encoder pyramid
128^2 -> 8^2, dense bottleneck, decoder pyramid, decoder LAST stage alone)
as its own forward+backward of ``sum(square(out))`` at the parity shapes
(batch 128, 128x128, bf16 compute, float32 parameters, train mode), and
sets each measured time against the stage's compute ceiling (FLOPs / the
card's bf16 dense peak) and bandwidth ceiling (bytes / the card's HBM
peak), both peaks from ``utils/misc.py::device_peaks``.  The stages are
built from the port's ``UnifiedEncoder``, ``DenseBottleneck`` and
``UnifiedDecoder``.  ``--fast`` rooflines the non-parity profile's stages
instead (s2d stem, d2s head): does the packed head still sit at its floor
on this card?

Timing: CUDA events around ``K_LO`` and ``K_HI`` back-to-back iterations;
the time of one is the slope between them, best of ``REPS``.  FLOPs come
from ``bench_torch.count_flops`` (``torch.utils.flop_counter``'s
formulas), bytes from ``bench_torch.count_bytes`` (every dispatched
operator's inputs and outputs, views left out: eager traffic, nothing
fused).  ``--device cpu`` exists for the tests: its times are the host's,
no device metric, and its ceilings are placeholders.

Usage:  python3 tools/parity_stage_roofline_torch.py [--batch 128]
            [--image 128] [--fast] [--device cuda]
Prints a markdown table + one JSON line.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_torch import (  # noqa: E402
    Clock,
    card_info,
    count_bytes,
    count_flops,
    resolve_device,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (  # noqa: E402
    Conv2d,
    ConvTranspose2d,
    DenseBottleneck,
    Norm,
    UnifiedDecoder,
    UnifiedEncoder,
    depth_to_space,
    leaky_relu,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils.misc import (  # noqa: E402
    device_peaks,
)

K_LO, K_HI, REPS = 2, 10, 3
INTER = 8  # the AE preset's intermediate resolution
BF16 = torch.bfloat16


class DecoderLastStage(nn.Module):
    """The parity decoder's final stage alone: ConvT(k5, s2, 32 ch) from
    (H/2)^2 to H^2 + BatchNorm + LeakyReLU + 1x1 output conv, the stage
    whose full-resolution 32-channel map (134 MB bf16 at batch 128, 128^2)
    dominates the step's traffic."""

    def __init__(self):
        super().__init__()
        self.convt = ConvTranspose2d(32, 32, 5, dtype=BF16)
        self.norm = Norm(32)
        self.out = Conv2d(32, 1, 1, 1, dtype=BF16)

    def forward(self, x):
        return self.out(leaky_relu(self.norm(self.convt(x))))


class D2SHeadStage(nn.Module):
    """The fast profile's replacement for DecoderLastStage: Conv(3x3,
    4 * C_out) at half resolution + depth-to-space (2x2); the full-
    resolution 32-channel map never exists."""

    def __init__(self):
        super().__init__()
        self.head = Conv2d(32, 4, 3, 1, dtype=BF16)

    def forward(self, x):
        return depth_to_space(self.head(x), 2)


def _fwd_bwd(module: nn.Module, x: torch.Tensor):
    """One forward in train mode and the parameter gradients of
    ``sum(square(out))`` over every output (the squared loss makes the
    cotangent data-dependent)."""
    out = module(x)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum(torch.sum(torch.square(o.float())) for o in outs)
    return torch.autograd.grad(loss, [p for p in module.parameters()])


def _time_marginal(clock: Clock, module: nn.Module, x: torch.Tensor):
    def iters(k):
        def run():
            for _ in range(k):
                grads = _fwd_bwd(module, x)
            return grads
        return run

    iters(K_LO)()  # warm-up (cuDNN's algorithm choice)
    best = float("inf")
    for _ in range(REPS):
        t_lo = clock.seconds(iters(K_LO))
        t_hi = clock.seconds(iters(K_HI))
        if t_hi > t_lo:
            best = min(best, (t_hi - t_lo) / (K_HI - K_LO))
    return best if np.isfinite(best) else None


def stages(B: int, H: int, fast: bool, device: torch.device):
    """(name, module, input, counted in the step's sum) of each stage.
    Each input is an NHWC array seen as NCHW, the layout the port's models
    give their layers (they permute NHWC slices), so cuDNN runs the
    channels-last kernels of the real step: contiguous NCHW inputs take
    its NCHW BatchNorm kernels, and a stage then runs slower than it does
    inside the step."""
    rng = np.random.default_rng(0)

    def uniform(*nhwc):
        return torch.from_numpy(rng.uniform(0, 1, nhwc).astype(
            np.float32)).to(device).permute(0, 3, 1, 2)

    x_img = uniform(B, H, H, 1)
    h_lat = uniform(B, INTER, INTER, 128)
    x_half = uniform(B, H // 2, H // 2, 32)
    half, full = f"{H // 2}^2", f"{H}^2"
    if fast:
        out = [
            (f"encoder {full}->{INTER}^2 (s2d stem)",
             UnifiedEncoder(H, 1, INTER, dtype=BF16,
                            space_to_depth_stem=True), x_img, True),
            ("bottleneck (dense z=128)",
             DenseBottleneck(128, INTER, 128, 0.2, dtype=BF16), h_lat, True),
            (f"decoder {INTER}^2->{full} (d2s head)",
             UnifiedDecoder(128, H, 1, INTER, dtype=BF16,
                            depth_to_space_head=True), h_lat, True),
            (f"decoder HEAD stage (d2s, computed at {half})",
             D2SHeadStage(), x_half, False),
        ]
    else:
        out = [
            (f"encoder {full}->{INTER}^2",
             UnifiedEncoder(H, 1, INTER, dtype=BF16), x_img, True),
            ("bottleneck (dense z=128)",
             DenseBottleneck(128, INTER, 128, 0.2, dtype=BF16), h_lat, True),
            (f"decoder {INTER}^2->{full}",
             UnifiedDecoder(128, H, 1, INTER, dtype=BF16), h_lat, True),
            (f"decoder LAST stage ({half}->{full})", DecoderLastStage(),
             x_half, False),
        ]
    return [(name, m.to(device).train(), x, summed)
            for name, m, x, summed in out]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--image", type=int, default=128)
    ap.add_argument("--fast", action="store_true",
                    help="roofline the fast-profile stages (s2d stem, d2s "
                         "head)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.manual_seed(0)
    info = card_info(device)
    peak_flops, peak_bw = device_peaks(info["device_kind"])
    clock = Clock(device)
    B, H = args.batch, args.image

    rows, total_ms = [], 0.0
    for name, module, x, summed in stages(B, H, args.fast, device):
        t = _time_marginal(clock, module, x)
        flops = count_flops(_fwd_bwd, module, x)
        nbytes = count_bytes(_fwd_bwd, module, x)
        if t is None:
            rows.append({"stage": name, "error": "noise-dominated"})
            continue
        t_comp, t_bw = flops / peak_flops, nbytes / peak_bw
        rows.append({
            "stage": name, "measured_ms": round(1e3 * t, 4),
            "gflops": round(flops / 1e9, 3), "gbytes": round(nbytes / 1e9, 4),
            "compute_ceiling_ms": round(1e3 * t_comp, 4),
            "bandwidth_ceiling_ms": round(1e3 * t_bw, 4),
            "bound": "compute" if t_comp >= t_bw else "bandwidth",
            "pct_of_lightspeed": round(100 * max(t_comp, t_bw) / t, 2),
        })
        if summed:
            total_ms += 1e3 * t

    print(f"\n{info['nvidia_smi'] or info['device_kind']}; "
          f"{info['timing']}; peaks {peak_flops / 1e12:g} TFLOP/s, "
          f"{peak_bw / 1e12:g} TB/s")
    print("\n| stage | measured ms | GFLOP | GB | compute ceil ms | "
          "BW ceil ms | bound | % of lightspeed |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        if "error" in r:
            print(f"| {r['stage']} | {r['error']} | | | | | | |")
            continue
        print(f"| {r['stage']} | {r['measured_ms']} | {r['gflops']} | "
              f"{r['gbytes']} | {r['compute_ceiling_ms']} | "
              f"{r['bandwidth_ceiling_ms']} | {r['bound']} | "
              f"{r['pct_of_lightspeed']} |")
    print(json.dumps({"device": info["device_kind"],
                      "nvidia_smi": info["nvidia_smi"],
                      "timing": info["timing"], "batch": B, "image": H,
                      "profile": "fast" if args.fast else "parity",
                      "peak_flops": peak_flops, "peak_bytes_per_sec": peak_bw,
                      "stages": rows,
                      "stage_sum_ms": round(total_ms, 4)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
