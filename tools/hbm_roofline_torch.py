#!/usr/bin/env python
"""HBM roofline of the parity AE train epoch on the port (counterpart of
``tools/hbm_roofline.py``).

Answers: how close does the port's ``AE`` epoch come to the card's
achievable memory bandwidth?

Method:
  1. Achievable bandwidth from streaming loops on 256 and 512 MB float32
     tensors: copy (``y = x * c``: one read, one write) and triad
     (``y = b + 0.5 * a``: two reads, one write), each timed by CUDA events
     over ``PASSES`` back-to-back passes, best of ``TRIALS``.
  2. The epoch's time: the marginal slope between 4- and 16-epoch runs
     through the trainer's own epoch path (CUDA events), so fixed costs
     cancel.
  3. The epoch's bytes.  The port has no compiler cost analysis, and
     ``ncu`` does not run on the card's machine, so the bytes are counted
     by ``bench_torch.count_bytes``: a dispatch mode that adds up the input
     and output bytes of every dispatched operator, views left out.  That
     is the traffic of eager execution, which fuses nothing: an upper
     bound on what a fused program would move, not a hardware counter.
     FLOPs come from ``bench_torch.count_flops``.
  4. ``hbm_utilization_pct`` = (bytes / epoch time) / achievable bandwidth.

Prints one JSON line.  ``--device cpu`` (with small ``--stream-mb``)
exists for the tests: its times are the host's, no device metric.

Usage:  python3 tools/hbm_roofline_torch.py [--batch 128] [--image 128]
            [--slices 1024] [--stream-mb 256 512] [--device cuda]
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_torch import (  # noqa: E402
    Clock,
    card_info,
    count_bytes,
    count_flops,
    resolve_device,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (  # noqa: E402
    Config,
    Options,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.engine import (  # noqa: E402
    epoch_indices,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (  # noqa: E402
    get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils.misc import (  # noqa: E402
    device_peaks,
)

TRIALS = 3
PASSES = 10


def _best_seconds(clock: Clock, fn, n: int) -> float:
    """Best of TRIALS times of ``n`` back-to-back calls of ``fn``."""
    def calls():
        for _ in range(n):
            fn()
    return min(clock.seconds(calls) for _ in range(TRIALS))


def measure_peak_bw(device: torch.device, sizes_mb) -> dict:
    clock = Clock(device)
    out = {}
    for mb in sizes_mb:
        n = int(mb) * 1024 * 1024 // 4
        x = torch.arange(n, dtype=torch.float32, device=device) * 1e-9
        b = torch.ones(n, dtype=torch.float32, device=device)
        y = torch.empty_like(x)
        nbytes = x.numel() * x.element_size()
        for name, passes, fn in (
                ("copy", 2, lambda: torch.mul(x, 1.000001, out=y)),
                ("triad", 3, lambda: torch.add(b, x, alpha=0.5, out=y))):
            fn()  # warm-up
            per_pass = _best_seconds(clock, fn, PASSES) / PASSES
            out[f"{name}_{mb}MB_GBps"] = round(passes * nbytes / per_pass
                                               / 1e9, 1)
        del x, b, y
    out["achievable_GBps"] = max(out.values())
    return out


def measure_ae_epoch(device: torch.device, B: int, H: int,
                     n_slices: int) -> dict:
    clock = Clock(device)
    rng = np.random.default_rng(0)
    pool = {"x": torch.from_numpy(rng.uniform(
        0, 1, (n_slices, H, H, 1)).astype(np.float32)).to(device)}
    cfg = Config(trainer="AE", model="autoencoder", batchsize=B,
                 outputWidth=H, outputHeight=H, zDim=128, numEpochs=1)
    tr = get_trainer("AE")(cfg, Options(), device=device)
    tr.init_state()

    def epochs(n: int):
        for _ in range(n):
            metrics = tr._run_epoch("TRAIN", pool,
                                    epoch_indices(rng, n_slices, B))
        return metrics

    loss = float(epochs(1)["loss"])  # warm-up
    if not np.isfinite(loss):
        raise FloatingPointError(f"AE epoch loss {loss}")
    per_sec = clock.marginal_rate(epochs, 1, 4, 16)  # epochs a second
    epoch_sec = 1.0 / per_sec if per_sec else None
    bytes_epoch = count_bytes(epochs, 1)
    flops_epoch = count_flops(epochs, 1)
    slices = (n_slices // B) * B
    out = {
        "epoch_sec_marginal": None if epoch_sec is None
        else round(epoch_sec, 6),
        "bytes_accessed_per_epoch_GB": round(bytes_epoch / 1e9, 3),
        "flops_per_epoch_G": round(flops_epoch / 1e9, 1),
        "slices_per_sec": None if epoch_sec is None
        else round(slices / epoch_sec, 1),
        # the parity decoder's last-stage map: B x H x H x 32 bf16
        "last_stage_map_MB": round(B * H * H * 32 * 2 / 1e6, 1),
        "bytes_model": "eager dispatch: every operator's inputs and "
                       "outputs once, views left out, nothing fused",
    }
    if epoch_sec:
        out["achieved_GBps"] = round(bytes_epoch / epoch_sec / 1e9, 1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--image", type=int, default=128)
    ap.add_argument("--slices", type=int, default=1024)
    ap.add_argument("--stream-mb", type=int, nargs="+", default=[256, 512],
                    help="sizes of the streaming tensors in MB")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    info = card_info(device)
    res = {"device": info["device_kind"], "nvidia_smi": info["nvidia_smi"],
           "timing": info["timing"],
           "peak_datasheet_GBps": device_peaks(info["device_kind"])[1] / 1e9}
    res["peak"] = measure_peak_bw(device, args.stream_mb)
    res["ae"] = measure_ae_epoch(device, args.batch, args.image, args.slices)
    if "achieved_GBps" in res["ae"]:
        res["hbm_utilization_pct"] = round(
            100.0 * res["ae"]["achieved_GBps"]
            / res["peak"]["achievable_GBps"], 1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
