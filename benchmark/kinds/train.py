"""Traffic kind ``train``: the trainer's epoch path, as ``fit`` runs it.

Set-up builds one trainer with the benchmark's weights on the card,
uploads the mix's pool of healthy slices (``pool_volumes`` phantoms of
``size`` x ``size`` x ``slices``), and runs epoch 0 through
``BaseTrainer._run_epoch("TRAIN", pool, rows)``: its first
``check_steps`` steps are recorded for the check (their losses, the first
gradient as Adam holds it, the parameters before the next step), and the
rest of the epoch warms the path: every step of an epoch has the same
shapes.  The window then runs whole epochs, each over a fresh
permutation of the pool with the remainder dropped and its metrics read
back once, as ``fit`` does, until ``--seconds`` have passed; the rate
counts every slice trained over the time to the final synchronisation.

With ``--trace 1`` the window is ``trace_steps`` steps (whole epochs)
under the profiler, with a span around every ``train_step`` (the host's
time to enqueue a step) and every epoch.

The check replays the recorded steps in the plain reference from the same
weights, batches and random streams (the port's documented streams: its
dropout generator on the device seeded with ``config.seed``, its normal
draws with ``config.seed + 1``).
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from benchmark.common import compare, flops, weights
from benchmark.common.context import Run, port, port_config
from benchmark.common.device import sync
from benchmark.common.phantoms import training_pool
from benchmark.common.spans import Spans
from benchmark.common.trace import DeviceTrace, summarize
from benchmark.reference import backbone as B
from benchmark.reference import training as RT
from benchmark.reference.layers import float32_products


def epoch_indices(rng: np.random.Generator, n: int, batchsize: int
                  ) -> np.ndarray:
    """(n // batchsize, batchsize) rows of a permutation of the pool."""
    num = n // batchsize
    return rng.permutation(n)[: num * batchsize].reshape(
        num, batchsize).astype(np.int32)


class FirstSteps:
    """Wraps the trainer's ``train_step`` (``_run_epoch`` looks it up on
    the instance) and keeps what the check needs of the first ``n``
    steps."""

    def __init__(self, trainer, n: int):
        self.trainer, self.n = trainer, n
        self.losses: List[torch.Tensor] = []
        self.grad1: Dict[str, torch.Tensor] = {}
        self.after: Dict[str, torch.Tensor] = {}
        trainer.train_step = self.step

    def step(self, batch):
        tr = self.trainer
        metrics = type(tr).train_step(tr, batch)
        self.losses.append(metrics["loss"].detach().float().clone())
        named = list(tr.model.named_parameters())
        if len(self.losses) == 1:
            beta1 = tr.optimizer.param_groups[0]["betas"][0]
            self.grad1 = {n: tr.optimizer.state[p].get(
                "exp_avg", torch.zeros_like(p)).detach().clone()
                / (1.0 - beta1) for n, p in named}
        if len(self.losses) == self.n:
            self.after = {n: p.detach().clone() for n, p in named}
        return metrics

    def remove(self) -> None:
        del self.trainer.train_step


def _build(ctx: Run):
    cfg = ctx.config
    w_seed, stream_seed, data_seed, order_seed = ctx.seeds(4)
    config = port_config(cfg, stream_seed)
    options = port("config").Options()
    trainer = port("train.registry").get_trainer(config.trainer)(
        config, options, device=ctx.device)
    ref = ctx.reference_model()
    params, buffers = weights.initial(ref, cfg, w_seed, ctx.device)
    weights.load_into(trainer.model, {**params, **buffers})
    trainer.optimizer = trainer.make_optimizer()
    ctx.mark("trainer and weights")
    pool_np = training_pool(data_seed, ctx.mix["pool_volumes"],
                            cfg["outputWidth"], ctx.mix["slices"])
    pool = {"x": torch.from_numpy(pool_np).to(ctx.device)}
    ctx.mark("pool")
    return {"trainer": trainer, "config": config, "params": params,
            "buffers": buffers, "pool": pool, "stream_seed": stream_seed,
            "order_seed": order_seed, "ref": ref}


def _epoch(s: Dict[str, Any], rows: np.ndarray) -> Dict[str, float]:
    if len(rows) == 0:
        return {}
    metrics = s["trainer"]._run_epoch("TRAIN", s["pool"], rows)
    return {k: float(v) for k, v in metrics.items()}


def setup(ctx: Run) -> Dict[str, Any]:
    s = _build(ctx)
    n = int(s["pool"]["x"].shape[0])
    bs = s["config"].batchsize
    s["rows"] = lambda e: epoch_indices(
        np.random.default_rng((s["order_seed"], e)), n, bs)
    rows0 = s["rows"](0)
    k = int(ctx.mix["check_steps"])
    first = FirstSteps(s["trainer"], k)
    _epoch(s, rows0[:k])
    first.remove()
    s["first"], s["first_rows"] = first, rows0[:k]
    ctx.mark("first steps")
    _epoch(s, rows0[k:])
    sync(ctx.device)
    ctx.mark("warm-up")
    s["next_epoch"] = 1
    return s


def window(s: Dict[str, Any], ctx: Run) -> Dict[str, Any]:
    e, steps, failed = s["next_epoch"], 0, 0
    sync(ctx.device)
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    while time.perf_counter() < end:
        rows = s["rows"](e)
        metrics = _epoch(s, rows)
        if not all(math.isfinite(v) for v in metrics.values()):
            failed += len(rows)
        steps += len(rows)
        e += 1
    sync(ctx.device)
    return {"window_s": time.perf_counter() - t0, "units": steps,
            "failed": failed}


def traced(s: Dict[str, Any], ctx: Run) -> Dict[str, Any]:
    spans = Spans()
    spans.wrap(s["trainer"], "train_step", "train_step")
    e, steps = s["next_epoch"], 0
    with DeviceTrace(ctx.device) as tr:
        while steps < int(ctx.mix["trace_steps"]):
            rows = s["rows"](e)
            with spans.span("epoch"):
                _epoch(s, rows)
            steps += len(rows)
            e += 1
    spans.restore()
    if "train_step" in vars(s["trainer"]):
        del s["trainer"].train_step
    records = spans.to_records()
    return {"window_s": (tr.end_ns - tr.start_ns) / 1e9, "units": steps,
            "failed": 0, "spans": records,
            "trace": summarize(tr.events, tr.start_ns, tr.end_ns, records)}


def step_flops(s: Dict[str, Any], ctx: Run) -> int:
    """FLOPs of one training step of the reference at the cell's batch."""
    x = s["pool"]["x"][: s["config"].batchsize]
    streams = _streams(ctx, s["stream_seed"])
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in s["params"].items()}
    bufs = {k: v.clone() for k, v in s["buffers"].items()}

    def one():
        loss = s["ref"].train_loss(B.Net(leaves, bufs, True, "float32"), x,
                                   ctx.config, streams)
        torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)

    return flops.count_flops(one)


def _streams(ctx: Run, seed: int) -> Dict[str, torch.Generator]:
    return {"generator": torch.Generator(device=ctx.device).manual_seed(
                seed),
            "sample_generator": torch.Generator(
                device=ctx.device).manual_seed(seed + 1)}


def reference_steps(s: Dict[str, Any], ctx: Run,
                    precision: str = "float32") -> Dict[str, Any]:
    """The reference's steps over the recorded rows."""
    batches = [s["pool"]["x"][torch.as_tensor(r, device=ctx.device)
                              .long()] for r in s["first_rows"]]
    with float32_products():
        return RT.follow(s["ref"], ctx.config, s["params"], s["buffers"],
                         batches, _streams(ctx, s["stream_seed"]), precision)


def reference_numbers(s: Dict[str, Any], ctx: Run,
                      program: Tuple[List[float], Dict, Dict],
                      ) -> Dict[str, float]:
    """The compared numbers of the first steps ``program`` (losses, first
    gradient, parameters after) against the reference."""
    ref = reference_steps(s, ctx)
    losses, grad1, after = program
    return compare.train_numbers(losses, ref["losses"], grad1, ref["grad1"],
                                 s["params"], after, ref["params"])


def program_steps(s: Dict[str, Any]):
    f = s["first"]
    return ([float(v) for v in f.losses], f.grad1, f.after)


def free_program(s: Dict[str, Any], device: torch.device) -> None:
    s.pop("trainer", None)
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(ctx: Run) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """One run: set-up, the window (or the traced window), the check."""
    s = setup(ctx)
    setup_s = ctx.setup_seconds()
    rec = traced(s, ctx) if ctx.trace else window(s, ctx)
    rec.update(kind="train", setup_s=setup_s,
               slices_per_unit=s["config"].batchsize)
    if ctx.device.type == "cuda":
        rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
            ctx.device))
    free_program(s, ctx.device)
    if ctx.trace:
        rec["flops_per_unit"] = step_flops(s, ctx)
    return rec, reference_numbers(s, ctx, program_steps(s))


def control(ctx: Run) -> Dict[str, float]:
    """The compared numbers of the control, the float8 reference's first
    steps, against the reference."""
    s = setup(ctx)
    free_program(s, ctx.device)
    low = reference_steps(s, ctx, "fp8")
    return reference_numbers(s, ctx, (low["losses"], low["grad1"],
                                      low["params"]))
