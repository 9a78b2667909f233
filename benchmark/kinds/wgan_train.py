"""Traffic kind ``wgan_train``: an adversarial trainer's WGAN-GP phase
through the trainer's epoch path.

Set-up is the ``train`` kind's (``kinds/train.py``): one trainer with the
benchmark's weights on the card, its optimizers (one Adam a parameter
group), and the mix's pool of healthy slices on the card.  ``trainer.epoch``
stays 0, below ``numEpochs``: every step is a WGAN step (one generator
update, then the critic updates, each with its gradient penalty).  The first
``check_steps`` steps run through ``BaseTrainer._run_epoch("TRAIN", pool,
rows)`` with ``trainer.update`` wrapped on the instance, which keeps what
the check needs: every update's loss, the first gradient of each group (as
Adam holds it) and the parameters after the last of those steps.  One
block warms the path up.

The window then runs blocks of ``block_steps`` steps through
``_run_epoch``, each block's metrics read back once, walking each epoch's
fresh permutation of the pool (the remainder dropped; an epoch's last
block is shorter), until ``--seconds`` have passed; a whole epoch would
outrun the window.  The rate counts every slice trained over the time to
the final synchronisation.  The record's ``kind`` is ``train``, so the
training metrics read it, and its ``mix`` is ``wgan_train``.

With ``--trace 1`` the window is ``trace_steps`` steps under
``LaunchTrace`` (``common/launches.py``), a span around every
``train_step`` and the port's own recording open (``utils/trace.py``,
annotated); the record keeps the port's spans and counters and the launch
time of every device event, by which device time is given to the port's
spans.  On a port without spans those metrics read nothing.

The check replays the recorded steps in the plain reference
(``reference/adversarial.py``) from the same weights, batches and random
streams (the trainer's prior z from ``generator``, seeded with
``config.seed``, its interpolate's alpha from ``gp_generator``, seeded with
``config.seed + 2``), and compares each group's numbers
(``common/compare.py::train_numbers``) under the group's name:
``gen.loss_rel``, ``disc.grad1_rel``, ...  The critic's first gradient is
also taken again at the port's own state before its first update
(``disc.grad1_own_*``), since the generator's update before it sends the
two trajectories apart.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from benchmark.common import compare, flops
from benchmark.common.context import Run, port
from benchmark.common.device import sync
from benchmark.common.launches import LaunchTrace
from benchmark.common.spans import Spans
from benchmark.common.trace import summarize
from benchmark.kinds import train as T
from benchmark.reference import adversarial as A
from benchmark.reference.layers import float32_products

GROUPS = ("gen", "disc")  # the groups a WGAN step updates, in order


class FirstUpdates:
    """Wraps the trainer's ``update`` (its substeps look it up on the
    instance) and keeps what the check needs of the first ``steps``
    steps: every update's loss, each group's first gradient, the
    parameters before each group's first update (``before``), after the
    first step (``after1``) and after the last."""

    def __init__(self, trainer, steps: int):
        self.trainer = trainer
        self.per_step = 1 + trainer.d_iters
        self.n = steps * self.per_step
        self.losses: List[Tuple[str, torch.Tensor]] = []
        self.grad1: Dict[str, Dict[str, torch.Tensor]] = {}
        self.before: Dict[str, Dict[str, torch.Tensor]] = {}
        self.after1: Dict[str, torch.Tensor] = {}
        self.after: Dict[str, torch.Tensor] = {}
        trainer.update = self.update

    def update(self, group: str, loss: torch.Tensor) -> None:
        tr = self.trainer
        if group not in self.before:
            self.before[group] = self._params()
        type(tr).update(tr, group, loss)
        self.losses.append((group, loss.detach().float().clone()))
        if group not in self.grad1:
            opt = tr.optimizer[group]
            beta1 = opt.param_groups[0]["betas"][0]
            named = dict(tr.model.named_parameters())
            self.grad1[group] = {
                n: opt.state[named[n]].get(
                    "exp_avg", torch.zeros_like(named[n])).detach().clone()
                / (1.0 - beta1) for n in tr.groups[group]}
        if len(self.losses) == self.per_step:
            self.after1 = self._params()
        if len(self.losses) == self.n:
            self.after = self._params()

    def _params(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone()
                for n, p in self.trainer.model.named_parameters()}

    def remove(self) -> None:
        del self.trainer.update

    def steps(self) -> Dict[str, Any]:
        return {"losses": [(g, float(v)) for g, v in self.losses],
                "grad1": self.grad1, "before": self.before,
                "params1": self.after1,
                "params": self.after}


def _blocks(rows, epoch: int, start: int, size: int
            ) -> Iterator[np.ndarray]:
    """Successive blocks of rows from ``rows(epoch)[start:]`` on: each
    epoch's permutation cut into ``size`` steps, the last one shorter."""
    while True:
        order = rows(epoch)
        for i in range(start, len(order), size):
            yield order[i:i + size]
        epoch, start = epoch + 1, 0


def setup(ctx: Run) -> Dict[str, Any]:
    s = T._build(ctx)
    n = int(s["pool"]["x"].shape[0])
    bs = s["config"].batchsize
    epochs: Dict[int, np.ndarray] = {}

    def rows(e: int) -> np.ndarray:
        if e not in epochs:
            epochs.clear()
            epochs[e] = T.epoch_indices(
                np.random.default_rng((s["order_seed"], e)), n, bs)
        return epochs[e]

    s["rows"] = rows
    s["trainer"].epoch = 0
    k = int(ctx.mix["check_steps"])
    first = FirstUpdates(s["trainer"], k)
    T._epoch(s, rows(0)[:k])
    first.remove()
    s["first"], s["first_rows"] = first, rows(0)[:k]
    ctx.mark("first steps")
    s["blocks"] = _blocks(rows, 0, k, int(ctx.mix["block_steps"]))
    T._epoch(s, next(s["blocks"]))
    sync(ctx.device)
    ctx.mark("warm-up")
    return s


def window(s: Dict[str, Any], ctx: Run) -> Dict[str, Any]:
    steps, failed = 0, 0
    sync(ctx.device)
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    while time.perf_counter() < end:
        block = next(s["blocks"])
        metrics = T._epoch(s, block)
        if not all(math.isfinite(v) for v in metrics.values()):
            failed += len(block)
        steps += len(block)
    sync(ctx.device)
    return {"window_s": time.perf_counter() - t0, "units": steps,
            "failed": failed}


def traced(s: Dict[str, Any], ctx: Run) -> Dict[str, Any]:
    trace = port("utils.trace")
    spans = Spans()
    spans.wrap(s["trainer"], "train_step", "train_step")
    steps = 0
    with LaunchTrace(ctx.device) as tr:
        with trace.recording(annotate=True) as prog:
            while steps < int(ctx.mix["trace_steps"]):
                block = next(s["blocks"])
                with spans.span("block"):
                    T._epoch(s, block)
                steps += len(block)
    spans.restore()
    if "train_step" in vars(s["trainer"]):
        del s["trainer"].train_step
    records = spans.to_records()
    return {"window_s": (tr.end_ns - tr.start_ns) / 1e9, "units": steps,
            "failed": 0, "spans": records,
            "trace": summarize(tr.events, tr.start_ns, tr.end_ns, records),
            "launches": tr.launches, "program_spans": prog.spans(),
            "program_counters": prog.counters()}


def _streams(ctx: Run, seed: int) -> Dict[str, torch.Generator]:
    """The trainer's streams: ``generator`` (the prior z) and ``gp``
    (alpha), as ``train/base.py`` seeds them."""
    return {"generator": torch.Generator(device=ctx.device).manual_seed(
                seed),
            "gp": torch.Generator(device=ctx.device).manual_seed(seed + 2)}


def step_flops(s: Dict[str, Any], ctx: Run) -> int:
    """FLOPs of one WGAN step of the reference at the cell's batch, the
    penalty's double backward included."""
    x = s["pool"]["x"][: s["config"].batchsize]
    streams = _streams(ctx, s["stream_seed"])
    return flops.count_flops(A.follow, s["ref"], ctx.config, s["params"],
                             [x], streams)


def reference_steps(s: Dict[str, Any], ctx: Run,
                    precision: str = "float32") -> Dict[str, Any]:
    """The reference's steps over the recorded rows."""
    batches = [s["pool"]["x"][torch.as_tensor(r, device=ctx.device).long()]
               for r in s["first_rows"]]
    with float32_products():
        return A.follow(s["ref"], ctx.config, s["params"], batches,
                        _streams(ctx, s["stream_seed"]), precision)


def _rel(program: List[float], reference: List[float]) -> float:
    """The worst |program - reference| / |reference| of paired losses;
    inf where the counts differ or one is not finite."""
    if len(program) != len(reference) or not all(
            math.isfinite(v) for v in program):
        return math.inf
    return max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(program, reference))


def group_numbers(program: Dict[str, Any], reference: Dict[str, Any],
                  start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each group's ``train_numbers`` under the group's name.  Its
    ``loss_rel`` is of the group's first update: the WGAN-GP trajectory is
    chaotic at the preset's rate (float32 and float64 references part by
    2 % at the second step's generator loss and by 19 % at the third's
    critic loss), so the later losses are the reading ``losses_rel``, the
    worst over every update, which no limit bounds.  Besides, of the
    parameters' change over the first WGAN step (one generator update and
    the critic's ``d_iters``, before the chaos has grown): ``update1_rel``,
    the worst leaf's norm gap as ``update3_rel`` takes it, and
    ``update1_dir_med``, the median leaf's 1 - cos."""
    out = {}
    for g in GROUPS:
        prog = [v for grp, v in program["losses"] if grp == g]
        ref = [v for grp, v in reference["losses"] if grp == g]
        nums = compare.train_numbers(
            prog[:1], ref[:1], program["grad1"].get(g, {}),
            reference["grad1"][g], start, program["params"],
            reference["params"])
        nums["losses_rel"] = _rel(prog, ref)
        keys = _moved(reference["grad1"][g])
        dp = {k: program["params1"][k] - start[k] for k in keys}
        dr = {k: reference["params1"][k] - start[k] for k in keys}
        nums["update1_rel"] = compare.worst_leaf_gap(dp, dr)
        nums["update1_dir_med"] = float(np.median(
            compare.leaf_misalignments(dp, dr, keys)))
        out.update({f"{g}.{k}": v for k, v in nums.items()})
    return out


def _moved(grad1: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves ``train_numbers`` compares: those whose reference
    gradient is at least ``SKIP_GRAD`` of the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in grad1.items()}
    median = float(np.median(list(norms.values())))
    return [k for k in grad1 if norms[k] >= compare.SKIP_GRAD * median]


def own_state_numbers(s: Dict[str, Any], ctx: Run,
                      program: Dict[str, Any]) -> Dict[str, float]:
    """The first gradient of each group that a WGAN step updates after
    another (the critic) against the reference's at the program's own
    state before that update, with the same batch and draws
    (``reference/adversarial.py::first_gradients``): ``grad1_own_rel``
    and ``grad1_own_dir_med``, as ``grad1_rel`` and ``grad1_dir_med`` take
    them.  The generator's update before it sends the two trajectories
    apart (Adam's first step moves every weight by the learning rate in
    the sign of its gradient, so a gradient that rounding turns over moves
    its weight the other way), and the critic's gradient at a state so
    moved is another; on the program's own state only the critic's own
    pass is compared."""
    x = s["pool"]["x"][torch.as_tensor(s["first_rows"][0],
                                       device=ctx.device).long()]
    later = GROUPS[1:]  # the first group's own state is the initial one
    with float32_products():
        own = A.first_gradients(
            s["ref"], ctx.config, {g: program["before"][g] for g in later},
            x, _streams(ctx, s["stream_seed"]))
    out = {}
    for g in later:
        keys = _moved(own[g])
        out[f"{g}.grad1_own_rel"] = compare.worst_leaf_gap(
            program["grad1"].get(g, {}), own[g], keys)
        out[f"{g}.grad1_own_dir_med"] = float(np.median(
            compare.leaf_misalignments(program["grad1"].get(g, {}), own[g],
                                       keys)))
    return out


def reference_numbers(s: Dict[str, Any], ctx: Run,
                      program: Dict[str, Any]) -> Dict[str, float]:
    return {**group_numbers(program, reference_steps(s, ctx), s["params"]),
            **own_state_numbers(s, ctx, program)}


def run(ctx: Run) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """One run: set-up, the window (or the traced window), the check."""
    s = setup(ctx)
    setup_s = ctx.setup_seconds()
    rec = traced(s, ctx) if ctx.trace else window(s, ctx)
    rec.update(kind="train", mix="wgan_train", setup_s=setup_s,
               slices_per_unit=s["config"].batchsize)
    if ctx.device.type == "cuda":
        rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
            ctx.device))
    T.free_program(s, ctx.device)
    if ctx.trace:
        rec["flops_per_unit"] = step_flops(s, ctx)
    return rec, reference_numbers(s, ctx, s["first"].steps())


def control(ctx: Run) -> Dict[str, float]:
    """The compared numbers of the control, the float8 reference's first
    steps, against the reference."""
    s = setup(ctx)
    T.free_program(s, ctx.device)
    return reference_numbers(s, ctx, reference_steps(s, ctx, "fp8"))
