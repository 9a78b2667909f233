"""Traffic kind ``serve``: ``AnomalyDetector.detect`` on raw scans, one
client in a closed loop (the ``infer`` command's pattern: the next scan
goes as soon as the previous ``detect`` has returned its numpy results).

Set-up builds the trainer with the benchmark's weights on the card and the
detector around it, with the calibrated default options (erosion 12, the
hyperintensity prior, the 5^3 median, components of more than 7 voxels,
no MC dropout), and makes the mix's scans from the seed (BrainWeb's
geometry, ``lesions`` blobs each, in an order drawn from the seed).  The
first scan is served once to warm every shape and to set the threshold:
the value that leaves above it as many voxels of its anomaly map as the
scans' lesion share of its brain voxels (its brain's voxel count scaled
to the model's slice size).  With seeded weights the residual does not
follow the lesions; this keeps the mask, and the components' work, at a
lesion load like a real one.

The window cycles through the scans until ``--seconds`` have passed;
throughput counts the scans completed over the time to the last one's
return, and every request's latency is kept.  With ``--trace 1`` the
window is ``trace_requests`` requests under the profiler, with a span,
synchronised at both ends, around each layer ``detect`` calls.

The check takes ``compared_requests`` requests of the first cycle, each of
another scan, drawn from the seed before the window, and records for them
what the port's stages hand each other (``Recorder``): the prepared volume
that enters the reconstruction and, for a restoration, the input, the
forward's output and the gradient at ``compared_steps`` steps drawn from
the seed (step 0 among them), at the step after each and at the last.
Each stage is then judged on the port's own state: the host prep against
the reference's; the reconstruction whole (a single forward: the
reference's for the same prepared scan), or step by step (a restoration,
``STEPWISE``: the reference's forward and gradient at the port's own
input of a chosen step, with that step's eps; step 0's input is the
prepared volume; each recorded step's successor, and the reconstruction
after the last, is its input less ``restore_lr`` times its gradient); the
postprocess (the reference's map from the port's own input and
reconstruction); the scores (the map's maximum of each slice); and the
components.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from benchmark.common import compare, flops, weights
from benchmark.common.context import Run, port, port_config
from benchmark.common.device import sync
from benchmark.common.phantoms import served_scans, training_pool
from benchmark.common.spans import Spans
from benchmark.common.trace import DeviceTrace, summarize
from benchmark.reference.layers import float32_products
from benchmark.reference import backbone as B
from benchmark.reference import serving as RS

KEEP = ("anomaly_map", "scores", "mask")


def serving_generator(device: torch.device, draws: int = 0,
                      shape: Tuple[int, ...] = ()) -> torch.Generator:
    """The generator ``detect`` draws a request's noise from: seeded from
    the key (0,) through numpy's ``SeedSequence``, as the port documents
    for serving; advanced past ``draws`` normal draws of ``shape``."""
    seed = int(np.random.SeedSequence((0,)).generate_state(1, np.uint64)[0])
    gen = torch.Generator(device=device).manual_seed(seed)
    for _ in range(draws):
        torch.randn(shape, generator=gen, device=device)
    return gen


def served_statistics(ctx: Run, ref, params: Dict[str, torch.Tensor],
                      buffers: Dict[str, torch.Tensor], seed: int
                      ) -> Dict[str, torch.Tensor]:
    """The served model's BatchNorm running statistics: each layer's batch
    statistics over the slices of one healthy phantom (the reference's
    forward in training mode, without dropout), as training leaves them
    set from its data.  Untrained statistics (0, 1) would pass the
    activations unnormalised, and the reconstruction would vanish."""
    x = torch.from_numpy(training_pool(
        seed, 1, ctx.config["outputWidth"],
        int(ctx.mix["statistics_slices"]))).to(ctx.device)
    stats = dict(buffers)
    draws = {"generator": None,
             "sample_generator": torch.Generator(
                 device=ctx.device).manual_seed(seed)}
    with torch.no_grad(), float32_products():
        ref.train_loss(B.Net(params, stats, True, "float32", momentum=0.0),
                       x, ctx.config, draws)
    return stats


class Recorder:
    """While a record is open (``begin``), keeps what the port's stages
    hand each other: the input of ``eval/inference.py::
    _reconstruct_volume`` (the prepared volume) and, with ``steps``, what
    ``train/restoration.py::restoration_grads`` (looked up at every
    restoration step) sees at those steps: its input, the forward's output
    and the gradient.  Closed, it passes every call straight through."""

    def __init__(self, steps: List[int]):
        self.inference = port("eval.inference")
        self.restoration = port("train.restoration")
        self.reconstruct_volume = self.inference._reconstruct_volume
        self.restoration_grads = self.restoration.restoration_grads
        self.steps = set(steps)
        self.got = None
        self.step = 0
        self.inference._reconstruct_volume = self._reconstruct_volume
        self.restoration.restoration_grads = self._restoration_grads

    def _reconstruct_volume(self, trainer, x, *args, **kwargs):
        if self.got is not None:
            self.got["x"] = x[..., 0].detach().clone()
        return self.reconstruct_volume(trainer, x, *args, **kwargs)

    def _restoration_grads(self, outputs_fn, x, tv_lambda, generator):
        if self.got is None or self.step not in self.steps:
            self.step += 1
            return self.restoration_grads(outputs_fn, x, tv_lambda,
                                          generator)
        seen = {}

        def outputs(xi, gen):
            pixel, x_hat = outputs_fn(xi, gen)
            seen["x_hat"] = x_hat.detach().clone()
            return pixel, x_hat

        grad = self.restoration_grads(outputs, x, tv_lambda, generator)
        self.got["steps"][self.step] = (x.detach().clone(), seen["x_hat"],
                                        grad.detach().clone())
        self.step += 1
        return grad

    def begin(self) -> None:
        self.got, self.step = {"steps": {}}, 0

    def end(self) -> Dict[str, Any]:
        got, self.got = self.got, None
        return got

    def remove(self) -> None:
        self.inference._reconstruct_volume = self.reconstruct_volume
        self.restoration.restoration_grads = self.restoration_grads


def _build(ctx: Run) -> Dict[str, Any]:
    cfg, mix = ctx.config, ctx.mix
    w_seed, stream_seed, data_seed, sample_seed = ctx.seeds(4)
    config = port_config(cfg, stream_seed)
    options = port("config").Options()
    trainer = port("train.registry").get_trainer(config.trainer)(
        config, options, device=ctx.device)
    if "tv_lambda" in cfg.get("assumed", {}):
        trainer.tv_lambda_value = float(cfg["assumed"]["tv_lambda"])
    ref = ctx.reference_model()
    params, buffers = weights.initial(ref, cfg, w_seed, ctx.device)
    buffers = served_statistics(ctx, ref, params, buffers, data_seed)
    weights.load_into(trainer.model, {**params, **buffers})
    detector = port("eval.inference").AnomalyDetector(trainer, config,
                                                      options)
    ctx.mark("detector and weights")
    scans, share, brain = served_scans(data_seed, mix["shape"],
                                       mix["lesions"], mix["noise_pct"],
                                       mix["inu_pct"])
    ctx.mark("scans")
    rng = np.random.default_rng(sample_seed)
    compared = sorted(int(i) for i in rng.permutation(len(scans))[
        : int(mix["compared_requests"])])
    steps, recorded = [0], []
    if ref.STEPWISE:
        n = int(cfg["restore_steps"])
        steps += sorted(int(k) for k in 1 + rng.permutation(n - 1)[
            : int(mix["compared_steps"]) - 1])
        recorded = sorted({k + d for k in steps for d in (0, 1)
                           if k + d < n} | {n - 1})
    return {"trainer": trainer, "detector": detector, "params": params,
            "buffers": buffers, "scans": scans, "share": share,
            "brain_voxels": brain, "ref": ref, "compared": compared,
            "steps": steps, "recorded": recorded,
            "min_size": options.minLesionSize}


def lesion_load_threshold(amap: np.ndarray, brain_voxels: float,
                          share: float) -> float:
    """The value with ``round(share * brain_voxels)`` voxels of ``amap``
    above it (at least one)."""
    flat = amap.ravel()
    n = int(min(max(1, round(share * brain_voxels)), flat.size - 1))
    return float(np.partition(flat, flat.size - n - 1)[flat.size - n - 1])


def setup(ctx: Run) -> Dict[str, Any]:
    s = _build(ctx)
    first = s["detector"].detect(s["scans"][0])
    H, W, _ = s["scans"][0].shape
    size = ctx.config["outputWidth"]
    brain = s["brain_voxels"][0] * size * size / (H * W)
    s["threshold"] = lesion_load_threshold(first["anomaly_map"], brain,
                                           s["share"])
    s["detector"].threshold = s["threshold"]
    s["recorder"] = Recorder(s["recorded"])
    sync(ctx.device)
    ctx.mark("warm request and threshold")
    return s


def serve(s: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Request ``i``: the scan ``i`` mod the scans' count.  A compared
    request also keeps its reconstruction and what the recorder saw."""
    keep = i in s["compared"]
    if keep:
        s["recorder"].begin()
    out = s["detector"].detect(s["scans"][i % len(s["scans"])])
    answer = {k: out[k] for k in KEEP}
    if keep:
        answer["reconstruction"] = out["reconstruction"]
        answer.update(s["recorder"].end())
    return answer


def window(s: Dict[str, Any], ctx: Run) -> Dict[str, Any]:
    answers, latencies = [], []
    sync(ctx.device)
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    done = t0
    while time.perf_counter() < end:
        a = time.perf_counter()
        answers.append(serve(s, len(answers)))
        done = time.perf_counter()
        latencies.append(done - a)
    failed = sum(not np.isfinite(a["anomaly_map"]).all() for a in answers)
    s["answers"] = answers
    return {"window_s": done - t0, "units": len(answers),
            "latencies_s": latencies, "failed": int(failed)}


def traced(s: Dict[str, Any], ctx: Run) -> Dict[str, Any]:
    inference = port("eval.inference")
    evaluate = port("eval.evaluate")
    post = port("ops.postprocess")
    spans = Spans(sync=lambda: sync(ctx.device))
    for name in ("normalize_volume", "_zoom_volume", "_reconstruct_volume",
                 "_postprocess"):
        spans.wrap(inference, name, name)
    spans.wrap(post, "filter_small_components", "filter_small_components")
    spans.wrap(evaluate, "median_filter_3d_auto", "median",
               attrs_of=lambda vol, *a, **k: {"shape": list(vol.shape)})
    answers = []
    n = max(int(ctx.mix["trace_requests"]), max(s["compared"]) + 1)
    try:
        with DeviceTrace(ctx.device) as tr:
            for i in range(n):
                with spans.span("detect"):
                    answers.append(serve(s, i))
    finally:
        spans.restore()
    s["answers"] = answers
    records = spans.to_records()
    return {"window_s": (tr.end_ns - tr.start_ns) / 1e9,
            "units": len(answers), "failed": 0, "spans": records,
            "trace": summarize(tr.events, tr.start_ns, tr.end_ns, records)}


def request_flops(s: Dict[str, Any], ctx: Run) -> int:
    """FLOPs of the reference's reconstruction of one scan: one unit
    (a forward, or a restoration step) at the scan's slice count, times
    the units a reconstruction makes."""
    cfg = ctx.config
    S = int(ctx.mix["shape"][2])
    x = torch.zeros((S, cfg["outputWidth"], cfg["outputWidth"], 1),
                    device=ctx.device)
    unit = flops.count_flops(s["ref"].reconstruction_unit, s["params"],
                             s["buffers"], x, cfg,
                             serving_generator(ctx.device))
    return unit * s["ref"].reconstruction_units(cfg)


def _rel_l1(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().sum() / b.abs().sum().clamp_min(1e-30))


def stage_numbers(s: Dict[str, Any], ctx: Run, answer: Dict[str, Any],
                  prep: Dict[str, Any]) -> Dict[str, float]:
    """The host prep, the postprocess, the scores and the components of
    an answer, each against the reference (``prep``: its prepared scan)
    from the answer's own state."""
    x = answer["x"]
    amap = answer["anomaly_map"]
    rec = torch.from_numpy(answer["reconstruction"]).to(x.device)
    own_map = RS.postprocess(x, rec, RS.eroded_mask(x.cpu().numpy()),
                             prep["prior_q"])
    own_mask = RS.filter_components(amap > np.float32(s["threshold"]),
                                    s["min_size"])
    return {"prep_max": float(np.abs(x.cpu().numpy() - prep["x"]).max()),
            "post_own_max": float(np.abs(amap - own_map).max()),
            "score_own_map": float(np.abs(answer["scores"]
                                          - RS.slice_scores(amap)).max()),
            "mask_own_map": float((answer["mask"] != own_mask).sum())}


def whole_numbers(s: Dict[str, Any], ctx: Run, answer: Dict[str, Any],
                  prep: Dict[str, Any]) -> Dict[str, float]:
    """A single-forward reconstruction against the reference's of the
    same prepared scan."""
    x = torch.from_numpy(prep["x"]).to(ctx.device)
    rec = s["ref"].reconstruct(s["params"], s["buffers"], x[..., None],
                               ctx.config, serving_generator(ctx.device),
                               "float32")[..., 0]
    return {"rec_rel_l1": compare.rel_l1(answer["reconstruction"],
                                         rec.cpu().numpy())}


def update_numbers(ctx: Run, answer: Dict[str, Any]) -> Dict[str, float]:
    """The restoration's own chain on the port's state: ``step0_input``,
    the largest gap between step 0's input and the prepared volume;
    ``step_update``, by the worst recorded step k, the largest gap between
    the input of step k + 1 (the reconstruction after the last step) and
    x_k - restore_lr * g_k, over the largest |restore_lr * g_k|."""
    steps = answer["steps"]
    after = {k: xk for k, (xk, _, _) in steps.items()}
    n = int(ctx.config["restore_steps"])
    after[n] = torch.from_numpy(answer["reconstruction"]).to(
        after[0].device)
    lr = float(ctx.config["restore_lr"])
    gaps = []
    for k, (xk, _, gk) in steps.items():
        if k + 1 in after:
            step = lr * gk
            gap = (after[k + 1].reshape(-1) - (xk - step).reshape(-1))
            gaps.append(float(gap.abs().max()
                              / step.abs().max().clamp_min(1e-30)))
    return {"step0_input": float((after[0].reshape(-1)
                                  - answer["x"].reshape(-1)).abs().max()),
            "step_update": max(gaps)}


def step_numbers(s: Dict[str, Any], ctx: Run, answer: Dict[str, Any]
                 ) -> Dict[str, float]:
    """Each chosen restoration step against the reference's forward and
    gradient at the port's own input, with that step's eps:
    ``step_rec_rel`` (the forward's output) and ``step_grad_dir`` (1 - cos
    of the two gradients).  The gradient holds the sign of x - x_hat at
    every voxel and, through the decoder, of every voxel at each: rounding
    flips some signs in bfloat16 and more in float8, so the gaps of its
    magnitude saturate, and its direction's gap, which grows as their
    square, parts the two.  Then the chain between the recorded steps
    (``update_numbers``)."""
    cfg = ctx.config
    steps = answer["steps"]
    net = B.Net(s["params"], s["buffers"], False, "float32")
    shape = (steps[0][0].shape[0], int(cfg["zDim"]))
    rows = []
    for k in s["steps"]:
        xk, xh, gk = steps[k]
        gr, xr = s["ref"].restoration_step(
            net, xk, cfg, serving_generator(ctx.device, k, shape))
        rows.append({"step_rec_rel": _rel_l1(xh, xr),
                     "step_grad_dir": compare.misalignment(gk, gr)})
    return {**compare.worst(rows), **update_numbers(ctx, answer)}


def numbers(s: Dict[str, Any], ctx: Run, answers: Dict[int, Dict]
            ) -> Dict[str, float]:
    """The compared numbers, worst over the answers (by request index)."""
    rows = []
    k = len(s["scans"])
    with float32_products():
        for i, a in answers.items():
            scan = s["scans"][i % k]
            if "x" not in a or not np.isfinite(a["anomaly_map"]).all() or (
                    set(a["steps"]) != set(s["recorded"])):
                return {n: np.inf for n in ctx.limits}
            prep = RS.prepare(scan, ctx.config["outputWidth"])
            row = stage_numbers(s, ctx, a, prep)
            row.update(step_numbers(s, ctx, a) if s["ref"].STEPWISE
                       else whole_numbers(s, ctx, a, prep))
            rows.append(row)
    return compare.worst(rows)


def free_program(s: Dict[str, Any], device: torch.device) -> None:
    if s.get("recorder") is not None:
        s["recorder"].remove()
    s.pop("detector", None)
    s.pop("trainer", None)
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(ctx: Run) -> Tuple[Dict[str, Any], Dict[str, float]]:
    s = setup(ctx)
    setup_s = ctx.setup_seconds()
    rec = traced(s, ctx) if ctx.trace else window(s, ctx)
    rec.update(kind="serve", setup_s=setup_s)
    if ctx.device.type == "cuda":
        rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
            ctx.device))
    free_program(s, ctx.device)
    if ctx.trace:
        rec["flops_per_unit"] = request_flops(s, ctx)
    got = {i: s["answers"][i] for i in s["compared"]
           if i < len(s["answers"])}
    if len(got) < len(s["compared"]):
        rec["failed"] += len(s["compared"]) - len(got)
        return rec, {n: np.inf for n in ctx.limits}
    return rec, numbers(s, ctx, got)


def control_answer(s: Dict[str, Any], ctx: Run, i: int) -> Dict[str, Any]:
    """The reference in the program's place, one step lower: its networks
    in float8, its host stages in bfloat16."""
    capture = {"steps": set(s["recorded"]), "got": {}}
    with float32_products():
        out = RS.serve(s["ref"], ctx.config, s["params"], s["buffers"],
                       s["scans"][i], s["threshold"],
                       serving_generator(ctx.device), "fp8", s["min_size"],
                       capture if s["ref"].STEPWISE else None)
    out["steps"] = capture["got"]
    return out


def control(ctx: Run) -> Dict[str, float]:
    """The compared numbers of the control's answers to the compared
    requests against the reference."""
    s = setup(ctx)
    free_program(s, ctx.device)
    return numbers(s, ctx, {i: control_answer(s, ctx, i)
                            for i in s["compared"]})
