"""The adversarial trainers with the fast profile (the space-to-depth stem
and the depth-to-space head) against the JAX package on the CPU in
float32, and the fast profile's quality spread.

* Where each model's two fast parameters sit: the same optimizer group in
  both packages (the port's groups are predicates on parameter names, the
  JAX package's are the masks of its optax states).
* One batch of each schedule, ``AAE`` (``ae``, ``disc``, ``gen``),
  ``fAnoGAN``'s WGAN phase (``gen``, ``disc``) and encoder phase
  (``enc``), and ``AnoVAEGAN`` (``vae``, ``gen``, ``disc``), from the JAX
  package's state (parameters, BatchNorm statistics and every group's Adam
  moments, converted) with the draws given as ``tools/one_start_epoch.py``
  gives them: the losses within 1e-5 relative, every parameter and running
  statistic within twice Adam's largest steps and at most KINK_FRACTION of
  the elements beyond 1e-5 (the BatchNorm-fed biases and the image
  critic's output bias, whose true gradient is zero, to the Adam bound
  only), and each group's update count.  The critics run ``d_iters`` = 2
  in both packages (the class attributes), so that a batch takes seconds;
  ``AAE`` runs a batch past epoch 5 (one AE update) and one up to epoch 5
  (``d_iters`` AE updates).  Where the port's batch falls outside these
  bounds, the one ReLU or LeakyReLU pre-activation of the batch nearest
  zero must lie within float32's rounding of it (below 2^-23 of its
  tensor's largest), so that float32 does not define its side, and the
  port's batch with that one element on the other side of its kink must
  hold every bound.  The 2-AE-update ``AAE`` batch needs it: the decoder's
  input ReLU at a pre-activation of 3.9e-8 in the second AE update takes
  the other side in the JAX package, which moves a row of ``dec_dense`` by
  up to 2e-5 and the generator loss by 2.9e-5 relative; with it flipped
  the batch holds (``pytest -s`` prints both).
* One epoch of ``AAE``, ``fAnoGAN`` and ``AnoVAEGAN`` from one start with
  both options (``tools/one_start_epoch.py``): every TRAIN and VAL loss
  within EPOCH_RTOL and equal update counts.
* The quality spread: the port's H100 ``--tpu-fast`` rows of the three
  presets, and the port's own seed-42 ``--tpu-fast`` run on the CPU, lie
  inside the JAX package's fast spread over five seeds
  (``scoreboards/jax_cpu_seeds_fast.json``, ``tools/seed_spread.py``),
  widened by the tables' tolerances (``run_all.tolerance_band``, which
  phase 9n of ``chip_smoke.py`` holds the card's five seeds to).
"""

import contextlib
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_run_all import EPOCH_RTOL, JAX_TABLE, TABLES
from test_torch_train import _adam_step_bound, _bn_fed_biases
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    Config as JaxConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    gan as jax_gan,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    get_trainer as jax_get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch import run_all
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import preset
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.convert import (
    _find_adam_state,
    adam_state_from_optax,
    params_from_flax,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import gan
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST_SEEDS = os.path.join(run_all.SCOREBOARDS, "jax_cpu_seeds_fast.json")
FAST = dict(spaceToDepthStem=True, depthToSpaceHead=True)
PRESETS = ("AAE", "fAnoGAN", "AnoVAEGAN")
# the intermediate resolutions of tests/test_torch_s2d.py's MODELS
RESOLUTIONS = {"AAE": (16, 16), "fAnoGAN": (16, 16), "AnoVAEGAN": (8, 8)}
B = 4
LR = 5e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
KINK_FRACTION = 1e-4
D_ITERS = 2
# each model's fast parameters and the groups they belong to (prefix of a
# parameter's name -> groups)
FAST_GROUPS = {
    "AAE": {"encoder.enc_conv_0_s2d.": {"ae", "gen"},
            "decoder.dec_conv_d2s_head.": {"ae"}},
    "fAnoGAN": {"encoder.enc_conv_0_s2d.": {"enc"},
                "generator.dec_conv_d2s_head.": {"gen"},
                "disc_features.enc_conv_0_s2d.": {"disc"}},
    "AnoVAEGAN": {"encoder.enc_conv_0_s2d.": {"vae"},
                  "generator.dec_conv_d2s_head.": {"vae", "gen"},
                  "disc_features.enc_conv_0_s2d.": {"disc"}},
}
SCHEDULES = {
    # preset, the JAX warm-up batches' step arguments, the compared batch's,
    # the port's epoch for it (AAE past epoch 5: one AE update a batch; up
    # to epoch 5: d_iters)
    "AAE": ("AAE", ({"ae_iters": D_ITERS},) * 2, {"ae_iters": 1}, 6),
    "AAE_two_ae_updates": ("AAE", ({"ae_iters": D_ITERS},) * 2,
                           {"ae_iters": D_ITERS}, 1),
    "fAnoGAN_wgan": ("fAnoGAN", ({"phase2": False},) * 2, {"phase2": False},
                     0),
    "fAnoGAN_encoder": ("fAnoGAN", ({"phase2": False},) * 2
                        + ({"phase2": True},) * 2, {"phase2": True}, 1),
    "AnoVAEGAN": ("AnoVAEGAN", ({},) * 2, {}, 0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker process: the suite runs several."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_tool(name, folder="tools"):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, folder, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cfg(name, **kw):
    return preset(name, outputWidth=32, outputHeight=32, zDim=16,
                  intermediateResolutions=RESOLUTIONS[name],
                  compute_dtype="float32", dropout_rate=0.0, batchsize=B,
                  learningrate=LR, numEpochs=1, **FAST, **kw)


def _pair(name):
    """A JAX trainer with its initial state and the port's trainer."""
    cfg = _cfg(name)
    jt = jax_get_trainer(cfg.trainer)(JaxConfig.from_json(cfg.to_json()))
    js = jt.init_state()
    tt = get_trainer(cfg.trainer)(cfg, device="cpu")
    tt.init_state()
    return cfg, jt, js, tt


def _jax_groups(js, model):
    """The parameters each JAX optimizer group updates: the leaves of its
    Adam moments (a masked state holds its group's leaves only)."""
    return {g: set(params_from_flax(_find_adam_state(s).mu, {}, model))
            for g, s in jax.device_get(js.opt_states).items()}


def _x(seed):
    return np.random.default_rng(seed).uniform(
        size=(B, 32, 32, 1)).astype(np.float32)


# ---------------------------------------------------------------------------
# the optimizer groups


@pytest.mark.parametrize("name", PRESETS)
def test_fast_parameters_sit_in_the_same_group_in_both_packages(name):
    """Every group holds the parameters of JAX's group of that name, and
    the stem's and the head's weights and biases sit in the groups
    FAST_GROUPS names, in both packages."""
    _, _, js, tt = _pair(name)
    jax_groups = _jax_groups(js, tt.model)
    assert sorted(tt.groups) == sorted(jax_groups)
    for group, names in tt.groups.items():
        assert set(names) == jax_groups[group], group
    for prefix, want in FAST_GROUPS[name].items():
        params = [n for n in dict(tt.model.named_parameters())
                  if n.startswith(prefix)]
        assert sorted(params) == [prefix + "bias", prefix + "weight"]
        for n in params:
            assert {g for g, ns in tt.groups.items() if n in ns} == want, n
            assert {g for g, ns in jax_groups.items() if n in ns} == want, n


# ---------------------------------------------------------------------------
# one batch of each schedule


def _load(tt, js):
    tt.model.load_state_dict(params_from_flax(
        jax.device_get(js.params), jax.device_get(js.batch_stats), tt.model))
    opt_states = jax.device_get(js.opt_states)
    for g in tt.groups:
        tt.optimizer[g].load_state_dict(adam_state_from_optax(
            opt_states[g], tt.model, tt.optimizer[g]))


def _bounds(tt, cfg, before, after):
    """Per tensor, twice the sum of Adam's largest steps over the updates
    its groups took in the batch (+ float32 rounding); a running
    statistic gets the largest parameter bound."""
    steps = {g: sum(_adam_step_bound(t, cfg.beta1, cfg.beta2)
                    for t in range(before[g] + 1, after[g] + 1))
             for g in before}
    out = {n: 2 * cfg.learningrate * sum(steps[g] for g, names in
                                         tt.groups.items() if n in names)
           + 1e-6 for n, _ in tt.model.named_parameters()}
    return out, max(out.values())


@contextlib.contextmanager
def _kinks(record=None, flip=None):
    """The port's ReLUs and LeakyReLUs in call order: ``record`` (a list)
    gets each call's pre-activation; ``flip`` = (call, element) takes that
    one element to the other side of its kink, in value and derivative."""
    relu, leaky = F.relu, F.leaky_relu
    calls = []

    def side(x):
        calls.append(None)
        if record is not None:
            record.append(x.detach().clone())
        if flip is None or flip[0] != len(calls) - 1:
            return None
        mask = (x > 0).contiguous()
        mask.view(-1)[flip[1]] ^= True
        return mask

    def relu_(x, inplace=False):
        mask = side(x)
        return relu(x) if mask is None else torch.where(mask, x, 0 * x)

    def leaky_relu_(x, negative_slope=0.01, inplace=False):
        mask = side(x)
        return (leaky(x, negative_slope) if mask is None
                else torch.where(mask, x, negative_slope * x))

    F.relu, F.leaky_relu = relu_, leaky_relu_
    try:
        yield
    finally:
        F.relu, F.leaky_relu = relu, leaky


def _nearest_zero(pre):
    """(call, element, |pre-activation| over its tensor's largest,
    |pre-activation|) of the recorded pre-activation nearest zero."""
    best = None
    for call, v in enumerate(pre):
        a = v.abs().flatten()
        element = int(a.argmin())
        rel = float(a[element]) / float(a.max())
        if best is None or rel < best[2]:
            best = (call, element, rel, float(a[element]))
    return best


def _faults(tm, jm, got, want, bound, stat_bound):
    """What holds the port's batch against JAX's, as the batch test's
    docstring says: the faults, each loss's relative difference and the
    largest parameter difference outside the free biases."""
    faults, rel, worst = [], {}, (None, 0.0)
    if set(tm) != set(jm):
        return [f"metrics {sorted(tm)} vs {sorted(jm)}"], rel, worst
    for k in jm:
        t, j = float(tm[k]), float(jm[k])
        rel[k] = abs(t - j) / abs(j) if j else abs(t - j)
        if not abs(t - j) <= 1e-6 + LOSS_RTOL * abs(j):
            faults.append(f"{k}: {t} vs {j}")
    free = _bn_fed_biases(want) | {"disc_dense.bias"}
    off = total = 0
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):  # Flax keeps no count
            continue
        diff = (got[k] - v).abs()
        if not float(diff.max()) < bound.get(k, stat_bound):
            faults.append(f"{k}: max|diff| {float(diff.max())}")
        if k not in free:
            off += int((diff > PARAM_ATOL).sum())
            total += diff.numel()
            worst = max(worst, (k, float(diff.max())), key=lambda w: w[1])
    if off > KINK_FRACTION * total:
        faults.append(f"{off} of {total} elements beyond {PARAM_ATOL}")
    return faults, rel, worst


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_batch_with_both_options_matches_jax(schedule, monkeypatch):
    """One batch of the schedule with the stem and the head, from the JAX
    state after a few batches at lr 5e-5 (from the first state Adam moves
    every element by +-lr whatever its gradient's size, and rounding-level
    gradients take either sign), with the draws given: the metrics within
    LOSS_RTOL, every parameter and running statistic as the module
    docstring says (with the kink nearest zero on either side), each
    group's update count equal to JAX's, and every group that the schedule
    updates moved."""
    name, warmup, static, epoch = SCHEDULES[schedule]
    for cls in (gan.AAE, gan.FAnoGAN, gan.AnoVAEGAN):
        monkeypatch.setattr(cls, "d_iters", D_ITERS)
    for cls in (jax_gan.AAE, jax_gan.FAnoGAN, jax_gan.AnoVAEGAN):
        monkeypatch.setattr(cls, "d_iters", D_ITERS)
    one_start = _load_tool("one_start_epoch")
    cfg, jt, js, tt = _pair(name)
    steps = {}

    def jstep(kw):
        key = tuple(sorted(kw.items()))
        if key not in steps:
            steps[key] = jax.jit(jt._build_train_step(**kw))
        return steps[key]

    x = _x(13)

    def port(**kinks):
        _load(tt, js0)
        tt.epoch = epoch
        with _kinks(**kinks):
            metrics = tt.train_step({"x": torch.from_numpy(x)})
        return metrics, {k: v.clone() for k, v in tt.model.state_dict().items()}

    with one_start.given_draws():
        for b, kw in enumerate(warmup):
            js, _ = jstep(kw)(js, {"x": jnp.asarray(_x(100 + b))})
        js0 = js
        _load(tt, js0)
        before = one_start._port_counts(tt.optimizer)
        assert before == one_start._jax_counts(jax.device_get(js.opt_states))
        start = {k: v.clone() for k, v in tt.model.state_dict().items()}
        js, jm = jstep(static)(js, {"x": jnp.asarray(x)})
        pre = []
        tm, got = port(record=pre)
        after = one_start._port_counts(tt.optimizer)
        assert after == one_start._jax_counts(jax.device_get(js.opt_states))
        want = params_from_flax(jax.device_get(js.params),
                                jax.device_get(js.batch_stats), tt.model)
        bound, stat_bound = _bounds(tt, cfg, before, after)
        faults, rel, worst = _faults(tm, jm, got, want, bound, stat_bound)
        print(f"[{schedule}] losses relative to JAX: {rel}; largest "
              f"parameter difference {worst}; {faults}")
        if faults:
            call, element, size, value = _nearest_zero(pre)
            assert size < float(np.finfo(np.float32).eps), (faults, size)
            tm, got = port(flip=(call, element))
            flipped, rel, worst = _faults(tm, jm, got, want, bound,
                                          stat_bound)
            print(f"[{schedule}] kink {call} (of {len(pre)}, shape "
                  f"{tuple(pre[call].shape)}) element {element}, "
                  f"pre-activation {value:.2e} ({size:.2e} of its tensor's "
                  f"largest), on its other side: losses relative to JAX "
                  f"{rel}; largest parameter difference {worst}; {flipped}")
            assert not flipped, (faults, flipped)
    moved = {g for g, names in tt.groups.items()
             if any(not torch.equal(got[n], start[n]) for n in names)}
    assert moved == {g for g in after if after[g] > before[g]}
    assert moved == {"AAE": {"ae", "disc", "gen"},
                     "AAE_two_ae_updates": {"ae", "disc", "gen"},
                     "fAnoGAN_wgan": {"gen", "disc"},
                     "fAnoGAN_encoder": {"enc"},
                     "AnoVAEGAN": {"vae", "gen", "disc"}}[schedule]


# ---------------------------------------------------------------------------
# one epoch from one start


@pytest.mark.parametrize("name", PRESETS)
def test_one_epoch_with_both_options_from_one_start_matches_jax(name):
    """One epoch at the quality recipe's widths (32x32, zDim 16, batch 8,
    float32; the CLI's healthy cohort cut to 6 phantoms) with the stem and
    the head, from the JAX init with dropout 0 and the draws given: every
    TRAIN and VAL loss within EPOCH_RTOL, and the same number of updates
    of each optimizer group."""
    one_start = _load_tool("one_start_epoch")
    out = one_start.one_epoch(name, patients=6, overrides=one_start.FAST)
    assert [(h["epoch"], h["phase"]) for h in out["port"]] == [
        (h["epoch"], h["phase"]) for h in out["jax"]]
    assert len(out["jax"]) >= 2
    for want, got in zip(out["jax"], out["port"]):
        assert set(got) == set(want)
        for key, value in want.items():
            if key not in ("epoch", "phase"):
                np.testing.assert_allclose(
                    got[key], value, rtol=EPOCH_RTOL, atol=1e-6,
                    err_msg=f"{name} {want['phase']} {key}")
    assert out["port_updates"] == out["jax_updates"]


# ---------------------------------------------------------------------------
# the fast profile's quality spread


def _fast_spread():
    with open(FAST_SEEDS) as f:
        return json.load(f)


def _assert_inside(row, name, what):
    spread = _fast_spread()["presets"][name]
    with open(TABLES["expected_h100_fast"]) as f:
        tolerances = json.load(f)["tolerances"]
    checked = 0
    for key in run_all.METRIC_KEYS:
        if spread[key] is None:
            assert key == "finalTrainLoss" and row.get(key) is None
            continue
        lo, hi = run_all.tolerance_band(spread[key]["min"],
                                        spread[key]["max"], key, tolerances)
        assert lo <= row[key] <= hi, (what, name, key, row[key], (lo, hi))
        checked += 1
    assert checked >= 3


def test_jax_fast_seed_spread_file():
    """The JAX package's ``--tpu-fast`` spread at the tables' recipe: the
    three presets, five seeds each, min <= median <= max, recorded with
    the fast flag."""
    seeds = _fast_spread()
    with open(JAX_TABLE) as f:
        jax_table = json.load(f)
    assert seeds["package"] == "jax" and seeds["commit"]
    assert seeds["recipe"][-1] == "--tpu-fast"
    assert (run_all._comparable_settings(seeds["recipe"][:-1])
            == run_all._comparable_settings(jax_table["settings"]))
    assert sorted(seeds["presets"]) == sorted(PRESETS)
    for name, row in seeds["presets"].items():
        assert sorted(row["seeds"]) == [1, 2, 3, 4, 42], name
        for key in run_all.METRIC_KEYS:
            if row[key] is None:
                assert key == "finalTrainLoss" and name == "fAnoGAN"
                continue
            assert row[key]["min"] <= row[key]["median"] <= row[key]["max"]
            assert len(row[key]["values"]) == 5


@pytest.mark.parametrize("name", PRESETS)
def test_h100_fast_row_lies_inside_the_jax_fast_spread(name):
    """The port's H100 ``--tpu-fast`` table row, every metric, inside the
    JAX package's fast spread widened by the tolerances: what moves these
    presets off their parity rows is the fast architecture, in both
    packages."""
    with open(TABLES["expected_h100_fast"]) as f:
        row = json.load(f)["presets"][name]
    _assert_inside(row, name, "H100 table")


@pytest.mark.parametrize("name", PRESETS)
def test_port_cpu_fast_run_lies_inside_the_jax_fast_spread(name, tmp_path):
    """The port's seed-42 ``--tpu-fast`` run at the recipe on the CPU
    (one thread, ``tools/seed_spread.py``), every metric inside the same
    band."""
    spread = _load_tool("seed_spread")
    out = spread.run("torch", [name], [42], ["--tpu-fast"],
                     root=str(tmp_path))
    row = out["presets"][name]["42"]
    assert row["rc"] == 0
    assert out["recipe"][-1] == "--tpu-fast"
    _assert_inside(row, name, "port CPU seed 42")
