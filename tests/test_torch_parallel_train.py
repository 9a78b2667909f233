"""The port's data-parallel training and evaluation at world size 2 on the
CPU over gloo, against one process and the JAX package's mesh.

Float32, 32x32, batch 8.  Two ranks (``_torch_parallel_worker.py``, task
``train``) run, each on its 4 rows of the batch: one step of ``AE`` (from
the JAX package's initial state carried across by ``models/convert.py``),
``AAE`` (the ``autograd.grad`` path, critic updates cut to 2), ``GMVAE``
and ``VAE`` (dropout and eps on: every draw is made for the whole batch and
cut to the rank's rows), a ``VAE_You`` restoration of a stack of 3
volumes, a one-epoch ``fit`` and an ``evaluate()`` of the lesioned cohort.
This process computes the same on one process while they run, and JAX's
``AE`` step on its 8-device CPU mesh (``tests/test_parallel.py``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as worker
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    Config as JaxConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    MeshConfig as JaxMeshConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    get_trainer as jax_get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
    Config,
    Options,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.synthetic import (
    SYNTH,
    SyntheticOptions,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate import (
    evaluate,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.convert import (
    adam_state_from_optax,
    params_from_flax,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)

TOL = dict(rtol=1e-5, atol=1e-5)
SIZE = dict(outputWidth=32, outputHeight=32, batchsize=8,
            compute_dtype="float32")
CONFIGS = {
    "AE": Config(trainer="AE", model="autoencoder", zDim=16, dropout_rate=0.0,
                 **SIZE),
    "AAE": Config(trainer="AAE", model="adversarial_autoencoder", zDim=16,
                  intermediateResolutions=(16, 16), dropout_rate=0.2,
                  **SIZE),
    "GMVAE": Config(trainer="GMVAE",
                    model="gaussian_mixture_variational_autoencoder",
                    dim_c=3, dim_z=16, dim_w=1, **SIZE),
    "VAE": Config(trainer="VAE", model="variational_autoencoder", zDim=16,
                  dropout_rate=0.2, **SIZE),
    "VAE_You": Config(trainer="VAE_You", model="variational_autoencoder",
                      zDim=16, restore_steps=2, tv_lambda=0.5,
                      dropout_rate=0.2, **SIZE),
}
AAE_D_ITERS = 2
SWEEP_BATCHES = 3  # 20 lambdas x 3 batches of 2 slices: 60 restorations
KINK_FRACTION = 1e-4
FREE_RUN_RTOL = 1e-3
TRAIN_DS = dict(numPatients=3, imageSize=32, numSlices=12, targetSize=32)
EVAL_DS = dict(numPatients=4, imageSize=32, numSlices=12, targetSize=32,
               withLesions=True, seed=99,
               partition={"TRAIN": 0.0, "VAL": 0.5, "TEST": 0.5})
EVAL_KEYS = ("bestDiceScore", "bestThreshold", "diff_AUC", "diff_AUPRC",
             "DiceScore", "TP", "FP", "TN", "FN", "TPCC", "FPCC", "FNCC")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, (8, 32, 32, 1)).astype(np.float32))


def _eval_state():
    """AE weights with randomised BatchNorm statistics: init weights, and
    running means ~ N(0, 0.3), variances ~ U[0.5, 2]."""
    tr = get_trainer("AE")(CONFIGS["AE"], device="cpu")
    tr.init_state()
    rng = np.random.default_rng(0)
    sd = tr.model.state_dict()
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = torch.from_numpy(rng.normal(
                0, 0.3, v.shape).astype(np.float32))
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(
                0.5, 2.0, v.shape).astype(np.float32))
    return sd


def _options():
    return dict(erosionIterations=3, exportPNGs=False, exportVolumes=False)


def _jax_ae():
    """JAX's AE step on its 8-device CPU mesh from its initial state; the
    port's copy of that state, and the JAX state after the step."""
    jcfg = JaxConfig.from_json(CONFIGS["AE"].to_json())
    ctx8 = jax_make_mesh(JaxMeshConfig(data=8, model=1), jax.devices()[:8])
    jt = jax_get_trainer("AE")(jcfg, mesh=ctx8)
    js = jt.init_state()
    tt = get_trainer("AE")(CONFIGS["AE"], device="cpu")
    start = params_from_flax(jax.device_get(js.params),
                             jax.device_get(js.batch_stats), tt.model)
    step = jax.jit(jt._build_train_step())
    js, jm = step(js, ctx8.shard_batch({"x": jnp.asarray(_batch(0).numpy())}))
    return start, js, float(jm["loss"])


def _one_process(name, spec):
    cfg = CONFIGS[name]
    tr = get_trainer(cfg.trainer)(cfg, device="cpu")
    tr.init_state()
    if "state_dict" in spec:
        tr.model.load_state_dict(spec["state_dict"])
    if "d_iters" in spec:
        tr.d_iters = spec["d_iters"]
    metrics = tr.train_step({"x": spec["x"]})
    return {"metrics": metrics, "state": worker.trainer_state(tr), "tr": tr}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' outputs, and this process's references computed
    while they run."""
    d = tmp_path_factory.mktemp("dp2")
    start, jstate, jloss = _jax_ae()
    vols = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (3, 4, 32, 32, 1)).astype(np.float32))
    inputs = {
        "AE": {"config": CONFIGS["AE"].to_json(), "x": _batch(0),
               "state_dict": start},
        "AAE": {"config": CONFIGS["AAE"].to_json(), "x": _batch(1),
                "d_iters": AAE_D_ITERS},
        "GMVAE": {"config": CONFIGS["GMVAE"].to_json(), "x": _batch(2)},
        "VAE": {"config": CONFIGS["VAE"].to_json(), "x": _batch(3)},
        "VAE_You": {"config": CONFIGS["VAE_You"].to_json(), "vols": vols,
                    "counts": [4, 3, 2], "sweep_x": _batch(5)[:6],
                    "sweep_batches": SWEEP_BATCHES},
        "evaluate": {"config": CONFIGS["AE"].replace(
            numEpochs=1, dropout_rate=0.2).to_json(),
            "workdir": str(d / "wd"), "train_ds": TRAIN_DS,
            "eval_ds": EVAL_DS, "eval_state": _eval_state(),
            "options": _options(), "sample_dir": str(d / "samples"),
            "keys": EVAL_KEYS},
    }
    procs = worker.spawn("train", 2, d, inputs)
    try:
        refs = {name: _one_process(name, inputs[name])
                for name in ("AE", "AAE", "GMVAE", "VAE")}
        you = get_trainer("VAE_You")(CONFIGS["VAE_You"], device="cpu")
        you.init_state()
        refs["VAE_You"] = you.reconstruct_volumes_device(
            vols, generators=[torch.Generator().manual_seed(10 + k)
                              for k in range(3)],
            counts=[4, 3, 2])["reconstruction"]
        refs["sweep"] = you.lambda_sweep_errors(
            _batch(5)[:6], torch.arange(20, dtype=torch.float32) / 10.0,
            SWEEP_BATCHES)
        spec = inputs["evaluate"]
        cfg = Config.from_json(spec["config"])
        tr = get_trainer("AE")(cfg, device="cpu", workdir=str(d / "wd1"))
        tr.fit(SYNTH(SyntheticOptions(**TRAIN_DS)))
        refs["fit"] = {"history": tr.history,
                       "state": worker.trainer_state(tr)}
        tr = get_trainer("AE")(cfg, device="cpu")
        tr.model.load_state_dict(spec["eval_state"])
        opts = Options(**_options())
        opts.paths.sample_dir = str(d / "samples1")
        refs["evaluate"] = evaluate(SYNTH(SyntheticOptions(**EVAL_DS)), tr,
                                    opts, cfg)
    finally:
        outs = worker.collect(procs, d)
    return d, outs, refs, (jstate, jloss)


def _adam_step_bound(t, b1, b2):
    """Largest |m_hat / sqrt(v_hat)| of Adam's t-th step over all gradient
    histories (Cauchy-Schwarz over the two moment weights): the most an
    element can move, in units of lr."""
    i = np.arange(1, t + 1)
    a = (1 - b1) * b1 ** (t - i) / (1 - b1 ** t)
    w = (1 - b2) * b2 ** (t - i) / (1 - b2 ** t)
    return float(np.sqrt(np.sum(a * a / w)))


def _assert_step_states(got, want, name, what):
    """A state after trainer ``name``'s step against another, both from the
    same start state and the same batch, the gradients summed in another
    order.

    BatchNorm statistics agree within ``BUFFER_ATOL[name]``.  Adam moments
    agree within ``ROUNDOFF[name]`` of their optimizer's largest moment:
    the gradients' float32 round-off is relative to the whole gradient's
    scale, and BatchNorm's backward, which subtracts each channel's mean
    gradient, raises it where that mean nearly cancels.  Parameters: an element
    whose gradient is at that round-off level (the biases of the
    convolutions and dense layers that feed a BatchNorm, which cancels
    their true gradient) takes a step of either sign, so every element is
    held to twice the most Adam can move it in the step's updates; the
    others agree within 1e-5, except at most KINK_FRACTION of them (a
    (Leaky)ReLU input within round-off of 0 takes the other slope in one
    of the two)."""
    assert set(got) == set(want), what
    lr, (b1, b2), steps = CONFIGS[name].learningrate, BETAS[name], STEPS[name]
    roundoff = ROUNDOFF[name]
    bound = sum(2 * lr * _adam_step_bound(t, b1, b2)
                for t in range(1, steps + 1)) + 1e-6
    scale = {}
    for k, v in want.items():
        if k.endswith(("exp_avg", "exp_avg_sq")):
            key = (k.split(".")[0], k.rsplit(".", 1)[1])
            scale[key] = max(scale.get(key, 0.0), float(v.abs().max()))
    noise = {}  # parameter name -> elements at the gradient's round-off
    for k, v in want.items():
        if k.endswith(".exp_avg"):
            param = "model." + k.split(".", 1)[1].rsplit(".", 1)[0]
            level = roundoff * scale[(k.split(".")[0], "exp_avg")]
            noise[param] = noise.get(param, False) | (v.abs() <= level)
    off = total = 0
    for k in sorted(want):
        g, w = got[k], want[k]
        if not w.is_floating_point():
            assert torch.equal(g, w), f"{what}: {k}"
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=k,
                                       rtol=1e-5, atol=BUFFER_ATOL[name])
            continue
        diff = (g - w).abs()
        if k.endswith(("exp_avg", "exp_avg_sq")):
            atol = roundoff * scale[(k.split(".")[0], k.rsplit(".", 1)[1])]
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=atol, err_msg=f"{what}: {k}")
            continue
        np.testing.assert_array_less(diff.numpy(), bound,
                                     err_msg=f"{what}: {k}")
        beyond = diff > TOL["atol"]
        if k in noise:
            beyond &= ~noise[k]
        off += int(beyond.sum())
        total += diff.numel()
    assert off <= KINK_FRACTION * total, (
        f"{what}: {off} of {total} parameter elements beyond 1e-5")


def _assert_ranks_equal(outs, key):
    """Data-parallel replicas stay identical: every rank's state after the
    step is bit-equal to rank 0's."""
    for out in outs[1:]:
        for k, v in outs[0][key]["state"].items():
            assert torch.equal(out[key]["state"][k], v), k


# the metrics' tolerance; the AAE's critic and generator losses and the
# GMVAE's read a state already moved by earlier substeps or are sums of
# four terms of different scale (rtol 1e-4, as the JAX package's own
# mesh tests hold them)
METRIC_RTOL = {"AE": 1e-5, "AAE": 1e-4, "GMVAE": 1e-4, "VAE": 1e-5}
# Adam updates a parameter can take in the step (an AAE encoder weight:
# ae_iters = d_iters AE updates and the generator's), and their betas
STEPS = {"AE": 1, "AAE": 2 * AAE_D_ITERS + 1, "GMVAE": 1, "VAE": 1}
BETAS = {"AE": (0.5, 0.999), "AAE": (0.5, 0.9), "GMVAE": (0.5, 0.999),
         "VAE": (0.5, 0.999)}
# the moments' tolerance, a fraction of the optimizer's largest moment: the
# same one-process step at 1, 3 and 8 torch threads differs by up to
# 1.1e-4 (VAE) and 2.6e-4 (GMVAE) of it on this suite's CPU
ROUNDOFF = {"AE": 1e-5, "AAE": 1e-3, "GMVAE": 1e-3, "VAE": 1e-3}
# BatchNorm statistics: 1e-5, but an AAE step moves them in each of its 5
# substeps, 4 of them after updates whose steps may differ by the Adam bound
BUFFER_ATOL = {"AE": 1e-5, "AAE": 1e-4, "GMVAE": 1e-5, "VAE": 1e-5}


@pytest.mark.parametrize("name", ["AE", "AAE", "GMVAE", "VAE"])
def test_step_at_world_2_equals_one_process(runs, name):
    """Every metric (the group's mean) and the state after the step on
    each rank against one process's step on the whole batch
    (``_assert_step_states``); the two ranks' states are bit-equal."""
    _, outs, refs, _ = runs
    ref = refs[name]
    _assert_ranks_equal(outs, name)
    out = outs[0][name]
    assert set(out["metrics"]) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(float(out["metrics"][k]), float(v),
                                   rtol=METRIC_RTOL[name], err_msg=k)
    _assert_step_states(out["state"], ref["state"], name, name)


def test_ae_step_at_world_2_equals_jax_mesh_step(runs):
    """The world-2 AE step against the JAX package's 8-device mesh step
    from the same state: loss within 1e-5, and parameters, BatchNorm
    statistics (``params_from_flax`` of JAX's state) and Adam moments
    (``adam_state_from_optax``) by ``_assert_step_states``."""
    _, outs, refs, (jstate, jloss) = runs
    tr = refs["AE"]["tr"]
    want = {f"model.{k}": v for k, v in params_from_flax(
        jax.device_get(jstate.params), jax.device_get(jstate.batch_stats),
        tr.model).items() if not k.endswith("num_batches_tracked")}
    names = [n for n, _ in tr.model.named_parameters()]
    sd = adam_state_from_optax(jax.device_get(jstate.opt_states["main"]),
                               tr.model, tr.optimizer)
    for i, n in enumerate(names):
        for k in ("exp_avg", "exp_avg_sq"):
            want[f"main.{n}.{k}"] = sd["state"][i][k]
    np.testing.assert_allclose(float(outs[0]["AE"]["metrics"]["loss"]),
                               jloss, rtol=1e-5)
    got = {k: v for k, v in outs[0]["AE"]["state"].items()
           if not k.endswith("num_batches_tracked")}
    _assert_step_states(got, want, "AE", "AE vs JAX")


def test_vae_you_batched_restoration_at_world_2_equals_one_process(runs):
    """3 volumes (4, 3 and 2 real slices of 4) padded to 4 over 2 ranks,
    each restored with its own generator: equal to one process."""
    _, outs, refs, _ = runs
    for out in outs:
        assert out["VAE_You"].shape == (3, 4, 32, 32, 1)
        np.testing.assert_allclose(out["VAE_You"].numpy(),
                                   refs["VAE_You"].numpy(), **TOL)


def test_lambda_sweep_at_world_2_equals_one_process(runs):
    """``lambda_sweep_errors`` with its 60 (lambda, batch) restorations
    split 30 + 30 over the ranks: the errors of one process (each pair
    draws from its own generator seeded 0, whichever rank restores it)."""
    _, outs, refs, _ = runs
    for out in outs:
        np.testing.assert_allclose(out["sweep"].numpy(),
                                   refs["sweep"].numpy(), **TOL)


def test_fit_at_world_2_equals_one_process(runs):
    """One epoch of ``fit`` (3 TRAIN batches with dropout, VAL, a
    checkpoint): the two ranks end bit-equal, their history (the group's
    means) equals one process's within the free-running tolerance (float32
    trajectories part at BatchNorm-cancelled biases and kinks after the
    first step), and rank 0 alone wrote the workdir, with the files one
    process writes."""
    d, outs, refs, _ = runs
    for out in outs[1:]:
        assert out["evaluate"]["history"] == outs[0]["evaluate"]["history"]
        for k, v in outs[0]["evaluate"]["state"].items():
            assert torch.equal(out["evaluate"]["state"][k], v), k
    hist, ref = outs[0]["evaluate"]["history"], refs["fit"]["history"]
    assert [h["phase"] for h in hist] == [h["phase"] for h in ref]
    for h, r in zip(hist, ref):
        for k, v in r.items():
            if k not in ("epoch", "phase"):
                np.testing.assert_allclose(h[k], v, rtol=FREE_RUN_RTOL,
                                           err_msg=k)
    assert sorted(os.listdir(d / "wd" / "torch" / "ckpt")) == [
        "epoch_000001.pt"]
    assert sorted(os.listdir(d / "wd")) == sorted(os.listdir(d / "wd1"))


def test_streamed_fit_at_world_2_equals_resident(runs):
    """The pool streamed from the host in chunks of 2 batches, each rank
    uploading its columns of the chunk: the same history and state as the
    resident pool, bit for bit."""
    _, outs, _, _ = runs
    for out in outs:
        got, want = out["evaluate"]["streamed"], out["evaluate"]
        assert got["streamed"]
        assert got["history"] == want["history"]
        for k, v in want["state"].items():
            assert torch.equal(got["state"][k], v), k


def test_evaluate_at_world_2_equals_one_process(runs):
    """``evaluate()`` with the slices of each volume split over 2 ranks:
    every metric on every rank equals one process's at rtol 1e-5, and the
    residuals within 1e-5; one set of artifacts is written."""
    d, outs, refs, _ = runs
    for rank, out in enumerate(outs):
        for k in EVAL_KEYS:
            np.testing.assert_allclose(out["evaluate"]["metrics"][k],
                                       refs["evaluate"][k], rtol=1e-5,
                                       err_msg=f"rank {rank} {k}")
        np.testing.assert_allclose(out["evaluate"]["diffs"].numpy(),
                                   refs["evaluate"]["diffs"], atol=1e-5)
    found = [p for p, _, names in os.walk(d / "samples")
             if "evalPC.json" in names]
    assert len(found) == 1
