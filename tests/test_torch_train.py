"""The port's training against the JAX package on the CPU in float32:
losses, optimizers, BatchNorm's train-mode update, the epoch helpers, an
AE trajectory from the same init (and from a converted mid-run JAX state),
resume after a killed epoch, and the streaming slice pool."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from test_torch_oracle import (
    _dense_outputs,
    _spatial_outputs,
    torch_gmvae_dense,
    torch_gmvae_spatial,
)
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    Config,
    Optimizer,
    Options,
)
from unsupervised_anomaly_detection_brain_mri_tpu.data.synthetic import (
    SYNTH,
    SyntheticOptions,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    engine as jax_engine,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    get_trainer as jax_get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    losses as JL,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    state as jax_state,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import layers
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.convert import (
    adam_state_from_optax,
    params_from_flax,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
    engine,
    state,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
    losses as TL,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)

LOSS_TOL = dict(rtol=2e-5, atol=1e-5)  # float32 reductions, other order
BN_TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_LOSS_RTOL = 1e-5
TRAJ_PARAM_ATOL = 1e-5
KINK_FRACTION = 1e-4
OPT_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small and the suite runs in several worker
    processes: one intra-op thread per worker keeps them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(jax_val, torch_val, **tol):
    np.testing.assert_allclose(torch_val.detach().numpy(),
                               np.asarray(jax_val), **(tol or LOSS_TOL))


# ---------------------------------------------------------------------------
# losses


def _image_outputs(rng, b=4, h=16, dz=8):
    n = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {
        "x_hat": n(b, h, h, 1), "x_hat_ce": n(b, h, h, 1),
        "x_enc": n(b, h, h, 1), "z": n(b, dz), "z_rec": n(b, dz),
        "z_mu": n(b, dz), "z_sigma": np.abs(n(b, dz)) + 0.1,
        "d_enc_features": n(b, 32), "d_features": n(b, 32),
    }


LOSS_CASES = {
    "l1_recon_sum": lambda L, x, o: L.l1_recon_sum(x, o["x_hat"]),
    "l2_recon_mean": lambda L, x, o: L.l2_recon_mean(x, o["x_hat"]),
    "sum_per_sample": lambda L, x, o: L.sum_per_sample(
        L.l1_elem(x, o["x_hat"])),
    "mean_per_sample": lambda L, x, o: L.mean_per_sample(
        L.l2_elem(x, o["x_hat"])),
    "vae_kl": lambda L, x, o: L.vae_kl(o["z_mu"], o["z_sigma"]),
    "vae_loss": lambda L, x, o: L.vae_loss(x, o),
    "cevae_loss": lambda L, x, o: L.cevae_loss(x, o["x_hat"], o),
    "total_variation": lambda L, x, o: L.total_variation(x),
    "wgan_gp_latent": lambda L, x, o: L.wgan_gp_penalty_from_grads(
        o["z_mu"], 10.0),
    "wgan_gp_image": lambda L, x, o: L.wgan_gp_penalty_from_grads(x, 10.0),
    "wgan_disc_loss": lambda L, x, o: L.wgan_disc_loss(o["z_mu"], o["z"]),
    "wgan_gen_loss": lambda L, x, o: L.wgan_gen_loss(o["z"]),
    "constrained_loss": lambda L, x, o: L.constrained_loss(x, o, 0.5),
    "fanogan_enc_loss": lambda L, x, o: L.fanogan_enc_loss(x, o, 0.7),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_matches_jax(name):
    rng = np.random.default_rng(sorted(LOSS_CASES).index(name))
    out = _image_outputs(rng)
    x = rng.normal(size=out["x_hat"].shape).astype(np.float32)
    ref = LOSS_CASES[name](JL, x, out)
    got = LOSS_CASES[name](TL, _t(x), {k: _t(v) for k, v in out.items()})
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _close(ref[k], got[k])
    else:
        _close(ref, got)


@pytest.mark.parametrize("spatial", [False, True])
def test_gmvae_loss_matches_jax_and_oracle(spatial):
    rng = np.random.default_rng(10 + spatial)
    out = _spatial_outputs(rng) if spatial else _dense_outputs(rng)
    x = rng.normal(size=out["xz_mu"].shape).astype(np.float32)
    dim_c = out["pc"].shape[-1]
    ref = JL.gmvae_loss(x, out, dim_c, 0.5, spatial)
    oracle = (torch_gmvae_spatial if spatial else torch_gmvae_dense)(
        x, out, dim_c, 0.5)
    got = TL.gmvae_loss(_t(x), {k: _t(v) for k, v in out.items()}, dim_c,
                        0.5, spatial)
    assert set(got) == set(ref)
    for k in ref:
        _close(ref[k], got[k])
        _close(oracle[k].numpy(), got[k])


# ---------------------------------------------------------------------------
# optimizers


@pytest.mark.parametrize("optimizer", list(Optimizer) + ["gan_adam"])
def test_optimizer_matches_optax_over_five_steps(optimizer):
    rng = np.random.default_rng(3)
    params = {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    cfg = Config(learningrate=1e-2)
    if optimizer == "gan_adam":
        tx = jax_state.gan_adam(cfg)
    else:
        tx = jax_state.make_optimizer(cfg.replace(optimizer=optimizer))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(_t(v).clone()) for k, v in params.items()}
    names = sorted(tparams)
    plist = [tparams[k] for k in names]
    opt = (state.gan_adam(cfg, plist) if optimizer == "gan_adam"
           else state.make_optimizer(cfg.replace(optimizer=optimizer), plist))
    for g in grads:
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k in names:
            tparams[k].grad = _t(g[k]).clone()
        opt.step()
        for k in names:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), **OPT_TOL)


# ---------------------------------------------------------------------------
# BatchNorm in train mode


def test_norm_train_mode_matches_flax_batchnorm():
    x = np.random.default_rng(0).normal(size=(4, 5, 5, 3)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-3)
    variables = bn.init(jax.random.key(0), x)
    y, mutated = bn.apply(variables, x, mutable=["batch_stats"])
    norm = layers.Norm(3)
    norm.train()
    got = norm(_t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y), **BN_TOL)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(norm.running_mean.numpy(),
                               np.asarray(stats["mean"]), **BN_TOL)
    np.testing.assert_allclose(norm.running_var.numpy(),
                               np.asarray(stats["var"]), **BN_TOL)


def _cfg(size=32, **kw):
    base = dict(trainer="AE", model="autoencoder", batchsize=4,
                outputWidth=size, outputHeight=size, zDim=16,
                compute_dtype="float32")
    base.update(kw)
    return Config(**base)


def test_autoencoder_train_mode_call_matches_flax():
    """One train-mode forward of the whole AE on the same weights: outputs
    and every BatchNorm's updated running mean and variance."""
    cfg = _cfg()
    jt = jax_get_trainer("AE")(cfg)
    js = jt.init_state()
    x = np.random.default_rng(1).uniform(size=(2, 32, 32, 1)).astype(
        np.float32)
    ref, mutated = jt.model.apply(
        {"params": js.params, "batch_stats": js.batch_stats}, x, train=True,
        dropout=False, mutable=["batch_stats"])
    want = params_from_flax(jax.device_get(js.params),
                            jax.device_get(mutated["batch_stats"]))
    tt = get_trainer("AE")(cfg)
    tt.model.load_state_dict(params_from_flax(
        jax.device_get(js.params), jax.device_get(js.batch_stats)))
    tt.model.train()
    out = tt.model(_t(x))
    np.testing.assert_allclose(out["x_hat"].detach().numpy(),
                               np.asarray(ref["x_hat"]), **BN_TOL)
    got = tt.model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 5
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **BN_TOL)


# ---------------------------------------------------------------------------
# epoch helpers


@pytest.mark.parametrize("n,bs,shuffle", [(37, 8, True), (37, 8, False),
                                          (7, 8, True), (64, 16, True)])
def test_epoch_indices_equal_jax(n, bs, shuffle):
    got = engine.epoch_indices(np.random.default_rng((43, 2)), n, bs, shuffle)
    ref = jax_engine.epoch_indices(np.random.default_rng((43, 2)), n, bs,
                                   shuffle)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_early_stopping_update_equals_jax():
    losses = [5.0, 4.0, 4.5, 4.0, 4.2, 4.1, 4.3, 3.9, 4.0]
    a = b = (float("inf"), 0, False)
    for v in losses:
        a = engine.early_stopping_update(v, a[0], a[1], 3)
        b = jax_engine.early_stopping_update(v, b[0], b[1], 3)
        assert a == b


# ---------------------------------------------------------------------------
# trajectories


def _bn_fed_biases(state_dict):
    """Biases of the convolutions that feed a BatchNorm: their true gradient
    is zero (BN cancels them), so round-off steers their Adam steps."""
    return {k for k in state_dict if k.endswith(".bias") and (
        ".enc_conv_" in k or ".dec_convT_" in k
        or "intermediate_conv_reverse" in k)}


def _convert(jstate):
    return params_from_flax(jax.device_get(jstate.params),
                            jax.device_get(jstate.batch_stats))


def _setup(start_steps):
    """JAX trainer after ``start_steps`` of its own steps, a port trainer
    on the same converted state, the pool and 12 ``epoch_indices``
    batches."""
    cfg = _cfg(dropout_rate=0.0)
    pool = np.random.default_rng(5).uniform(size=(24, 32, 32, 1)).astype(
        np.float32)
    idxs = engine.epoch_indices(np.random.default_rng((cfg.seed + 1, 0)),
                                len(pool), cfg.batchsize)
    idxs = np.concatenate([idxs, idxs[::-1]])
    jt = jax_get_trainer("AE")(cfg)
    jstate = jt.init_state()
    jstep = jax.jit(jt._build_train_step())
    for b in range(start_steps):
        jstate, _ = jstep(jstate, {"x": jnp.asarray(pool[idxs[b]])})
    tt = get_trainer("AE")(cfg)
    tt.init_state()
    _load_jax_state(tt, jstate)
    return cfg, pool, idxs, jstep, jstate, tt


def _load_jax_state(tt, jstate):
    tt.model.load_state_dict(_convert(jstate))
    tt.optimizer.load_state_dict(adam_state_from_optax(
        jax.device_get(jstate.opt_states["main"]), tt.model, tt.optimizer))


STEPS = 6


def _adam_step_bound(t, b1, b2):
    """Largest |m_hat / sqrt(v_hat)| of Adam's t-th step over all gradient
    histories (Cauchy-Schwarz over the two moment weights): the most an
    element can move, in units of lr."""
    i = np.arange(1, t + 1)
    a = (1 - b1) * b1 ** (t - i) / (1 - b1 ** t)
    w = (1 - b2) * b2 ** (t - i) / (1 - b2 ** t)
    return float(np.sqrt(np.sum(a * a / w)))


@pytest.mark.parametrize("start_steps", [0, 2])
def test_ae_trajectory_losses_match_jax(start_steps):
    """Free-running: both packages take STEPS steps from the same state
    (the initial one, or a JAX state after 2 steps carried across by the
    optimizer-state converter); each step's loss agrees within 1e-5."""
    cfg, pool, idxs, jstep, jstate, tt = _setup(start_steps)
    for b in range(start_steps, start_steps + STEPS):
        jstate, jm = jstep(jstate, {"x": jnp.asarray(pool[idxs[b]])})
        tm = tt.train_step({"x": _t(pool[idxs[b]])})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TRAJ_LOSS_RTOL, err_msg=f"step {b}")


@pytest.mark.parametrize("start_steps", [0, 2])
def test_ae_trajectory_steps_match_jax(start_steps):
    """Each of STEPS steps from the JAX package's state at that step
    (parameters, BatchNorm statistics and Adam moments converted): the
    loss, every parameter and every running statistic after the step agree
    within 1e-5, except where BatchNorm cancels the gradient.

    The biases of convolutions that feed a BatchNorm have a true gradient
    of zero; round-off leaves +-1e-9 there and Adam turns it into a step
    either way, so they are held to twice the largest step Adam can take
    (``_adam_step_bound``).

    The same holds, rarely, for a weight whose gradient nearly cancels
    (BatchNorm removes each channel's mean gradient, so a nearly constant
    input channel gives a weight gradient near 0), and a (Leaky)ReLU
    pre-activation within the two packages' float32 round-off of 0 takes
    the other slope in one of them, which Adam's per-element normalisation
    can turn into a visible step.  So at most KINK_FRACTION of all elements
    may exceed 1e-5, each within the same Adam bound.  (Observed: 1 of
    204,800 elements of ``dec_convT_0.weight`` by 1.01e-5; with one torch
    thread, 1 of 8,192 of ``z_layer.weight`` by 2.0e-4 = 2 lr, opposite
    first steps.)  For the same reason free-running
    parameters are only compared through the losses: such differences
    compound, to ~1e-5 after 5 steps and ~8e-5 after 8."""
    cfg, pool, idxs, jstep, jstate, tt = _setup(start_steps)
    lr = cfg.learningrate
    for b in range(start_steps, start_steps + STEPS):
        _load_jax_state(tt, jstate)
        jstate, jm = jstep(jstate, {"x": jnp.asarray(pool[idxs[b]])})
        tm = tt.train_step({"x": _t(pool[idxs[b]])})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TRAJ_LOSS_RTOL, err_msg=f"step {b}")
        assert int(tt.optimizer.state_dict()["state"][0]["step"]) == b + 1
        want, got = _convert(jstate), tt.model.state_dict()
        fed = _bn_fed_biases(got)
        assert len(fed) == 5
        # + float32 rounding of the updated parameters
        fed_atol = 2 * lr * _adam_step_bound(b + 1, cfg.beta1,
                                             cfg.beta2) + 1e-6
        off, total = {}, 0
        for k, v in want.items():
            if k.endswith("num_batches_tracked"):
                continue
            diff = (got[k] - v).abs()
            np.testing.assert_array_less(diff.numpy(), fed_atol,
                                         err_msg=f"{k} after step {b}")
            if k not in fed:
                off[k] = int((diff > TRAJ_PARAM_ATOL).sum())
                total += diff.numel()
        assert sum(off.values()) <= KINK_FRACTION * total, (
            f"after step {b}: elements beyond {TRAJ_PARAM_ATOL} of {total}: "
            f"{ {k: n for k, n in off.items() if n} }")


# ---------------------------------------------------------------------------
# resume and streaming


def _dataset():
    return SYNTH(SyntheticOptions(numPatients=3, imageSize=32, numSlices=12,
                                  targetSize=32))


def _state(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def test_resume_after_killed_epoch_equals_uninterrupted(tmp_path):
    cfg = _cfg(numEpochs=3, dropout_rate=0.2)
    ds = _dataset()
    full = get_trainer("AE")(cfg, workdir=str(tmp_path / "full"))
    full.fit(ds)

    killed = get_trainer("AE")(cfg, workdir=str(tmp_path / "killed"))
    calls = {"n": 0}
    original = killed.train_step

    def dying_step(batch):
        calls["n"] += 1
        if calls["n"] == 9:  # inside the third epoch
            raise KeyboardInterrupt
        return original(batch)

    killed.train_step = dying_step
    with pytest.raises(KeyboardInterrupt):
        killed.fit(ds)
    resumed = get_trainer("AE")(cfg, workdir=str(tmp_path / "killed"))
    resumed.fit(ds)
    assert resumed.step == full.step
    a, b = _state(full), _state(resumed)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert ([h["loss"] for h in resumed.history]
            == [h["loss"] for h in full.history])
    assert (resumed.optimizer.state_dict()["state"][0]["exp_avg"].equal(
        full.optimizer.state_dict()["state"][0]["exp_avg"]))


def test_resume_recognises_a_triggered_early_stop(tmp_path, capsys):
    cfg = _cfg(numEpochs=2)
    wd = str(tmp_path)
    first = get_trainer("AE")(cfg, workdir=wd)
    first.fit(_dataset())
    curves = tmp_path / "curves.json"
    hist = json.loads(curves.read_text())
    for h in hist:  # VAL got worse after epoch 0: patience 1 stops
        if h["phase"] == "VAL":
            h["loss"] = 1.0 if h["epoch"] == 0 else 2.0
    curves.write_text(json.dumps(hist))
    t = get_trainer("AE")(cfg.replace(numEpochs=5, earlyStoppingPatience=1),
                          workdir=wd)
    t.fit(_dataset())
    assert "already triggered" in capsys.readouterr().out
    assert t.step == first.step
    a, b = _state(first), _state(t)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_checkpoints_and_sidecars(tmp_path):
    cfg = _cfg(numEpochs=3, keepCheckpoints=2)
    t = get_trainer("AE")(cfg, workdir=str(tmp_path))
    t.fit(_dataset())
    ckpts = sorted(p.name for p in (tmp_path / "torch" / "ckpt").iterdir())
    assert ckpts == ["epoch_000002.pt", "epoch_000003.pt"]
    assert (tmp_path / "torch" / "model.pt").is_file()
    assert Config.from_json((tmp_path / "config.json").read_text()) == cfg
    curves = np.load(tmp_path / "Curves.npy", allow_pickle=True).item()
    assert len(curves["TRAIN/loss"]) == 3 and len(curves["VAL/loss"]) == 3
    (tmp_path / "tv_lambda.json").write_text('{"tv_lambda_value": 0.7}')
    served = get_trainer("AE")(cfg, workdir=str(tmp_path))
    assert served.load_checkpoint() is not None
    assert served.tv_lambda_value == 0.7
    x = _dataset().slices("VAL")[:3]
    res = served.reconstruct(x)
    assert res["reconstruction"].shape == x.shape
    np.testing.assert_allclose(
        res["l1err"], np.abs(x - res["reconstruction"]).sum(), rtol=1e-5)


def test_streaming_pool_equals_resident_pool(tmp_path):
    cfg = _cfg(numEpochs=2, dropout_rate=0.2)
    ds = _dataset()
    runs = {}
    for name, opts in (("resident", Options()),
                       ("stream", Options(streamPool=True,
                                          streamPoolChunkBatches=2))):
        t = get_trainer("AE")(cfg, opts)
        t.fit(ds)
        runs[name] = (t, _state(t))
    assert runs["stream"][0].streamed_last_epoch
    assert not runs["resident"][0].streamed_last_epoch
    a, b = runs["resident"][1], runs["stream"][1]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert runs["resident"][0].history == runs["stream"][0].history


def test_instance_noise_comes_from_the_trainer_generator():
    cfg = _cfg()
    t = get_trainer("AE")(cfg, Options(addInstanceNoise=True))
    batch = {"x": torch.zeros(2, 32, 32, 1)}
    noisy = t.maybe_add_instance_noise(batch, train=True)["x"]
    assert 0.005 < float(noisy.std()) < 0.02
    t.generator.manual_seed(cfg.seed)
    again = t.maybe_add_instance_noise(batch, train=True)["x"]
    t.generator.manual_seed(cfg.seed)
    assert torch.equal(again, t.maybe_add_instance_noise(batch, True)["x"])
    assert t.maybe_add_instance_noise(batch, train=False) is batch


def test_profile_dir_traces_the_first_epoch(tmp_path):
    t = get_trainer("AE")(_cfg(numEpochs=2),
                          Options(profileDir=str(tmp_path / "prof")))
    t.fit(_dataset())
    assert sorted(os.listdir(tmp_path / "prof")) == ["epoch_0.trace.json"]
