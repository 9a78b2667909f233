"""The port's latent-critic family against the JAX package on the CPU in
float32: the adversarial AE, the constrained adversarial AE, the
constrained AE and the MLP critic on converted weights (given prior ``z``
and interpolate ``eps``), the gradient penalty's gradient, a full ``AAE``
batch step with its three optimizers, ``ConstrainedAAE`` and
``ConstrainedAE`` steps, the group isolation, the epoch schedule, resume
with three optimizer states, and ``evaluate()`` of an ``AAE`` trainer.

The prior latent and the interpolate's eps are given: ``jax.random.normal``
and ``jax.random.uniform`` are patched on the JAX side, and the port takes
the same numbers as arguments, or through a patch of the trainer's
``sample_z`` and ``models/aae.py``'s ``uniform``.  Dropout is 0 where the
streams would have to match."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gmvae import assert_step_matches
from test_torch_vae import _randomised_batch_stats
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    Config as JaxConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    Options as JaxOptions,
)
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    PathConfig as JaxPathConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu.data import (
    synthetic as jax_synthetic,
)
from unsupervised_anomaly_detection_brain_mri_tpu.eval import (
    evaluate as jax_evaluate,
)
from unsupervised_anomaly_detection_brain_mri_tpu.models import (
    get_model as jax_get_model,
)
from unsupervised_anomaly_detection_brain_mri_tpu.models.layers import (
    MLPDiscriminator as JaxMLPDiscriminator,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    gan as jax_gan,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    get_trainer as jax_get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train.state import (
    count_params as jax_count_params,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
    Config,
    Options,
    PathConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.synthetic import (
    SYNTH,
    SyntheticOptions,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval import (
    evaluate as E,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import (
    aae,
    layers,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.convert import (
    adam_state_from_optax,
    params_from_flax,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.registry import (
    get_model,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import gan
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.base import (
    count_params,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)

TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_RTOL = 2e-5
Z = 16
MODELS = {
    "AAE": ("AAE", "adversarial_autoencoder"),
    "constrainedAAE": ("ConstrainedAAE",
                       "constrained_adversarial_autoencoder"),
    "constrainedAE": ("ConstrainedAE", "constrained_autoencoder"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small and the suite runs in several worker
    processes: one intra-op thread per worker keeps them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name, size=32, **kw):
    trainer, model = MODELS[name]
    base = dict(trainer=trainer, model=model, outputWidth=size,
                outputHeight=size, zDim=Z, intermediateResolutions=(8, 8),
                compute_dtype="float32", dropout_rate=0.0, batchsize=4,
                learningrate=1e-3)
    base.update(kw)
    return Config(**base)


def _jax(cfg):
    """The JAX package's Config with the same fields as the port's."""
    return JaxConfig.from_json(cfg.to_json())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flax_variables(model, x, z):
    args = (x,) if z is None else (x, z)
    return jax.device_get(model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1),
         "gp": jax.random.key(2)}, *args, train=True, dropout=False))


def _patch_draws(monkeypatch, z, eps, trainer=None):
    """The JAX package's prior z and eps draws return ``z`` and ``eps``;
    so do the port's (the trainer's ``sample_z`` and ``aae.uniform``)."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(z))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), *a, **k: jnp.asarray(eps))
    monkeypatch.setattr(aae, "uniform",
                        lambda source, shape, device: _t(eps).to(device))
    if hasattr(trainer, "sample_z"):
        monkeypatch.setattr(trainer, "sample_z",
                            lambda generator, n: _t(z).to(trainer.device))


# ---------------------------------------------------------------------------
# models


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_flax(name, train):
    """One forward on converted weights, the adversarial models with a
    given prior z and eps: every output within 1e-5, and in train mode
    every BatchNorm's running statistics (the constrained models run the
    encoder twice)."""
    cfg = _cfg(name)
    jm, spec = jax_get_model(_jax(cfg), jnp.float32)
    rng = np.random.default_rng(sorted(MODELS).index(name))
    x = rng.uniform(size=(3, 32, 32, 1)).astype(np.float32)
    z = rng.normal(size=(3, Z)).astype(np.float32) if spec.takes_prior_z \
        else None
    eps = rng.uniform(size=(3, 1)).astype(np.float32)
    variables = _flax_variables(jm, x, z)
    stats = _randomised_batch_stats(variables["batch_stats"], rng)
    real = jax.random.uniform
    jax.random.uniform = lambda key, shape=(), *a, **k: jnp.asarray(eps)
    try:
        args = (x,) if z is None else (x, z)
        out = jm.apply({"params": variables["params"], "batch_stats": stats},
                       *args, train=train, rngs={"gp": jax.random.key(3)},
                       mutable=["batch_stats"] if train else False)
    finally:
        jax.random.uniform = real
    ref, mutated = out if train else (out, None)
    tm, tspec = get_model(cfg)
    assert (tspec.reconstruction_key, tspec.rngs, tspec.takes_prior_z) == (
        spec.reconstruction_key, spec.rngs, spec.takes_prior_z)
    tm.load_state_dict(params_from_flax(variables["params"], stats, tm))
    tm.train(train)
    with torch.no_grad():
        if z is None:
            got = tm(_t(x))
        else:
            got = tm(_t(x), _t(z), gp=_t(eps))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)
    if train:
        want = params_from_flax(variables["params"],
                                jax.device_get(mutated["batch_stats"]), tm)
        state = tm.state_dict()
        keys = [k for k in want if k.endswith(("running_mean",
                                               "running_var"))]
        assert keys
        for k in keys:
            np.testing.assert_allclose(state[k].numpy(), want[k].numpy(),
                                       err_msg=k, **TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_parameter_count_matches_jax(name):
    """At 32x32 and at the presets' 128x128 (intermediate resolution 16,
    zDim 128 or 1024; shapes only on the JAX side)."""
    for size, z_dim, inter in ((32, Z, 8), (128, 128, 16), (128, 1024, 16)):
        cfg = _cfg(name, size, zDim=z_dim, intermediateResolutions=(inter,
                                                                    inter))
        jm, spec = jax_get_model(_jax(cfg), jnp.float32)
        x = jnp.zeros((2, size, size, 1))
        args = (x, jnp.zeros((2, z_dim))) if spec.takes_prior_z else (x,)
        shapes = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.key(0), "gp": jax.random.key(1)}, *args,
            train=True))
        assert count_params(get_model(cfg)[0]) == jax_count_params(
            shapes["params"]), (size, z_dim)


@pytest.mark.parametrize("hidden", [(50, 50), (100, 50)])
def test_mlp_discriminator_matches_flax(hidden):
    rng = np.random.default_rng(len(hidden) + hidden[0])
    z = rng.normal(size=(5, Z)).astype(np.float32)
    jd = JaxMLPDiscriminator(hidden)
    params = jax.device_get(jd.init(jax.random.key(0), z))["params"]
    ref = jd.apply({"params": params}, z)
    holder = torch.nn.Module()
    holder.add_module("discriminator", layers.MLPDiscriminator(Z, hidden))
    holder.load_state_dict(params_from_flax({"discriminator": params}, {},
                                             holder))
    got = holder.discriminator(_t(z))
    assert got.shape == (5, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    # LeakyReLU 0.2, not the backbone's 0.3
    h = holder.discriminator.disc_dense_0(_t(z))
    assert torch.equal(torch.nn.functional.leaky_relu(h, 0.2),
                       layers.leaky_relu(h, layers.LEAKY_SLOPE_ZIMMERER))


# ---------------------------------------------------------------------------
# training


@pytest.fixture
def aae_pair(monkeypatch):
    """A JAX AAE trainer and the port's, on the same state, with 2 AE and
    2 critic iterations per batch in both (the class attributes), and the
    same prior z and eps."""
    def make(name="AAE", seed=0, lr=1e-3):
        cfg = _cfg(name, learningrate=lr)
        if MODELS[name][0] != "ConstrainedAE":
            monkeypatch.setattr(jax_gan.AAE, "d_iters", 2)
            monkeypatch.setattr(gan.AAE, "d_iters", 2)
        rng = np.random.default_rng(20 + seed)
        z = rng.normal(size=(4, Z)).astype(np.float32)
        eps = rng.uniform(size=(4, 1)).astype(np.float32)
        jt = jax_get_trainer(cfg.trainer)(_jax(cfg))
        tt = get_trainer(cfg.trainer)(cfg, device="cpu")
        js = jt.init_state()  # Glorot draws jax.random.uniform: unpatched
        tt.init_state()
        _patch_draws(monkeypatch, z, eps, tt)
        return cfg, jt, js, tt
    return make


def _load(tt, js):
    tt.model.load_state_dict(params_from_flax(
        jax.device_get(js.params), jax.device_get(js.batch_stats), tt.model))
    opt_states = jax.device_get(js.opt_states)
    if isinstance(tt.optimizer, gan.OptimizerGroup):
        for g in ("ae", "disc", "gen"):
            tt.optimizer[g].load_state_dict(adam_state_from_optax(
                opt_states[g], tt.model, tt.optimizer[g]))
    else:
        tt.optimizer.load_state_dict(adam_state_from_optax(
            opt_states["main"], tt.model, tt.optimizer))


def _batch(seed=13):
    return np.random.default_rng(seed).uniform(
        size=(4, 32, 32, 1)).astype(np.float32)


def _assert_adam_states(jopt, tt, group):
    """The torch optimizer's moments and step against the converted optax
    state of the same group."""
    opt = tt.optimizer[group]
    want = adam_state_from_optax(jopt, tt.model, opt)["state"]
    got = opt.state_dict()["state"]
    assert set(got) == set(want)
    for i in want:
        assert float(got[i]["step"]) == float(want[i]["step"])
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(got[i][k].numpy(),
                                       want[i][k].numpy(),
                                       err_msg=f"{group} {i} {k}", **TOL)


@pytest.mark.parametrize("name", ["AAE", "constrainedAAE"])
def test_batch_step_matches_jax(aae_pair, name):
    """One full batch (2 AE updates, 2 critic updates with the penalty, 1
    generator update) from the JAX state after two batches: the metrics
    within 2e-5 relative, every parameter and running statistic as
    ``assert_step_matches`` holds them, and the three Adam states; each
    group's parameters moved.

    The state is taken after two batches, at lr 5e-5: from the first
    state, Adam's first steps move every element by +-lr whatever its
    gradient's size, and at BatchNorm's train-mode gradients (1e-3
    relative apart between the packages at this init, as for the AE at
    batch 16) hundreds of small gradients take opposite signs."""
    cfg, jt, js, tt = aae_pair(name, lr=5e-5)
    jstep = jax.jit(jt._build_train_step(ae_iters=2))
    for b in range(2):
        js, _ = jstep(js, {"x": jnp.asarray(_batch(100 + b))})
    x = _batch()
    _load(tt, js)
    start = {k: v.clone() for k, v in tt.model.state_dict().items()}
    js, jm = jstep(js, {"x": jnp.asarray(x)})
    tm = tt.train_step({"x": _t(x)})
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-5, err_msg=k)
    want = params_from_flax(jax.device_get(js.params),
                            jax.device_get(js.batch_stats), tt.model)
    got = tt.model.state_dict()
    # an encoder element takes two AE steps and a generator step
    assert_step_matches(want, got, start, cfg, (5, 6, 3))
    for group, names in tt.groups.items():
        assert any(not torch.equal(got[n], start[n]) for n in names), group
    opt_states = jax.device_get(js.opt_states)
    for group in ("ae", "disc", "gen"):
        _assert_adam_states(opt_states[group], tt, group)
    assert [int(tt.optimizer[g].state_dict()["state"][0]["step"])
            for g in ("ae", "disc", "gen")] == [6, 6, 3]


def test_constrained_ae_step_matches_jax(aae_pair):
    """Two single-optimizer ``ConstrainedAE`` steps, each from the JAX
    state at that step (after two batches, lr 5e-5, as in
    ``test_batch_step_matches_jax``): losses and parameters."""
    cfg, jt, js, tt = aae_pair("constrainedAE", lr=5e-5)
    jstep = jax.jit(jt._build_train_step())
    for b in range(2):
        js, _ = jstep(js, {"x": jnp.asarray(_batch(100 + b))})
    for b in range(2, 4):
        x = _batch(30 + b)
        _load(tt, js)
        start = {k: v.clone() for k, v in tt.model.state_dict().items()}
        js, jm = jstep(js, {"x": jnp.asarray(x)})
        tm = tt.train_step({"x": _t(x)})
        assert set(tm) == set(jm) == {"reconstructionLoss", "L2", "Rec_z",
                                      "loss"}
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, atol=1e-5, err_msg=k)
        assert_step_matches(
            params_from_flax(jax.device_get(js.params),
                             jax.device_get(js.batch_stats), tt.model),
            tt.model.state_dict(), start, cfg, (b + 1,))


def test_gradient_penalty_gradient_matches_jax_grad(aae_pair):
    """The critic's loss and its parameter gradient, through the penalty
    on ddx = d D(z_hat) / d z_hat (grad of grad), against ``jax.grad`` of
    the JAX trainer's critic loss."""
    cfg, jt, js, tt = aae_pair("AAE")
    x = _batch(40)
    z = np.random.default_rng(20).normal(size=(4, Z)).astype(np.float32)
    _load(tt, js)
    params = jax.device_get(js.params)

    def loss_fn(p):
        return jt._disc_loss(p, js.batch_stats, jax.random.key(0),
                             {"x": jnp.asarray(x)}, jnp.asarray(z))[0]

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(params)
    with tt.only("disc"):
        loss = tt.disc_loss(tt.forward_train({"x": _t(x)}, _t(z)))
        names = tt.groups["disc"]
        grads = torch.autograd.grad(loss, [dict(tt.model.named_parameters())[
            n] for n in names])
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    want = params_from_flax({"discriminator": jax.device_get(
        ref_grads["discriminator"])}, {}, tt.model)
    assert sorted(want) == sorted(names)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), err_msg=n,
                                   **TOL)
    # the penalty alone has a gradient: ddx carries the critic's weights
    out = tt.forward_train({"x": _t(x)}, _t(z))
    z_hat = out["z_hat"].detach().requires_grad_(True)
    (ddx,) = torch.autograd.grad(tt.model.discriminate(z_hat).sum(), z_hat,
                                 create_graph=True)
    d_of = lambda zh: jnp.sum(jt.model.apply(  # noqa: E731
        {"params": params}, zh, method="discriminate"))
    np.testing.assert_allclose(ddx.detach().numpy(), np.asarray(
        jax.grad(d_of)(jnp.asarray(z_hat.detach().numpy()))), **TOL)


def test_substeps_update_only_their_group():
    """A critic substep leaves every non-critic parameter bit-equal; a
    generator substep changes ``encoder.*`` only (not ``z_layer`` nor
    ``intermediate_conv``); an AE substep leaves the critic unchanged."""
    cfg = _cfg("AAE", dropout_rate=0.2)
    tt = get_trainer("AAE")(cfg, device="cpu")
    tt.init_state()
    batch = {"x": _t(_batch(50))}
    params = dict(tt.model.named_parameters())
    assert tt.groups["gen"] and all(n.startswith("encoder.")
                                    for n in tt.groups["gen"])
    assert all(n.startswith("discriminator.") for n in tt.groups["disc"])
    assert len(tt.groups["ae"]) == len(params)

    def substep(group, loss_fn):
        before = {n: p.detach().clone() for n, p in params.items()}
        with tt.only(group):
            tt.update(group, loss_fn())
        assert all(p.requires_grad for p in params.values())
        return {n for n, p in params.items() if not torch.equal(p,
                                                                before[n])}

    z = tt.sample_z(tt.generator, 4)
    # the WGAN loss and the penalty cancel the critic's output bias
    assert substep("disc", lambda: tt.disc_loss(tt.forward_train(batch, z))
                   ) == set(tt.groups["disc"]) - {"discriminator.disc_out.bias"}
    assert substep("gen", lambda: -tt.model.discriminate(
        tt.forward_train(batch, None)["z_"]).mean()) == set(tt.groups["gen"])
    changed = substep("ae", lambda: tt.ae_loss(tt.forward_train(batch, None),
                                               batch)["loss"])
    assert changed == set(tt.groups["ae"]) - set(tt.groups["disc"])


@pytest.mark.parametrize("epoch,ae_iters", [(5, 20), (6, 1)])
def test_schedule_follows_the_epoch(epoch, ae_iters, monkeypatch):
    """Epochs 0-5 run 20 AE updates per batch and later ones 1; always 20
    critic updates and 1 generator update, then BatchNorm has moved once
    per substep."""
    cfg = _cfg("AAE", 16, intermediateResolutions=(4, 4), batchsize=2)
    tt = get_trainer("AAE")(cfg, device="cpu")
    tt.init_state()
    calls = []
    real = tt.update
    monkeypatch.setattr(tt, "update", lambda g, loss: calls.append(g) or real(
        g, loss))
    tt.epoch = epoch
    tt.train_step({"x": torch.rand(2, 16, 16, 1)})
    assert calls == ["ae"] * ae_iters + ["disc"] * 20 + ["gen"]
    bn = tt.model.encoder.enc_norm_0.num_batches_tracked
    assert int(bn) == ae_iters + 20 + 1


def _dataset():
    return SYNTH(SyntheticOptions(numPatients=3, imageSize=32, numSlices=8,
                                  targetSize=32))


def test_resume_with_three_optimizers_equals_uninterrupted(tmp_path,
                                                           monkeypatch):
    """Killed in its third epoch and resumed, an ``AAE`` run (dropout on,
    2 critic iterations) ends bit-equal to an uninterrupted one: the
    checkpoint holds the three optimizer states and the gp generator."""
    monkeypatch.setattr(gan.AAE, "d_iters", 2)
    cfg = _cfg("AAE", numEpochs=3, dropout_rate=0.2)
    ds = _dataset()
    full = get_trainer("AAE")(cfg, workdir=str(tmp_path / "full"),
                              device="cpu")
    full.fit(ds)
    ckpt = torch.load(tmp_path / "full" / "torch" / "ckpt" /
                      "epoch_000003.pt", weights_only=True)
    assert sorted(ckpt["optimizer"]) == ["ae", "disc", "gen"]
    assert "gp_generator" in ckpt and "sample_generator" not in ckpt

    killed = get_trainer("AAE")(cfg, workdir=str(tmp_path / "killed"),
                                device="cpu")
    calls = {"n": 0}
    original = killed.train_step
    per_epoch = len(ds.slices("TRAIN")) // cfg.batchsize

    def dying_step(batch):
        calls["n"] += 1
        if calls["n"] == 2 * per_epoch + 1:  # inside the third epoch
            raise KeyboardInterrupt
        return original(batch)

    killed.train_step = dying_step
    with pytest.raises(KeyboardInterrupt):
        killed.fit(ds)
    resumed = get_trainer("AAE")(cfg, workdir=str(tmp_path / "killed"),
                                 device="cpu")
    resumed.fit(ds)
    assert resumed.step == full.step
    a, b = full.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert resumed.history == full.history
    for g in ("ae", "disc", "gen"):
        sa = full.optimizer[g].state_dict()["state"]
        sb = resumed.optimizer[g].state_dict()["state"]
        assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa
                   for k in ("exp_avg", "exp_avg_sq"))
    assert torch.equal(full.gp_generator.get_state(),
                       resumed.gp_generator.get_state())
    assert {h["phase"] for h in full.history} == {"TRAIN", "VAL"}
    assert all({"disc_loss", "gen_loss"} <= set(h) for h in full.history
               if h["phase"] == "TRAIN")


# ---------------------------------------------------------------------------
# the slice as a whole


def test_evaluate_matches_jax(tmp_path):
    """``evaluate()`` of an ``AAE`` trainer at 64x64 on the same converted
    weights (the prior latent enters every forward; the reconstruction
    does not depend on it): AUROC, AUPRC, Dice and the threshold within
    1e-4."""
    cfg = _cfg("AAE", 64, intermediateResolutions=(16, 16))
    jt = jax_get_trainer(cfg.trainer)(_jax(cfg))
    js = jt.init_state()
    stats = _randomised_batch_stats(jax.device_get(js.batch_stats),
                                    np.random.default_rng(60))
    js = js.replace(batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    tt = get_trainer(cfg.trainer)(cfg, device="cpu")
    tt.model.load_state_dict(params_from_flax(jax.device_get(js.params),
                                              stats, tt.model))
    ds = jax_synthetic.SYNTH(jax_synthetic.SyntheticOptions(
        numPatients=4, imageSize=64, numSlices=12, targetSize=64,
        withLesions=True, seed=99,
        partition={"TRAIN": 0.0, "VAL": 0.5, "TEST": 0.5}))
    kw = dict(threshold=None, applyHyperIntensityPrior=True,
              erosionIterations=6)
    ref = jax_evaluate(ds, jt, js, JaxOptions(
        paths=JaxPathConfig(sample_dir=str(tmp_path / "jax")), **kw),
        _jax(cfg))
    got = E.evaluate(ds, tt, Options(
        paths=PathConfig(sample_dir=str(tmp_path / "torch")), **kw), cfg)
    np.testing.assert_allclose(got["reconstructions"], ref["reconstructions"],
                               atol=1e-5, rtol=0)
    for k in ("diff_AUC", "diff_AUPRC", "bestDiceScore", "bestThreshold",
              "DiceScore"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    out = tt.reconstruct_device(torch.from_numpy(got["x"][:2, ..., None]))
    assert {"d", "d_", "d_hat", "z_hat"} <= set(out)
