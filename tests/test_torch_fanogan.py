"""The port's image-critic family against the JAX package on the CPU in
float32: ``FAnoGAN``, ``FAnoGANSchlegl`` and ``AnoVAEGAN`` on converted
weights with given noise, the trainers' parameter groups, one step of each
schedule (fAnoGAN's WGAN step, also with Schlegl's ResNets, its encoder
step, AnoVAEGAN's step) from one state, the phases of a fAnoGAN run and its
resume across the WGAN -> encoder boundary, a JAX ``fAnoGAN_schlegl``
workdir converted for serving, and an optax state of a fAnoGAN group.

Inputs come from numpy seeds at 32x32 (batch 4; ResNet ``dim`` 8, through
patched registry builders: the registries always build ``dim`` 64).  The
prior latent, the VAE's eps and the interpolate's per-sample alpha are
given to both sides: ``jax.random.normal`` and ``jax.random.uniform`` are
patched on the JAX side, the port takes the same tensors through its noise
seam (the trainer's ``_noise`` and ``sample_z``).  Dropout is 0 where the
streams would have to match.  Tolerance 1e-5 (of each output's largest
magnitude where it exceeds 1: the critic's feature maps); a step's losses
2e-5 relative, its parameters as ``test_torch_gmvae.assert_step_matches``
holds them, its Adam moments within 2e-5 of each tensor's scale
(``MOMENT_RTOL``).  Each critic update runs the
image gradient penalty with the reference's slope over axis 1 (H of NHWC),
so the WGAN steps hold it inside a whole critic step."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gmvae import assert_step_matches
from test_torch_resnet import assert_scaled_close, small_resnets
from test_torch_train import _bn_fed_biases
from test_torch_serving import _load_tool
from test_torch_vae import _randomised_batch_stats
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    Config as JaxConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu.models import (
    registry as jax_registry,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    gan as jax_gan,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    get_trainer as jax_get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
    Config,
    preset,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.synthetic import (
    SYNTH,
    SyntheticOptions,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import (
    registry,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.convert import (
    adam_state_from_optax,
    params_from_flax,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval import (
    inference,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import gan
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)

TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_RTOL = 2e-5
# Adam moments after a step, as a fraction of each tensor's largest element
# (default 2e-5): AnoVAEGAN's generator update starts from the parameters
# of the batch's own VAE update, free-running in each package, and its
# gradient crosses the critic's and the generator's LayerNorms; Schlegl's
# critic update differentiates its penalty, a gradient through the ResNet's
# LayerNorms, once more
MOMENT_RTOL = {("anovaegan", "gen"): 2e-3, ("fanogan_schlegl", "disc"): 2e-3}
DIM = 8
Z = 16
B = 4
PRESETS = {"fanogan": "fAnoGAN", "fanogan_schlegl": "fAnoGAN_schlegl",
           "anovaegan": "AnoVAEGAN"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes in several worker processes: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfg(model, size=32, **kw):
    base = dict(outputWidth=size, outputHeight=size, zDim=Z,
                intermediateResolutions=(size // 8, size // 8),
                compute_dtype="float32", dropout_rate=0.0, batchsize=B,
                learningrate=1e-3)
    base.update(kw)
    return preset(PRESETS[model], **base)


def _jax(cfg):
    return JaxConfig.from_json(cfg.to_json())


def _noise(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Z)).astype(np.float32),
            rng.uniform(size=(B, 1, 1, 1)).astype(np.float32))


def _patch_jax_draws(monkeypatch, normal, alpha):
    """The JAX package's normal draws (the prior z, AnoVAEGAN's eps) return
    ``normal``, its uniform draws (alpha) ``alpha``."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(
                            normal))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), *a, **k: jnp.asarray(alpha))


def _patch_port_draws(monkeypatch, tt, normal, alpha):
    monkeypatch.setattr(tt, "sample_z", lambda generator, n: _t(normal))
    monkeypatch.setattr(tt, "_noise", lambda sample, gp: {
        "sample": _t(normal), "gp": _t(alpha)})


def _x(seed=13, n=B, size=32):
    return np.random.default_rng(seed).uniform(
        size=(n, size, size, 1)).astype(np.float32)


# ---------------------------------------------------------------------------
# models


def _stages(tm, ref, name, alpha, eps):
    """Each output downstream of another, computed by the port from the
    JAX package's output it is made of."""
    out = {}
    if name == "anovaegan":
        out["out"] = tm.generate(ref["z_mu"] + eps * ref["z_sigma"])
        fake = "out"
    else:
        out["x_enc"] = out["x_hat_enc"] = tm.generate(ref["z_enc"])
        out["d_enc_features"], out["d_enc"] = tm.discriminate(ref["x_enc"])
        fake = "x_"
    out["d_fake_features"], out["d_"] = tm.discriminate(ref[fake])
    out["d_hat_features"], out["d_hat"] = tm.discriminate(ref["x_hat"])
    return out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_model_matches_flax(name, train, monkeypatch):
    """One forward on converted weights (randomised BatchNorm statistics)
    with a given prior z, eps and alpha: every output within 1e-5 of its
    scale stage by stage (an output computed from the JAX package's outputs
    it is made of: the generator on JAX's latent, the critic on JAX's
    images) and the whole chain within 1e-4 of it, the output keys and the
    registry's metadata as JAX's, and in train mode the encoder's BatchNorm
    running statistics."""
    small_resnets(monkeypatch)
    cfg = _cfg(name)
    jm, spec = jax_registry.get_model(_jax(cfg), jnp.float32)
    tm, tspec = registry.get_model(cfg)
    assert (tspec.reconstruction_key, tspec.rngs, tspec.takes_prior_z) == (
        spec.reconstruction_key, spec.rngs, spec.takes_prior_z)
    x = _x(1)
    normal, alpha = _noise(2)
    args = (x, normal) if spec.takes_prior_z else (x,)
    variables = jax.device_get(jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1),
         "sample": jax.random.key(2), "gp": jax.random.key(3)}, *args,
        train=True, dropout=False))
    stats = _randomised_batch_stats(variables["batch_stats"],
                                    np.random.default_rng(4))
    _patch_jax_draws(monkeypatch, normal, alpha)
    ref, mutated = jm.apply(
        {"params": variables["params"], "batch_stats": stats}, *args,
        train=train, dropout=False, rngs={"gp": jax.random.key(5),
                                          "sample": jax.random.key(6)},
        mutable=["batch_stats"])
    tm.load_state_dict(params_from_flax(variables["params"], stats, tm))
    tm.train(train)
    with torch.no_grad():
        got = tm(*[_t(a) for a in args], sample=_t(normal), gp=_t(alpha))
        stages = _stages(tm, {k: _t(np.asarray(v)) for k, v in ref.items()},
                         name, _t(alpha), _t(normal))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32 and got[k].shape == ref[k].shape
        assert_scaled_close(stages.get(k, got[k]).numpy(), ref[k], k)
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(ref[k]), rtol=0, err_msg=k,
            atol=1e-4 * max(1.0, float(np.abs(ref[k]).max())))
    if name == "anovaegan":
        np.testing.assert_allclose(
            got["x_hat"].numpy(),
            x + alpha * (got["out"].numpy() - x), **TOL)
    if train:
        want = params_from_flax(variables["params"],
                                jax.device_get(mutated["batch_stats"]), tm)
        state = tm.state_dict()
        keys = [k for k in want if k.endswith(("running_mean",
                                               "running_var"))]
        assert keys and all(k.startswith("encoder.") for k in keys)
        for k in keys:
            np.testing.assert_allclose(state[k].numpy(), want[k].numpy(),
                                       err_msg=k, **TOL)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_groups_match_jax_predicates(name, monkeypatch):
    """Each group holds the parameters the JAX trainer's predicate selects;
    ``disc`` is the critic (``disc_features``, ``disc_dense``)."""
    small_resnets(monkeypatch)
    cfg = _cfg(name)
    jt = jax_get_trainer(cfg.trainer)(_jax(cfg))
    tt = get_trainer(cfg.trainer)(cfg, device="cpu")
    names = [n for n, _ in tt.model.named_parameters()]
    if cfg.trainer == "fAnoGAN":
        preds = {"gen": jt.gen_pred, "disc": jt.disc_pred,
                 "enc": jt.enc_pred}
    else:
        preds = {"vae": lambda ks: jt.enc_pred(ks) or jt.gen_pred(ks),
                 "gen": jt.gen_pred, "disc": jt.disc_pred}
    assert sorted(tt.groups) == sorted(preds)
    for group, pred in preds.items():
        want = [n for n in names if pred(tuple(n.split(".")))]
        assert want and tt.groups[group] == want, group
    assert {n.split(".")[0] for n in tt.groups["disc"]} == {
        "disc_features", "disc_dense"}
    assert not set(tt.groups["disc"]) & set(tt.groups["gen"])


# ---------------------------------------------------------------------------
# one step of each schedule


def _load(tt, js):
    tt.model.load_state_dict(params_from_flax(
        jax.device_get(js.params), jax.device_get(js.batch_stats), tt.model))
    opt_states = jax.device_get(js.opt_states)
    for g in tt.groups:
        tt.optimizer[g].load_state_dict(adam_state_from_optax(
            opt_states[g], tt.model, tt.optimizer[g]))


def _free_biases(names):
    """Biases whose true gradient is 0, so that round-off steers their Adam
    steps: the ResNets' that only a LayerNorm reads (each block's conv1,
    the generator's last block), and the critic's convolution biases and
    output bias, which reach the score only through LayerNorms or add the
    same constant to the real and the fake scores, whose difference the
    WGAN loss takes."""
    return {k for k in names if k.endswith(".conv1.bias")} | {
        k for k in names if k.startswith("generator.res4.")
        and k.endswith(("conv2.bias", "shortcut.bias"))} | {
        k for k in names if k.startswith("disc_features.")
        and k.endswith((".stem.bias", "conv2.bias", "shortcut.bias"))} | {
        "disc_dense.bias"}


def _assert_moments(jopt, tt, group, skip, rtol):
    """The group's Adam steps and moments against the converted optax
    state: each moment tensor within ``rtol`` of its largest element (an
    element's gradient through a norm carries the float32 rounding of the
    norm's statistics), the biases in ``skip`` aside."""
    opt = tt.optimizer[group]
    want = adam_state_from_optax(jopt, tt.model, opt)["state"]
    got = opt.state_dict()["state"]
    assert set(got) == set(want)
    for i, name in enumerate(tt.groups[group]):
        assert float(got[i]["step"]) == float(want[i]["step"])
        if name in skip:
            continue
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(
                got[i][k].numpy(), want[i][k].numpy(), rtol=0,
                atol=rtol * float(want[i][k].abs().max()) + 1e-12,
                err_msg=f"{group} {name} {k}")


SCHEDULES = {
    # (model, JAX warm-up steps' phase2 flags, compared step's phase2)
    "fanogan_wgan": ("fanogan", (False, False), False),
    "schlegl_wgan": ("fanogan_schlegl", (False, False), False),
    "fanogan_encoder": ("fanogan", (False, False, True, True), True),
    "anovaegan": ("anovaegan", (None, None), None),
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_step_matches_jax(schedule, monkeypatch):
    """One batch from the JAX state after a few, at lr 5e-5 and 2 critic
    updates in both packages: the metrics within 2e-5 relative, every
    parameter and running statistic (``assert_step_matches``; the
    LayerNorm-fed biases within Adam's largest steps), every group's Adam
    state, and the groups that step moved."""
    name, warmup, phase2 = SCHEDULES[schedule]
    small_resnets(monkeypatch)
    cfg = _cfg(name, learningrate=5e-5, numEpochs=1)
    for cls in (jax_gan.FAnoGAN, jax_gan.AnoVAEGAN, gan.FAnoGAN,
                gan.AnoVAEGAN):
        monkeypatch.setattr(cls, "d_iters", 2)
    jt = jax_get_trainer(cfg.trainer)(_jax(cfg))
    tt = get_trainer(cfg.trainer)(cfg, device="cpu")
    js = jt.init_state()  # Glorot draws jax.random.uniform: unpatched
    tt.init_state()
    normal, alpha = _noise(30)
    _patch_jax_draws(monkeypatch, normal, alpha)
    _patch_port_draws(monkeypatch, tt, normal, alpha)
    steps = {}

    def jstep(flag):
        if flag not in steps:
            kw = {} if flag is None else {"phase2": flag}
            steps[flag] = jax.jit(jt._build_train_step(**kw))
        return steps[flag]

    for b, flag in enumerate(warmup):
        js, _ = jstep(flag)(js, {"x": jnp.asarray(_x(100 + b))})
    _load(tt, js)
    tt.epoch = cfg.numEpochs if phase2 else 0
    start = {k: v.clone() for k, v in tt.model.state_dict().items()}
    x = _x()
    js, jm = jstep(phase2)(js, {"x": jnp.asarray(x)})
    tm = tt.train_step({"x": _t(x)})
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-5, err_msg=k)
    want = params_from_flax(jax.device_get(js.params),
                            jax.device_get(js.batch_stats), tt.model)
    got = tt.model.state_dict()
    fed = _free_biases(want)
    kept = {k: v for k, v in want.items() if k not in fed}
    assert_step_matches(kept, got, start, cfg, (5, 6))
    opt_states = jax.device_get(js.opt_states)
    moved = set()
    for group in tt.groups:
        _assert_moments(opt_states[group], tt, group,
                        fed | _bn_fed_biases(want),
                        MOMENT_RTOL.get((name, group), 2e-5))
        if any(not torch.equal(got[n], start[n]) for n in tt.groups[group]):
            moved.add(group)
    assert moved == {False: {"gen", "disc"}, True: {"enc"},
                     None: {"vae", "gen", "disc"}}[phase2]


def test_image_penalty_takes_the_slope_over_axis_1():
    """The penalty on an NHWC gradient reduces H only: a gradient of ones
    over (B, H, W, C) has slope sqrt(H) everywhere."""
    ddx = torch.ones(2, 9, 4, 1)
    assert float(gan.L.wgan_gp_penalty_from_grads(ddx, 10.0)) == (
        pytest.approx(10.0 * (3.0 - 1.0) ** 2))


# ---------------------------------------------------------------------------
# fit: phases and resume


def _dataset():
    return SYNTH(SyntheticOptions(numPatients=3, imageSize=32, numSlices=8,
                                  targetSize=32))


def test_fanogan_phases_and_resume_across_the_boundary(tmp_path,
                                                       monkeypatch):
    """``numEpochs`` 2 runs 4 epochs: two ``TRAIN_WGAN`` without VAL, then
    two ``TRAIN_Encoder`` each with a VAL pass.  Killed in its third epoch
    (the first encoder epoch) and resumed, the run ends bit-equal to an
    uninterrupted one, history included."""
    monkeypatch.setattr(gan.FAnoGAN, "d_iters", 2)
    cfg = _cfg("fanogan", numEpochs=2, dropout_rate=0.2)
    ds = _dataset()
    full = get_trainer("fAnoGAN")(cfg, workdir=str(tmp_path / "full"),
                                  device="cpu")
    full.fit(ds)
    assert [(h["epoch"], h["phase"]) for h in full.history] == [
        (0, "TRAIN_WGAN"), (1, "TRAIN_WGAN"), (2, "TRAIN_Encoder"),
        (2, "VAL"), (3, "TRAIN_Encoder"), (3, "VAL")]
    assert {"gen_loss", "disc_loss"} <= set(full.history[0])
    assert {"enc_loss", "loss_img", "loss_fts"} <= set(full.history[2])

    killed = get_trainer("fAnoGAN")(cfg, workdir=str(tmp_path / "killed"),
                                    device="cpu")
    calls = {"n": 0}
    original = killed.train_step
    per_epoch = len(ds.slices("TRAIN")) // cfg.batchsize

    def dying_step(batch):
        calls["n"] += 1
        if calls["n"] == 2 * per_epoch + 1:  # the first encoder batch
            raise KeyboardInterrupt
        return original(batch)

    killed.train_step = dying_step
    with pytest.raises(KeyboardInterrupt):
        killed.fit(ds)
    resumed = get_trainer("fAnoGAN")(cfg, workdir=str(tmp_path / "killed"),
                                     device="cpu")
    resumed.fit(ds)
    assert resumed.step == full.step
    a, b = full.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert resumed.history == full.history
    for g in ("gen", "disc", "enc"):
        sa = full.optimizer[g].state_dict()["state"]
        sb = resumed.optimizer[g].state_dict()["state"]
        assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa
                   for k in ("exp_avg", "exp_avg_sq"))


# ---------------------------------------------------------------------------
# a JAX workdir served by the port


def test_tool_converts_a_schlegl_workdir(tmp_path):
    """A JAX ``fAnoGAN_schlegl`` checkpoint at 32x32 (``dim`` 64, the
    registries' width) becomes the port's, with its optimizer-free state:
    the port's reconstruction of four slices within 1e-4 of JAX's, and the
    detector loads the workdir."""
    cfg = _jax(_cfg("fanogan_schlegl", zDim=64))
    jt = jax_get_trainer("fAnoGAN")(cfg, workdir=str(tmp_path))
    js = jt.init_state()
    stats = _randomised_batch_stats(jax.device_get(js.batch_stats),
                                    np.random.default_rng(70))
    js = js.replace(batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    jt.save_checkpoint(js, 1)
    _load_tool().convert(str(tmp_path))
    port = get_trainer("fAnoGAN")(Config.from_json(cfg.to_json()),
                                  workdir=str(tmp_path), device="cpu")
    assert port.load_checkpoint() is not None
    x = _x(71)
    ref = jt.reconstruct(js, x)["reconstruction"]
    got = port.reconstruct(x)["reconstruction"]
    assert got.shape == (B, 32, 32, 1)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-4)
    det = inference.AnomalyDetector.from_workdir(str(tmp_path), device="cpu")
    assert det.trainer.config.model == "fanogan_schlegl"


def test_adam_state_of_a_fanogan_group_converts(monkeypatch):
    """An optax Adam state of fAnoGAN's ``enc`` group after a JAX encoder
    step becomes the port optimizer's: the moments are nonzero exactly on
    the group and laid out as its parameters."""
    cfg = _cfg("fanogan", numEpochs=1)
    jt = jax_get_trainer("fAnoGAN")(_jax(cfg))
    js = jt.init_state()
    js, _ = jax.jit(jt._build_train_step(phase2=True))(
        js, {"x": jnp.asarray(_x(80))})
    tt = get_trainer("fAnoGAN")(cfg, device="cpu")
    tt.init_state()
    opt = tt.optimizer["enc"]
    state = adam_state_from_optax(jax.device_get(js.opt_states["enc"]),
                                  tt.model, opt)
    opt.load_state_dict(state)
    params = dict(tt.model.named_parameters())
    for i, n in enumerate(tt.groups["enc"]):
        m = opt.state_dict()["state"][i]["exp_avg"]
        assert m.shape == params[n].shape, n
        assert float(opt.state_dict()["state"][i]["step"]) == 1.0
    assert any(float(s["exp_avg"].abs().max()) > 0
               for s in opt.state_dict()["state"].values())
