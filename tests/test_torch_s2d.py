"""The port's non-parity space-to-depth stem and depth-to-space head
against the JAX package, on the CPU in float32.

The same numpy inputs (seeded) and the same weights (a Flax init carried
across by ``models/convert.py::params_from_flax``, with randomised
BatchNorm statistics) go through both packages: the packing functions at
C = 1 and C = 2 (where the JAX package's (dy, dx, c) channel order and
``pixel_shuffle``'s (c, dy, dx) differ), the forward of ``Autoencoder``,
``VariationalAutoencoder`` (given eps), ``AdversarialAutoencoder`` (given
prior z and interpolate eps), ``AnoVAEGAN`` (given eps and alpha), the
spatial and the constrained AEs, the constrained AAE and ``fanogan``
(given z and alpha) with each option alone and with both, and an ``AE`` Adam step with both, step
by step from the JAX state.  The registry passes the options only to the
models that take them, as the JAX registry does; the CLI's ``--tpu-fast``,
``--s2d-stem``, ``--d2s-head`` and ``--parity`` resolve as the JAX CLI's.
Tolerance 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _adam_step_bound, _bn_fed_biases
from test_torch_vae import _randomised_batch_stats
from unsupervised_anomaly_detection_brain_mri_tpu import cli as jax_cli
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    Config as JaxConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu.models import (
    layers as jax_layers,
)
from unsupervised_anomaly_detection_brain_mri_tpu.models import (
    registry as jax_registry,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    get_trainer as jax_get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import Config
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import (
    layers,
    registry,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.convert import (
    adam_state_from_optax,
    params_from_flax,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)

TOL = dict(atol=1e-5, rtol=1e-5)
Z = 16
B = 3
FLAGS = {"stem": dict(spaceToDepthStem=True),
         "head": dict(depthToSpaceHead=True),
         "both": dict(spaceToDepthStem=True, depthToSpaceHead=True)}
MODELS = {"autoencoder": dict(intermediateResolutions=(8, 8)),
          "variational_autoencoder": dict(intermediateResolutions=(8, 8)),
          "adversarial_autoencoder": dict(intermediateResolutions=(16, 16)),
          "anovaegan": dict(intermediateResolutions=(8, 8)),
          "autoencoder_spatial": dict(intermediateResolutions=(8, 8)),
          "constrained_autoencoder": dict(intermediateResolutions=(16, 16)),
          "constrained_adversarial_autoencoder": dict(
              intermediateResolutions=(16, 16)),
          "fanogan": dict(intermediateResolutions=(16, 16))}
# the models whose ``gp`` draw is an interpolation weight per image
IMAGE_CRITICS = ("anovaegan", "fanogan")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfg(model, size=32, **kw):
    base = dict(trainer="AE", model=model, outputWidth=size,
                outputHeight=size, zDim=Z, compute_dtype="float32",
                dropout_rate=0.0, batchsize=4, **MODELS[model])
    base.update(kw)
    return Config(**base)


def _jax(cfg):
    return JaxConfig.from_json(cfg.to_json())


# ---------------------------------------------------------------------------
# packing


@pytest.mark.parametrize("channels", [1, 2])
def test_space_to_depth_matches_jax(channels):
    """(B, H, W, C) packed into (B, H/2, W/2, 4C) in the JAX package's
    channel order, and unpacked back; at C = 2 the order differs from
    ``F.pixel_unshuffle``'s, so the test would see a (c, dy, dx) port."""
    x = np.random.default_rng(channels).normal(
        size=(2, 8, 6, channels)).astype(np.float32)
    want = np.asarray(jax_layers.space_to_depth(jnp.asarray(x), 2))
    got = layers.space_to_depth(_t(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    back = np.asarray(jax_layers.depth_to_space(jnp.asarray(want), 2))
    np.testing.assert_array_equal(back, x)
    got_back = layers.depth_to_space(got, 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got_back.numpy(), x)
    if channels > 1:
        assert not torch.equal(
            got, torch.nn.functional.pixel_unshuffle(
                _t(x).permute(0, 3, 1, 2), 2))


@pytest.mark.parametrize("channels", [1, 2])
def test_depth_to_space_matches_jax(channels):
    y = np.random.default_rng(10 + channels).normal(
        size=(2, 3, 5, 4 * channels)).astype(np.float32)
    want = np.asarray(jax_layers.depth_to_space(jnp.asarray(y), 2))
    got = layers.depth_to_space(_t(y).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


# ---------------------------------------------------------------------------
# models


def _forward_pair(model, flags, channels=1, monkeypatch=None):
    """The JAX and the port outputs of one eval-mode forward of ``model``
    with ``flags`` on converted weights and given noise."""
    cfg = _cfg(model, numChannels=channels, **FLAGS[flags])
    jm, spec = jax_registry.get_model(_jax(cfg), jnp.float32)
    tm, tspec = registry.get_model(cfg)
    rng = np.random.default_rng(sorted(MODELS).index(model))
    x = rng.uniform(size=(B, 32, 32, channels)).astype(np.float32)
    z = rng.normal(size=(B, Z)).astype(np.float32)
    eps = rng.uniform(size=(B, 1)).astype(np.float32)
    alpha = rng.uniform(size=(B, 1, 1, 1)).astype(np.float32)
    args = (x, z) if spec.takes_prior_z else (x,)
    variables = jax.device_get(jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1),
         "sample": jax.random.key(2), "gp": jax.random.key(3)}, *args,
        train=True, dropout=False))
    stats = _randomised_batch_stats(variables.get("batch_stats", {}), rng)
    uniform = alpha if model in IMAGE_CRITICS else eps
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(z))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), *a, **k: jnp.asarray(uniform))
    jvars = {"params": variables["params"]}
    if stats:
        jvars["batch_stats"] = stats
    ref = jm.apply(jvars, *args, train=False, dropout=False,
                   rngs={"gp": jax.random.key(5),
                         "sample": jax.random.key(6)})
    tm.load_state_dict(params_from_flax(variables["params"], stats, tm))
    tm.eval()
    kwargs = {}
    if "sample" in tspec.rngs:
        kwargs["sample"] = _t(z)
    if "gp" in tspec.rngs:
        kwargs["gp"] = _t(uniform)
    with torch.no_grad():
        got = tm(*[_t(a) for a in args], **kwargs)
    return tm, ref, got


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_forward_matches_flax(model, flags, monkeypatch):
    """Every output within 1e-5 of JAX's (of its scale where it exceeds 1:
    the critics' scores), the option's layers under their Flax names."""
    tm, ref, got = _forward_pair(model, flags, monkeypatch=monkeypatch)
    names = {n for n, _ in tm.named_modules()}
    assert any(n.endswith("enc_conv_0_s2d") for n in names) == (
        "spaceToDepthStem" in FLAGS[flags])
    assert any(n.endswith("dec_conv_d2s_head") for n in names) == (
        "depthToSpaceHead" in FLAGS[flags])
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, err_msg=k,
            atol=1e-5 * max(1.0, float(np.abs(np.asarray(ref[k])).max())))


def test_two_channel_autoencoder_matches_flax(monkeypatch):
    """At C = 2 the packing order matters end to end: the AE with both
    options on two-channel slices."""
    _, ref, got = _forward_pair("autoencoder", "both", channels=2,
                                monkeypatch=monkeypatch)
    assert got["x_hat"].shape == (B, 32, 32, 2)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("model", [
    "gaussian_mixture_variational_autoencoder",
    "constrained_adversarial_autoencoder_Chen"])
def test_registry_ignores_the_options_where_jax_does(model):
    """A model whose constructor does not take the options builds its
    parity architecture, as the JAX registry's ``_std`` and ``_gmvae``
    build it, and does not raise."""
    cfg = Config(model=model, outputWidth=32, outputHeight=32, zDim=Z,
                 intermediateResolutions=(8, 8), dim_c=3, dim_z=Z, dim_w=1)
    plain, _ = registry.get_model(cfg)
    fast, _ = registry.get_model(cfg.replace(**FLAGS["both"]))
    shapes = {k: v.shape for k, v in plain.state_dict().items()}
    assert {k: v.shape for k, v in fast.state_dict().items()} == shapes
    jm, _ = jax_registry.get_model(_jax(cfg.replace(**FLAGS["both"])),
                                   jnp.float32)
    for field in ("space_to_depth_stem", "depth_to_space_head"):
        assert not getattr(jm, field, False)


# ---------------------------------------------------------------------------
# a train step


STEPS = 2
KINK_FRACTION = 1e-4


def test_ae_step_with_both_options_matches_jax():
    """Two AE Adam steps with the stem and the head, each from the JAX
    package's state (parameters, BatchNorm statistics and Adam moments
    converted): the loss within 1e-5, every parameter and running
    statistic within 1e-5 except at most KINK_FRACTION of the elements and
    the BatchNorm-fed biases, which round-off steers (both held to twice
    Adam's largest step, as in ``test_torch_train``)."""
    cfg = _cfg("autoencoder", dropout_rate=0.0, **FLAGS["both"])
    pool = np.random.default_rng(5).uniform(size=(8, 32, 32, 1)).astype(
        np.float32)
    jt = jax_get_trainer("AE")(_jax(cfg))
    jstate = jt.init_state()
    jstep = jax.jit(jt._build_train_step())
    tt = get_trainer("AE")(cfg, device="cpu")
    tt.init_state()
    fed = _bn_fed_biases(tt.model.state_dict())
    assert "encoder.enc_conv_0_s2d.bias" in fed
    for b in range(STEPS):
        tt.model.load_state_dict(params_from_flax(
            jax.device_get(jstate.params), jax.device_get(jstate.batch_stats),
            tt.model))
        tt.optimizer.load_state_dict(adam_state_from_optax(
            jax.device_get(jstate.opt_states["main"]), tt.model,
            tt.optimizer))
        batch = pool[4 * b:4 * b + 4]
        jstate, jm = jstep(jstate, {"x": jnp.asarray(batch)})
        tm = tt.train_step({"x": _t(batch)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        want = params_from_flax(jax.device_get(jstate.params),
                                jax.device_get(jstate.batch_stats), tt.model)
        got = tt.model.state_dict()
        bound = 2 * cfg.learningrate * _adam_step_bound(
            b + 1, cfg.beta1, cfg.beta2) + 1e-6
        off = total = 0
        for k, v in want.items():
            if k.endswith("num_batches_tracked"):
                continue
            diff = (got[k] - v).abs()
            np.testing.assert_array_less(diff.numpy(), bound, err_msg=k)
            if k not in fed:
                off += int((diff > 1e-5).sum())
                total += diff.numel()
        assert off <= KINK_FRACTION * total, (off, total)


# ---------------------------------------------------------------------------
# the CLI


@pytest.mark.parametrize("tpu_fast,parity", [(None, False), (True, False),
                                             (False, False), (None, True)])
def test_resolve_tpu_fast_matches_jax_on_a_non_tpu_backend(tpu_fast,
                                                           parity):
    assert cli.resolve_tpu_fast(tpu_fast, parity) == \
        jax_cli.resolve_tpu_fast(tpu_fast, parity)


def test_parity_with_tpu_fast_exits_as_in_jax():
    for fn in (cli.resolve_tpu_fast, jax_cli.resolve_tpu_fast):
        with pytest.raises(SystemExit, match="mutually exclusive"):
            fn(True, True)
    with pytest.raises(SystemExit):
        cli.main(["--synthetic", "--device", "cpu", "--tpu-fast",
                  "--parity"])


@pytest.mark.parametrize("flags,want", [
    ([], (False, False)), (["--tpu-fast"], (True, True)),
    (["--s2d-stem"], (True, False)), (["--d2s-head"], (False, True)),
    (["--parity", "--s2d-stem"], (True, False))])
def test_cli_options_reach_the_config(flags, want, monkeypatch):
    """With and without ``--preset``, the options land in the config the
    trainer gets, and the default workdir's name carries them."""
    seen = []
    monkeypatch.setattr(cli, "_train_protocol",
                        lambda args, config, *a: seen.append(config) or 0)
    for preset in ([], ["--preset", "AE"]):
        assert cli.main(["--synthetic", "--device", "cpu", *preset,
                         *flags]) == 0
    for config in seen:
        assert (config.spaceToDepthStem, config.depthToSpaceHead) == want
        tag = ("_s2d" if want[0] else "") + ("_d2s" if want[1] else "")
        assert f"_{config.model}{tag}_b" in config.model_dir("SYNTH")


# ---------------------------------------------------------------------------
# a JAX --tpu-fast workdir, converted whole and resumed


def test_tool_converts_a_tpu_fast_workdir_and_the_port_resumes_it(tmp_path):
    """A 1-epoch JAX ``AE`` run with both options becomes the port's
    checkpoint (``tools/jax_workdir_to_torch.py``): weights, BatchNorm
    statistics and Adam moments bit-equal to the converted JAX state, its
    step count and epoch; the port's next step from it equals JAX's next
    step (loss within 1e-5, Adam's step count continued), and ``fit``
    resumes at epoch 1."""
    from test_torch_serving import _load_tool
    from unsupervised_anomaly_detection_brain_mri_tpu.data.synthetic import (
        SYNTH as JaxSYNTH,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu.data.synthetic import (
        SyntheticOptions as JaxSyntheticOptions,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.synthetic import (
        SYNTH,
        SyntheticOptions,
    )

    ds = dict(numPatients=3, imageSize=32, numSlices=8, targetSize=32)
    cfg = _cfg("autoencoder", numEpochs=1, **FLAGS["both"])
    wd = str(tmp_path)
    jt = jax_get_trainer("AE")(_jax(cfg), workdir=wd)
    jt.fit(JaxSYNTH(JaxSyntheticOptions(**ds)))
    _load_tool().convert(wd)
    jstate, epoch = jt.load_checkpoint(jt.init_state())

    tt = get_trainer("AE")(cfg.replace(numEpochs=2), device="cpu",
                           workdir=wd)
    assert tt.restore_training_checkpoint() == epoch == 1
    assert tt.step == int(jstate.step) > 0
    want = params_from_flax(jax.device_get(jstate.params),
                            jax.device_get(jstate.batch_stats), tt.model)
    got = tt.model.state_dict()
    assert "encoder.enc_conv_0_s2d.weight" in got
    assert "decoder.dec_conv_d2s_head.weight" in got
    assert all(torch.equal(got[k], want[k]) for k in want)
    opt = adam_state_from_optax(jax.device_get(jstate.opt_states["main"]),
                                tt.model, tt.optimizer)["state"]
    for i, st in tt.optimizer.state_dict()["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(st[k], opt[i][k]), (i, k)

    x = np.random.default_rng(9).uniform(size=(4, 32, 32, 1)).astype(
        np.float32)
    _, jm = jax.jit(jt._build_train_step())(jstate, {"x": jnp.asarray(x)})
    tm = tt.train_step({"x": _t(x)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert int(tt.optimizer.state_dict()["state"][0]["step"]) == \
        int(jstate.step) + 1

    resumed = get_trainer("AE")(cfg.replace(numEpochs=2), device="cpu",
                                workdir=wd)
    resumed.fit(SYNTH(SyntheticOptions(**ds)))
    assert [h["epoch"] for h in resumed.history] == [0, 0, 1, 1]
