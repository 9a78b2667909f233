"""The port's AE and its layers against the Flax modules, on the same
weights (``models/convert.py::params_from_flax``) and inputs, in float32
on the CPU."""

import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    Config as JaxConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    get_trainer as jax_get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train.state import (
    count_params as jax_count_params,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import Config
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import layers
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.convert import (
    params_from_flax,
)
from unsupervised_anomaly_detection_brain_mri_tpu.models.registry import (
    MODEL_REGISTRY as JAX_MODEL_REGISTRY,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train.registry import (
    TRAINER_REGISTRY as JAX_TRAINER_REGISTRY,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import registry
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.registry import (
    get_model,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
    registry as trainer_registry,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.base import (
    count_params,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _config(size):
    return Config(trainer="AE", model="autoencoder", outputWidth=size,
                  outputHeight=size, zDim=16, compute_dtype="float32")


def _randomised_batch_stats(batch_stats, rng):
    """Non-trivial running statistics, so eval-mode BN is exercised."""
    def draw(path, a):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 2.0, np.shape(a)).astype(np.float32)
        return rng.normal(0.0, 0.3, np.shape(a)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, batch_stats)


@pytest.fixture(scope="module", params=[32, 64])
def jax_ae(request):
    size = request.param
    trainer = jax_get_trainer("AE")(
        JaxConfig.from_json(_config(size).to_json()))
    state = trainer.init_state()
    params = jax.device_get(state.params)
    stats = _randomised_batch_stats(jax.device_get(state.batch_stats),
                                    np.random.default_rng(size))
    return size, trainer, params, stats


def test_autoencoder_matches_flax_eval(jax_ae):
    size, trainer, params, stats = jax_ae
    x = np.random.default_rng(1).uniform(
        size=(3, size, size, 1)).astype(np.float32)
    ref = trainer.model.apply({"params": params, "batch_stats": stats}, x,
                              train=False)
    model, spec = get_model(_config(size))
    model.load_state_dict(params_from_flax(params, stats, model))
    model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert spec.reconstruction_key == "x_hat"
    assert out["x_hat"].dtype == torch.float32
    np.testing.assert_allclose(out["x_hat"].numpy(), np.asarray(ref["x_hat"]),
                               **TOL)
    np.testing.assert_allclose(out["z"].numpy(), np.asarray(ref["z"]), **TOL)


def test_parameter_count_matches_jax(jax_ae):
    size, _, params, _ = jax_ae
    model, _ = get_model(_config(size))
    assert count_params(model) == jax_count_params(params)


def test_full_width_ae_parameter_count():
    model, _ = get_model(Config(trainer="AE", model="autoencoder"))
    enc = [getattr(model.encoder, f"enc_conv_{i}").out_channels
           for i in range(4)]
    dec = [getattr(model.decoder, f"dec_convT_{i}").out_channels
           for i in range(4)]
    assert enc == [32, 64, 128, 128] and dec == [128, 64, 32, 32]
    assert 1.5e6 < count_params(model) < 1.7e6


class _Holder(torch.nn.Module):
    def __init__(self, name, module):
        super().__init__()
        self.add_module(name, module)


@pytest.mark.parametrize("size", [5, 8])
def test_single_conv_transpose_matches_flax(size):
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size + 1, 3)).astype(np.float32)
    flax_ct = fnn.ConvTranspose(4, (5, 5), strides=(2, 2), padding="SAME")
    variables = flax_ct.init(jax.random.key(0), x)
    kernel = rng.normal(size=(5, 5, 3, 4)).astype(np.float32)
    bias = rng.normal(size=(4,)).astype(np.float32)
    ref = flax_ct.apply({"params": {"kernel": kernel, "bias": bias}}, x)
    assert variables["params"]["kernel"].shape == kernel.shape
    port = _Holder("dec_convT_0", layers.ConvTranspose2d(3, 4))
    port.load_state_dict(params_from_flax(
        {"dec_convT_0": {"kernel": kernel, "bias": bias}}, {}, port))
    with torch.no_grad():
        out = port.dec_convT_0(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)


@pytest.mark.parametrize("size,stride", [(7, 2), (8, 2), (7, 1)])
def test_same_conv_matches_flax(size, stride):
    rng = np.random.default_rng(size + stride)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    kernel = rng.normal(size=(5, 5, 3, 4)).astype(np.float32)
    bias = rng.normal(size=(4,)).astype(np.float32)
    ref = fnn.Conv(4, (5, 5), strides=(stride, stride), padding="SAME").apply(
        {"params": {"kernel": kernel, "bias": bias}}, x)
    port = _Holder("enc_conv_0", layers.Conv2d(3, 4, 5, stride))
    port.load_state_dict(params_from_flax(
        {"enc_conv_0": {"kernel": kernel, "bias": bias}}, {}, port))
    with torch.no_grad():
        out = port.enc_conv_0(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)


def test_latent_dropout_uses_generator_and_spares_decoder_dense():
    model, _ = get_model(_config(32))
    model.eval()
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(4, 32, 32, 1)).astype(np.float32))
    with torch.no_grad():
        det = model(x)
        a = model(x, torch.Generator().manual_seed(3))
        b = model(x, torch.Generator().manual_seed(3))
        assert torch.equal(a["x_hat"], b["x_hat"])
        dropped = a["z"] == 0
        assert dropped.any() and (~dropped).any()
        torch.testing.assert_close(a["z"][~dropped],
                                   det["z"][~dropped] / 0.8)
        # the AE quirk: no dropout after dec_dense, so the decoder sees
        # exactly dec_dense(z) of the dropped latent
        bn = model.bottleneck
        dec = bn.dec_dense(a["z"]).reshape((4,) + bn.reshape)
        h = bn.intermediate_conv_reverse(dec.permute(0, 3, 1, 2))
        torch.testing.assert_close(model.decoder(h).permute(0, 2, 3, 1),
                                   a["x_hat"])


def test_bfloat16_compute_keeps_float32_params_and_output():
    model, _ = get_model(_config(32), torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    model.eval()
    with torch.no_grad():
        out = model(torch.rand(2, 32, 32, 1))
    assert out["x_hat"].dtype == torch.float32
    assert out["z"].dtype == torch.float32
    assert torch.isfinite(out["x_hat"]).all()


@pytest.mark.parametrize("field", ["spaceToDepthStem", "depthToSpaceHead"])
def test_non_parity_options_raise(field):
    """The non-parity options are ported: each builds its layer under its
    Flax name (``tests/test_torch_s2d.py`` holds them against JAX) and no
    longer raises."""
    model, _ = get_model(_config(32).replace(**{field: True}))
    name = {"spaceToDepthStem": "encoder.enc_conv_0_s2d",
            "depthToSpaceHead": "decoder.dec_conv_d2s_head"}[field]
    assert name in dict(model.named_modules())
    with torch.no_grad():
        out = model.eval()(torch.rand(2, 32, 32, 1))
    assert out["x_hat"].shape == (2, 32, 32, 1)


@pytest.mark.parametrize("name", ["constrained_adversarial_autoencoder_Chen",
                                  "fanogan", "fanogan_schlegl", "anovaegan"])
def test_last_four_models_build_and_run(name):
    """The four networks that were ported last build through the registry
    with the JAX metadata and run a forward at 32x32."""
    cfg = _config(32).replace(model=name, intermediateResolutions=(4, 4))
    model, spec = get_model(cfg)
    jspec = JAX_MODEL_REGISTRY[name]
    assert (spec.reconstruction_key, spec.takes_prior_z, spec.rngs) == (
        jspec.reconstruction_key, jspec.takes_prior_z, jspec.rngs)
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 32, 32, 1)
    args = (x, torch.randn(2, 16)) if spec.takes_prior_z else (x,)
    model.eval()
    with torch.no_grad():
        out = model(*args, sample=g, gp=g)
    rec = out[spec.reconstruction_key]
    assert rec.shape == x.shape and torch.isfinite(rec).all()


def test_every_jax_network_and_trainer_is_registered():
    """All 16 networks and 12 trainers of the JAX registries, and nothing
    marked as not yet ported."""
    assert sorted(registry.MODEL_REGISTRY) == sorted(JAX_MODEL_REGISTRY)
    assert len(registry.MODEL_REGISTRY) == 16
    assert sorted(trainer_registry.TRAINER_REGISTRY) == sorted(
        JAX_TRAINER_REGISTRY)
    assert len(trainer_registry.TRAINER_REGISTRY) == 12
    for name in JAX_TRAINER_REGISTRY:
        assert trainer_registry.get_trainer(name).__name__ == (
            JAX_TRAINER_REGISTRY[name].__name__)
    assert not hasattr(registry, "NOT_YET_PORTED")
    assert not hasattr(trainer_registry, "NOT_YET_PORTED")


def test_init_state_is_seeded_glorot():
    cfg = _config(32)
    t1 = trainer_registry.get_trainer("AE")(cfg, device="cpu")
    t2 = trainer_registry.get_trainer("AE")(cfg, device="cpu")
    s1 = {k: v.clone() for k, v in t1.init_state().state_dict().items()}
    s2 = t2.init_state(torch.Generator().manual_seed(cfg.seed)).state_dict()
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    w = s1["encoder.enc_conv_1.weight"]  # (64, 32, 5, 5)
    limit = np.sqrt(6.0 / (25 * 32 + 25 * 64))
    assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.9 * limit
    assert not s1["encoder.enc_conv_1.bias"].any()
    assert torch.equal(s1["decoder.dec_norm_in.running_var"],
                       torch.ones(64))
    assert not s1["decoder.dec_norm_in.running_mean"].any()
