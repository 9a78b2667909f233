"""The port's ResNet pieces against the JAX package on the CPU in float32:
the spatial LayerNorm (also at mean 50), the stride-2 k3 and k1 transposed
convolutions, the three ResNet blocks, both ResNet stacks, the converter's
choice of kernel layout by module type (fault F1), Chen's constrained AAE
and one ``ConstrainedAAE`` batch of it.

Inputs come from numpy seeds at 32x32 (batch <= 4, ResNet ``dim`` 8: the
registries always build ``dim`` 64, so the modules are built directly or
the registries' builders are patched).  Tolerance 1e-5 (``TOL``); for a
model's outputs 1e-5 of each output's largest magnitude where it exceeds 1
(``assert_scaled_close``), each stage on the same input: Chen chains
encoder -> decoder -> encoder, and each stage carries the float32
summation-order difference of its input further (z_ 3e-6 relative apart
gives x_hat 3e-5 apart where |x_hat| reaches 5); a trainer's losses 2e-5
relative, its parameters as
``test_torch_gmvae.assert_step_matches`` holds them, the critic's Adam
moments within 1e-5 and those of the groups whose gradients cross the
LayerNorms within ``MOMENT_RTOL`` of each tensor's scale (the LayerNorm's
float32 gradient is ill-conditioned where the mean is large against the
spread, in both packages).  The prior latent and
the scalar interpolate eps are given to both sides through patches of the
draws."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from test_torch_aae import _assert_adam_states, _batch, _load, _patch_draws
from test_torch_gmvae import _adam_step_bound, assert_step_matches
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    Config as JaxConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu.models import (
    chen as jax_chen,
)
from unsupervised_anomaly_detection_brain_mri_tpu.models import (
    fanogan as jax_fanogan,
)
from unsupervised_anomaly_detection_brain_mri_tpu.models import (
    layers as jax_layers,
)
from unsupervised_anomaly_detection_brain_mri_tpu.models import (
    registry as jax_registry,
)
from unsupervised_anomaly_detection_brain_mri_tpu.models import (
    resnet as jax_resnet,
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
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import Config
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import (
    chen,
    fanogan,
    layers,
    registry,
    resnet,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.convert import (
    adam_state_from_optax,
    params_from_flax,
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
# Adam moments of the groups whose gradients cross the LayerNorms, as a
# fraction of each tensor's largest element
MOMENT_RTOL = {"ae": 1e-4, "gen": 1e-5}
DIM = 8
Z = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes in several worker processes: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _holder(name, module):
    holder = torch.nn.Module()
    holder.add_module(name, module)
    return holder


def _flax_params(module, *args):
    return jax.device_get(module.init(jax.random.key(0), *args))["params"]


def _randomise(params, rng):
    """The 1-D leaves (LayerNorm scales, biases) moved away from their
    initial 1 and 0; the Glorot kernels kept."""
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.3 * rng.normal(size=np.shape(a))
                   ).astype(np.float32) if np.ndim(a) == 1 else a, params)


def assert_scaled_close(got, ref, err_msg=""):
    """Within 1e-5 relative, or 1e-5 of max(1, max |ref|) absolute."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())),
                               err_msg=err_msg)


# ---------------------------------------------------------------------------
# LayerNorm


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (3, 5, 7, 6)])
def test_spatial_layernorm_matches_flax(shape):
    """The JAX package's ``Norm(use_batchnorm=False)`` (its ``LayerNorm_0``
    level dropped by the converter) on conv-like inputs, float32 and
    bfloat16 compute."""
    rng = np.random.default_rng(sum(shape))
    x = (0.3 + 1.5 * rng.normal(size=shape)).astype(np.float32)
    norm = jax_layers.Norm(use_batchnorm=False)
    params = _randomise(jax.device_get(norm.init(
        jax.random.key(0), x, train=True))["params"], rng)
    assert set(params) == {"LayerNorm_0"}
    ref = norm.apply({"params": params}, x, train=True)
    port = _holder("norm", layers.make_norm(shape[-1], use_batchnorm=False))
    port.load_state_dict(params_from_flax({"norm": params}, {}, port))
    with torch.no_grad():
        got = port.norm(_nchw(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)
    with torch.no_grad():
        half = port.norm(_nchw(x).to(torch.bfloat16))
    assert half.dtype == torch.bfloat16
    ref16 = jax_layers.Norm(use_batchnorm=False, dtype=jnp.bfloat16).apply(
        {"params": params}, jnp.asarray(x, jnp.bfloat16), train=True)
    # one bfloat16 rounding apart at most
    np.testing.assert_allclose(_nhwc(half.float()),
                               np.asarray(ref16, np.float32), rtol=2 ** -7,
                               atol=2 ** -7)


def test_spatial_layernorm_at_mean_50_matches_flax():
    """x = 50 + N(0, 1) per channel over 8 x 8, on a grid of 1/8 so that
    every float32 sum of x and x^2 is exact in any order: the port's
    output within 1e-5 of Flax's.  The two-pass variance (exact in
    float64) lies more than 1e-5 away: at this mean Flax's
    var = max(0, E[x^2] - E[x]^2) keeps the rounding of E[x]^2, and the
    port's formula reproduces it."""
    rng = np.random.default_rng(50)
    x = (50.0 + np.round(8 * rng.normal(size=(3, 8, 8, 6))) / 8).astype(
        np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    ln = fnn.LayerNorm(reduction_axes=(-3, -2), feature_axes=-1,
                       epsilon=1e-3)
    ref = np.asarray(ln.apply({"params": {"scale": scale, "bias": bias}}, x))
    port = _holder("ln1", layers.SpatialLayerNorm(6))
    port.load_state_dict(params_from_flax(
        {"ln1": {"scale": scale, "bias": bias}}, {}, port))
    with torch.no_grad():
        got = _nhwc(port.ln1(_nchw(x)))
    np.testing.assert_allclose(got, ref, **TOL)
    x64 = x.astype(np.float64)
    mean = x64.mean((1, 2), keepdims=True)
    var = np.square(x64 - mean).mean((1, 2), keepdims=True)
    exact = (x64 - mean) / np.sqrt(var + 1e-3) * scale + bias
    assert np.abs(exact - ref).max() > 1e-5


def _layernorm_input_grads(x, ct):
    """d<LN(x), ct>/dx of the unit-scale spatial LayerNorm: JAX's and the
    port's in float32, and the float64 one of the same formula."""
    ln = fnn.LayerNorm(reduction_axes=(-3, -2), feature_axes=-1,
                       epsilon=1e-3)
    params = ln.init(jax.random.key(0), x)
    _, vjp = jax.vjp(lambda a: ln.apply(params, a), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(ct))
    xt = _nchw(x).requires_grad_(True)
    layers.SpatialLayerNorm(x.shape[-1])(xt).backward(_nchw(ct))
    x64 = _nchw(x).double().requires_grad_(True)
    mean = x64.mean((2, 3), keepdim=True)
    var = torch.clamp(torch.square(x64).mean((2, 3), keepdim=True)
                      - torch.square(mean), min=0.0)
    ((x64 - mean) * torch.rsqrt(var + 1e-3)).backward(_nchw(ct).double())
    return np.asarray(ref), _nhwc(xt.grad), _nhwc(x64.grad)


@pytest.mark.parametrize("mean", [0.0, 50.0])
def test_spatial_layernorm_gradient_conditioning(mean):
    """The input gradient of the fast-variance LayerNorm: at mean 0 the
    port's within 1e-5 of JAX's; at mean 50 over 4 x 4 both packages'
    float32 gradients lie more than 1e-4 of the gradient's scale from the
    float64 one (the E[x^2] - E[x]^2 cancellation), so where a ResNet's
    activations have a large mean against their spread, a float32 step
    compared across the packages carries that error (Chen's AE moments,
    ``MOMENT_RTOL``)."""
    rng = np.random.default_rng(int(mean) + 1)
    x = (mean + rng.normal(size=(4, 4, 4, 64))).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    ref, got, exact = _layernorm_input_grads(x, ct)
    scale = float(np.abs(exact).max())
    if mean == 0.0:
        np.testing.assert_allclose(got, ref, **TOL)
        assert np.abs(ref - exact).max() < 1e-5 * scale
    else:
        assert np.abs(ref - exact).max() > 1e-4 * scale
        assert np.abs(got - exact).max() > 1e-4 * scale


# ---------------------------------------------------------------------------
# transposed convolutions at stride 2


@pytest.mark.parametrize("h,w", [(4, 4), (5, 7)])
@pytest.mark.parametrize("k", [3, 1])
def test_stride2_conv_transpose_matches_flax(k, h, w):
    """k3 s2 (lax pads the dilated input by (2, 1)) and k1 s2 ((0, 1))
    against ``flax.linen.ConvTranspose(padding="SAME")``: output 2x."""
    assert layers.convt_same_pads(k, 2) == {3: (2, 1), 1: (0, 1)}[k]
    rng = np.random.default_rng(10 * k + h + w)
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    kernel = rng.normal(size=(k, k, 3, 5)).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    ref = fnn.ConvTranspose(5, (k, k), strides=(2, 2), padding="SAME").apply(
        {"params": {"kernel": kernel, "bias": bias}}, x)
    port = _holder("shortcut", layers.ConvTranspose2d(3, 5, k, stride=2))
    port.load_state_dict(params_from_flax(
        {"shortcut": {"kernel": kernel, "bias": bias}}, {}, port))
    with torch.no_grad():
        out = port.shortcut(_nchw(x))
    assert out.shape[-2:] == (2 * h, 2 * w)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# ResNet blocks and stacks


BLOCKS = {
    "down": (lambda: jax_resnet.ResBlockDown(12),
             lambda: resnet.ResBlockDown(6, 12)),
    "same": (lambda: jax_resnet.ResBlockSame(6),
             lambda: resnet.ResBlockSame(6)),
    "same_transposed": (lambda: jax_resnet.ResBlockSame(
        6, transpose_second=True),
        lambda: resnet.ResBlockSame(6, transpose_second=True)),
    "up": (lambda: jax_resnet.ResBlockUp(4), lambda: resnet.ResBlockUp(6, 4)),
}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_resnet_block_matches_flax(kind):
    rng = np.random.default_rng(len(kind))
    x = rng.normal(size=(2, 8, 8, 6)).astype(np.float32)
    jblock, tblock = (make() for make in BLOCKS[kind])
    params = _randomise(_flax_params(jblock, x), rng)
    ref = jblock.apply({"params": params}, x)
    port = _holder("block", tblock)
    port.load_state_dict(params_from_flax({"block": params}, {}, port))
    with torch.no_grad():
        got = port.block(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


def _stack(kind):
    if kind == "encoder":
        return (jax_resnet.ResNetEncoder(DIM), resnet.ResNetEncoder(DIM),
                (2, 32, 32, 1))
    return (jax_resnet.ResNetDecoder(DIM, final_tanh=kind == "decoder_tanh"),
            resnet.ResNetDecoder(DIM, final_tanh=kind == "decoder_tanh"),
            (2, 4, 4, 8 * DIM))


@pytest.mark.parametrize("kind", ["encoder", "decoder", "decoder_tanh"])
def test_resnet_stack_matches_flax(kind):
    """A JAX ResNet stack's tree through ``params_from_flax``: its
    ``conv2`` and ``shortcut`` transposed convolutions are flipped because
    their torch modules are ``ConvTranspose2d``, whatever their names
    (fault F1)."""
    jm, tm, shape = _stack(kind)
    rng = np.random.default_rng(len(kind) + 3)
    x = rng.normal(size=shape).astype(np.float32)
    params = _randomise(_flax_params(jm, x), rng)
    ref = np.asarray(jm.apply({"params": params}, x))
    tm.load_state_dict(params_from_flax(params, {}, tm))
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)
    if kind == "decoder":
        # the k3 s1 f -> f ConvT named ``conv2``: flipped and in/out
        # swapped; laid out as a Conv2d (the name rule) the output is wrong
        kernel = params["res1"]["conv2"]["kernel"]
        w = tm.res1.conv2.weight.detach().numpy()
        np.testing.assert_array_equal(w, kernel[::-1, ::-1].transpose(
            2, 3, 0, 1))
        with torch.no_grad():
            tm.res1.conv2.weight.copy_(_t(kernel.transpose(3, 2, 0, 1)))
            wrong = _nhwc(tm(_nchw(x)))
        assert np.abs(wrong - ref).max() > 1e-2


def test_converter_rejects_a_kernel_of_the_wrong_module():
    """A 4-D kernel for a Dense, or a path with no torch module, raises."""
    holder = _holder("dense", layers.Linear(4, 4))
    with pytest.raises(ValueError, match="Linear"):
        params_from_flax({"dense": {"kernel": np.zeros((3, 3, 4, 4))}}, {},
                         holder)
    with pytest.raises(ValueError, match="no module"):
        params_from_flax({"conv": {"kernel": np.zeros((3, 3, 4, 4))}}, {},
                         holder)


# ---------------------------------------------------------------------------
# Chen's constrained AAE


def _chen_cfg(**kw):
    base = dict(trainer="ConstrainedAAE",
                model="constrained_adversarial_autoencoder_Chen",
                outputWidth=32, outputHeight=32, zDim=Z,
                intermediateResolutions=(16, 16), compute_dtype="float32",
                dropout_rate=0.0, batchsize=4, learningrate=1e-3,
                scale=10.0, rho=1.0)
    base.update(kw)
    return Config(**base)


def small_resnets(monkeypatch, dim=DIM):
    """Both registries build the ResNet models (Chen's and Schlegl's) at
    ``dim``."""
    for name, jcls, tcls in (
            ("constrained_adversarial_autoencoder_Chen",
             jax_chen.ConstrainedAAEChen, chen.ConstrainedAAEChen),
            ("fanogan_schlegl", jax_fanogan.FAnoGANSchlegl,
             fanogan.FAnoGANSchlegl)):
        def build(config, dtype, cls=None):
            return cls(image_size=config.outputWidth,
                       channels=config.numChannels, z_dim=config.zDim,
                       intermediate_resolution=config.intermediateResolutions[
                           0], dropout_rate=config.dropout_rate, dim=dim,
                       dtype=dtype)

        for reg, cls in ((jax_registry.MODEL_REGISTRY, jcls),
                         (registry.MODEL_REGISTRY, tcls)):
            monkeypatch.setitem(reg, name, dataclasses.replace(
                reg[name], build=lambda c, d, cls=cls, b=build: b(c, d, cls)))


@pytest.mark.parametrize("with_z", [True, False], ids=["critic", "plain"])
def test_chen_matches_flax(with_z):
    """Chen on converted weights with a given prior z and scalar eps: each
    output within 1e-5 of its scale, ``x_hat`` and ``z_rec`` stage by stage
    (the port's decoder on JAX's ``z_``, its encoder on JAX's ``x_hat``),
    and the whole chain within 1e-4 of its scale; the interpolate is
    eps * z + (1 - eps) * z_."""
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(3, 32, 32, 1)).astype(np.float32)
    z = rng.normal(size=(3, Z)).astype(np.float32)
    eps = np.float32(rng.uniform())
    jm = jax_chen.ConstrainedAAEChen(image_size=32, z_dim=Z, dim=DIM)
    params = jax.device_get(jm.init({"params": jax.random.key(0),
                                     "gp": jax.random.key(1)}, x, z))[
        "params"]
    real = jax.random.uniform
    jax.random.uniform = lambda key, shape=(), *a, **k: jnp.asarray(eps)
    try:
        ref = jm.apply({"params": params}, x, z if with_z else None,
                       rngs={"gp": jax.random.key(2)})
    finally:
        jax.random.uniform = real
    tm = chen.ConstrainedAAEChen(image_size=32, z_dim=Z, dim=DIM)
    tm.load_state_dict(params_from_flax(params, {}, tm))
    with torch.no_grad():
        got = tm(_t(x), _t(z) if with_z else None, gp=torch.tensor(eps))
        stages = {"x_hat": tm.decode(_t(np.asarray(ref["z_"]))),
                  "z_rec": tm.encode(_t(np.asarray(ref["x_hat"])))}
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32
        assert_scaled_close(stages.get(k, got[k]).numpy(), ref[k], k)
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(ref[k]), rtol=0, err_msg=k,
            atol=1e-4 * max(1.0, float(np.abs(ref[k]).max())))
    if with_z:
        torch.testing.assert_close(
            got["z_hat"], eps * _t(z) + (1 - eps) * got["z_"])


def test_chen_parameter_count_matches_jax():
    """At the preset's 128x128 and dim 64 (shapes only on the JAX side):
    50,582,562."""
    cfg = _chen_cfg(outputWidth=128, outputHeight=128, zDim=128)
    jm, _ = jax_registry.get_model(JaxConfig.from_json(cfg.to_json()),
                                   jnp.float32)
    x, z = jnp.zeros((2, 128, 128, 1)), jnp.zeros((2, 128))
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "gp": jax.random.key(1)}, x, z))
    n = count_params(registry.get_model(cfg)[0])
    assert n == jax_count_params(shapes["params"]) == 50_582_562


def test_chen_batch_step_matches_jax(monkeypatch):
    """One ``ConstrainedAAE`` batch of Chen's model (1 AE update, as in
    epochs >= 6, so that the AE metrics come from the start state; 2 critic
    updates with the penalty at the scalar-eps interpolate; 1 generator
    update) from the JAX state after two batches at lr 5e-5: the metrics,
    every parameter, the three Adam states; the groups are as in JAX
    (``gen`` the ResNet trunk ``encoder.*``, not ``enc_dense``)."""
    small_resnets(monkeypatch)
    cfg = _chen_cfg(learningrate=5e-5)
    monkeypatch.setattr(jax_gan.AAE, "d_iters", 2)
    monkeypatch.setattr(gan.AAE, "d_iters", 2)
    rng = np.random.default_rng(21)
    z = rng.normal(size=(4, Z)).astype(np.float32)
    eps = np.float32(rng.uniform())
    jt = jax_get_trainer(cfg.trainer)(JaxConfig.from_json(cfg.to_json()))
    tt = get_trainer(cfg.trainer)(cfg, device="cpu")
    js = jt.init_state()
    tt.init_state()
    names = [n for n, _ in tt.model.named_parameters()]
    assert tt.groups["ae"] == names
    assert tt.groups["gen"] == [n for n in names if n.startswith("encoder.")]
    assert tt.groups["disc"] == [n for n in names
                                 if n.startswith("discriminator.")]
    _patch_draws(monkeypatch, z, eps, tt)
    monkeypatch.setattr(chen, "uniform",
                        lambda source, shape, device: torch.tensor(eps))
    jstep = jax.jit(jt._build_train_step(ae_iters=1))
    for b in range(2):
        js, _ = jstep(js, {"x": jnp.asarray(_batch(100 + b))})
    x = _batch()
    _load(tt, js)
    tt.epoch = 6
    start = {k: v.clone() for k, v in tt.model.state_dict().items()}
    js, jm = jstep(js, {"x": jnp.asarray(x)})
    tm = tt.train_step({"x": _t(x)})
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-5, err_msg=k)
    want = params_from_flax(jax.device_get(js.params), {}, tt.model)
    got = tt.model.state_dict()
    # the critic's steps 5 and 6 bound every element's moves (an encoder
    # element takes AE step 3 and generator step 3).  A block's conv1 feeds
    # only ln2, and the decoder's last block only ln_out; a LayerNorm
    # removes those biases: their true gradient is 0 and round-off steers
    # their Adam steps, as for the BN-fed conv biases
    fed = {k for k in want if k.endswith(".conv1.bias")} | {
        "decoder.res4.conv2.bias", "decoder.res4.shortcut.bias"}
    assert len(fed) == 10
    assert_step_matches({k: v for k, v in want.items() if k not in fed},
                        got, start, cfg, (5, 6))
    bound = 2 * cfg.learningrate * sum(
        _adam_step_bound(t, cfg.beta1, cfg.beta2) for t in (5, 6)) + 1e-6
    for k in fed:
        assert float((got[k] - want[k]).abs().max()) < bound, k
    opt_states = jax.device_get(js.opt_states)
    _assert_adam_states(opt_states["disc"], tt, "disc")
    # the AE and generator gradients run back through the ResNets'
    # LayerNorms, whose float32 gradient is ill-conditioned
    # (``test_spatial_layernorm_gradient_conditioning``): each moment
    # tensor within MOMENT_RTOL[group] of its largest element, the LN-fed
    # conv1 biases aside
    for group in ("ae", "gen"):
        opt = tt.optimizer[group]
        want = adam_state_from_optax(opt_states[group], tt.model, opt)[
            "state"]
        got = opt.state_dict()["state"]
        names = [n for n, _ in tt.model.named_parameters()
                 if n in set(tt.groups[group])]
        assert set(got) == set(want) and len(names) == len(want)
        for i, name in enumerate(names):
            assert float(got[i]["step"]) == float(want[i]["step"])
            if name in fed:
                continue
            for k in ("exp_avg", "exp_avg_sq"):
                scale = float(want[i][k].abs().max())
                np.testing.assert_allclose(
                    got[i][k].numpy(), want[i][k].numpy(), rtol=0,
                    atol=MOMENT_RTOL[group] * scale + 1e-12,
                    err_msg=f"{group} {name} {k}")
