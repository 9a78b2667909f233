"""The port's VAE family against the JAX package on the CPU in float32: the
five models on converted weights (eval and train mode, with the same noise
given to both packages and dropout 0), the 4x4 transposed convolution, the
context masks, input restoration, the gradient anomaly map, the lambda
sweep, batched volume restoration, and train steps of VAE, CE and ceVAE.

The packages' random streams cannot be matched, so noise is given: the JAX
side's ``jax.random`` draws are patched inside the test (under ``jit`` the
patch becomes a constant), and the port takes the same numbers through its
noise seam (a tensor as ``sample``) or the same patch of its draw
functions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from hypothesis import given, settings
from hypothesis import strategies as st

from unsupervised_anomaly_detection_brain_mri_tpu.config import Config
from unsupervised_anomaly_detection_brain_mri_tpu.data.synthetic import (
    SYNTH,
    SyntheticOptions,
)
from unsupervised_anomaly_detection_brain_mri_tpu.models import (
    get_model as jax_get_model,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    context as jax_context,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    get_trainer as jax_get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    restoration as jax_restoration,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    losses as JL,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train.state import (
    count_params as jax_count_params,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import (
    layers,
    vae,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.convert import (
    adam_state_from_optax,
    params_from_flax,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.registry import (
    get_model,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
    base as trainer_base,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
    context,
    restoration,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
    losses as TL,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.base import (
    count_params,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)

TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_TOL = dict(rtol=2e-5, atol=1e-5)  # float32 reductions, other order
Z = 16
MODELS = {
    "AE_spatial": "autoencoder_spatial",
    "VAE": "variational_autoencoder",
    "VAE_Zimmerer": "variational_autoencoder_Zimmerer",
    "ceVAE": "context_encoder_variational_autoencoder",
    "ceVAE_Zimmerer": "context_encoder_variational_autoencoder_Zimmerer",
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


def _cfg(model, size=32, **kw):
    base = dict(model=model, outputWidth=size, outputHeight=size, zDim=Z,
                compute_dtype="float32", dropout_rate=0.0, batchsize=4)
    base.update(kw)
    return Config(**base)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tiled(base):
    """Noise of any (n * len(base), Z) shape: ``base`` repeated, so every
    batch and every stack of batches draws the same rows."""
    def noise(shape):
        return np.tile(base, (shape[0] // base.shape[0], 1)).astype(
            np.float32)
    return noise


def _patch_noise(monkeypatch, noise):
    """Both packages' eps draws return ``noise(shape)``."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(noise(tuple(shape))))
    monkeypatch.setattr(vae, "standard_normal",
                        lambda sample, shape, device:
                        _t(noise(tuple(shape))).to(device))


def _randomised_batch_stats(batch_stats, rng):
    def draw(path, a):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 2.0, np.shape(a)).astype(np.float32)
        return rng.normal(0.0, 0.3, np.shape(a)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, batch_stats)


def _flax_variables(model, spec, x):
    args = (x, x) if spec.takes_context else (x,)
    return jax.device_get(model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1),
         "sample": jax.random.key(2)}, *args, train=True, dropout=False))


# ---------------------------------------------------------------------------
# models


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("preset", sorted(MODELS))
def test_model_matches_flax(preset, train):
    """One forward on converted weights with the same eps: every output,
    and in train mode every BatchNorm's running statistics after the call
    (the ceVAE's encoder and decoder run twice, over x and the masked
    x_ce, and Flax moves the statistics twice in that order)."""
    cfg = _cfg(MODELS[preset])
    jm, spec = jax_get_model(cfg, jnp.float32)
    rng = np.random.default_rng(sorted(MODELS).index(preset))
    x = rng.uniform(size=(3, 32, 32, 1)).astype(np.float32)
    args = (x, x * (rng.uniform(size=x.shape) > 0.3)) if spec.takes_context \
        else (x,)
    variables = _flax_variables(jm, spec, x)
    stats = _randomised_batch_stats(variables.get("batch_stats", {}), rng)
    noise = rng.normal(size=(3, Z)).astype(np.float32)
    real_normal = jax.random.normal
    jax.random.normal = lambda key, shape, dtype=jnp.float32: jnp.asarray(
        noise)
    try:
        out = jm.apply({"params": variables["params"], "batch_stats": stats},
                       *args, train=train, rngs={"sample": jax.random.key(3)},
                       mutable=["batch_stats"] if train else False)
    finally:
        jax.random.normal = real_normal
    ref, mutated = out if train else (out, None)
    tm, tspec = get_model(cfg)
    assert (tspec.reconstruction_key, tspec.takes_context) == (
        spec.reconstruction_key, spec.takes_context)
    assert tspec.rngs == spec.rngs
    tm.load_state_dict(params_from_flax(variables["params"], stats))
    tm.train(train)
    with torch.no_grad():
        got = tm(*[_t(a) for a in args], sample=_t(noise))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)
    if train and stats:
        want = params_from_flax(variables["params"],
                                jax.device_get(mutated["batch_stats"]))
        state = tm.state_dict()
        keys = [k for k in want if k.endswith(("running_mean",
                                               "running_var"))]
        assert keys
        for k in keys:
            np.testing.assert_allclose(state[k].numpy(), want[k].numpy(),
                                       err_msg=k, **TOL)


@pytest.mark.parametrize("preset", sorted(MODELS))
def test_parameter_count_matches_jax(preset):
    """At 32x32 and at the published 128x128 (shapes only on the JAX
    side)."""
    for size in (32, 128):
        cfg = _cfg(MODELS[preset], size, zDim=128)
        jm, spec = jax_get_model(cfg, jnp.float32)
        x = jnp.zeros((2, size, size, 1))
        args = (x, x) if spec.takes_context else (x,)
        shapes = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.key(0), "sample": jax.random.key(1)},
            *args, train=True))
        assert count_params(get_model(cfg)[0]) == jax_count_params(
            shapes["params"]), size


@pytest.mark.parametrize("size", [4, 7])
def test_single_conv_transpose_4x4_matches_flax(size):
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size + 1, 3)).astype(np.float32)
    kernel = rng.normal(size=(4, 4, 3, 5)).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    ref = fnn.ConvTranspose(5, (4, 4), strides=(2, 2), padding="SAME").apply(
        {"params": {"kernel": kernel, "bias": bias}}, x)
    holder = torch.nn.Module()
    holder.add_module("dec_convT_1", layers.ConvTranspose2d(3, 5, 4))
    holder.load_state_dict(params_from_flax(
        {"dec_convT_1": {"kernel": kernel, "bias": bias}}, {}))
    with torch.no_grad():
        out = holder.dec_convT_1(_t(x).permute(0, 3, 1, 2))
    assert out.shape[-2:] == (2 * size, 2 * (size + 1))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)


def test_vae_draws_eps_in_eval_mode_and_checks_given_noise():
    model, _ = get_model(_cfg("variational_autoencoder", dropout_rate=0.5))
    model.eval()
    x = torch.rand(2, 32, 32, 1)
    with torch.no_grad():
        a = model(x, sample=torch.Generator().manual_seed(0))
        b = model(x, sample=torch.Generator().manual_seed(0))
        c = model(x, sample=torch.Generator().manual_seed(1))
        assert torch.equal(a["x_hat"], b["x_hat"])
        assert not torch.equal(a["x_hat"], c["x_hat"])
        with pytest.raises(ValueError, match="generator or the noise"):
            model(x)
        with pytest.raises(ValueError, match="shape"):
            model(x, sample=torch.zeros(3, Z))
        with pytest.raises(TypeError, match="never dropout"):
            model(x, dropout_generator=torch.zeros(2, Z),
                  sample=torch.zeros(2, Z))


def test_volume_generators_draw_each_volume_at_its_own_shape():
    counts, rows = [3, 1, 2], 3
    for fn in (torch.randn, torch.rand):
        src = layers.VolumeGenerators(
            [torch.Generator().manual_seed(k) for k in range(3)], counts,
            rows)
        got = layers.draw(fn, src, (9, 5), torch.device("cpu"))
        for k, n in enumerate(counts):
            alone = fn((n, 5), generator=torch.Generator().manual_seed(k))
            block = got[k * rows: (k + 1) * rows]
            assert torch.equal(block[:n], alone)
            assert not block[n:].any()
    with pytest.raises(ValueError):
        layers.draw(torch.rand, src, (8, 5), torch.device("cpu"))


# ---------------------------------------------------------------------------
# context masks


def _masks(rng, b, size=64):
    m = np.zeros((b, size, size), np.float32)
    for i in range(b):
        r0, c0 = rng.integers(0, 12, 2)
        r1, c1 = rng.integers(40, size, 2)
        m[i, r0:r1, c0:c1] = 1.0
    return m


def test_context_masks_match_jax_on_the_same_draws(monkeypatch):
    rng = np.random.default_rng(0)
    b = 6
    images = rng.uniform(0.1, 1.0, size=(b, 64, 64, 1)).astype(np.float32)
    masks = _masks(rng, b)
    masks[5] = 0.0  # an empty mask: the bbox is the whole image
    masks[4, :, :] = 0.0
    masks[4, 10:25, 10:25] = 1.0  # a bbox too small for a 20x20 box
    n_boxes = rng.integers(1, 4, size=b).astype(np.int32)
    u = rng.uniform(size=(b, 3, 2)).astype(np.float32)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(n_boxes))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(u))
    ref = np.asarray(jax_context.random_context_masks(
        jax.random.key(0), jnp.asarray(images), jnp.asarray(masks)))
    got = context.apply_context_masks(_t(images), _t(masks), _t(n_boxes),
                                      _t(u)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.array_equal(got[4], images[4])
    for mine, ref_ in zip(context.brain_bbox(_t(masks > 0)),
                          jax_context.brain_bbox(jnp.asarray(masks > 0))):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref_))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), b=st.integers(1, 5))
def test_context_masks_zero_one_to_three_boxes_in_the_brain_bbox(seed, b):
    rng = np.random.default_rng(seed)
    masks = _t(_masks(rng, b))
    images = torch.ones(b, 64, 64, 1)
    out = context.random_context_masks(
        torch.Generator().manual_seed(seed), images, masks)[..., 0]
    r0, r1, c0, c1 = context.brain_bbox(masks > 0)
    for i in range(b):
        zero = (out[i] == 0).numpy()
        rows, cols = np.nonzero(zero)
        assert rows.min() >= int(r0[i]) and rows.max() < int(r1[i])
        assert cols.min() >= int(c0[i]) and cols.max() < int(c1[i])
        # a union of 1-3 boxes of 20x20: between one box and three
        assert 400 <= zero.sum() <= 1200
        # every zeroed pixel lies in a full 20x20 zero box
        for r, c in zip(rows[:: max(1, len(rows) // 20)],
                        cols[:: max(1, len(cols) // 20)]):
            assert any(zero[max(0, r - dr): r - dr + 20,
                            max(0, c - dc): c - dc + 20].sum() == 400
                       for dr in range(20) for dc in range(20)
                       if r - dr >= 0 and c - dc >= 0)


def test_each_sample_gets_its_own_context_mask():
    masks = _t(np.ones((4, 64, 64), np.float32))
    out = context.random_context_masks(torch.Generator().manual_seed(3),
                                       torch.ones(4, 64, 64, 1), masks)
    holes = [(out[i, ..., 0] == 0) for i in range(4)]
    assert all(h.any() for h in holes)
    assert len({tuple(h.flatten().tolist()) for h in holes}) == 4


# ---------------------------------------------------------------------------
# restoration


@pytest.fixture(scope="module")
def vae_pair():
    """JAX VAE_You and ceVAE trainers at 32x32 (dropout 0, restore_steps 4)
    and the port's twins on the same converted weights."""
    out = {}
    for trainer, model in (("VAE_You", "variational_autoencoder"),
                           ("ceVAE",
                            "context_encoder_variational_autoencoder")):
        cfg = _cfg(model, trainer=trainer, restore_steps=4, restore_lr=1e-2,
                   tv_lambda=0.7, use_gradient_based_restoration=0.1)
        jt = jax_get_trainer(trainer)(cfg)
        js = jt.init_state()
        stats = _randomised_batch_stats(jax.device_get(js.batch_stats),
                                        np.random.default_rng(4))
        js = js.replace(batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                           stats))
        tt = get_trainer(trainer)(cfg)
        tt.model.load_state_dict(params_from_flax(
            jax.device_get(js.params), stats))
        out[trainer] = (cfg, jt, js, tt)
    return out


def _x(b=4, seed=5):
    return np.random.default_rng(seed).uniform(size=(b, 32, 32, 1)).astype(
        np.float32)


def test_restore_inputs_matches_jax(vae_pair, monkeypatch):
    cfg, jt, js, tt = vae_pair["VAE_You"]
    x = _x()
    _patch_noise(monkeypatch, _tiled(
        np.random.default_rng(6).normal(size=(4, Z))))
    variables = {"params": js.params, "batch_stats": js.batch_stats}
    ref = jax_restoration.restore_inputs(
        jt._restoration_fn(variables), jnp.asarray(x), jnp.float32(0.7),
        cfg.restore_lr, cfg.restore_steps)
    got = restoration.restore_inputs(tt._restoration_fn(False), _t(x), 0.7,
                                     cfg.restore_lr, cfg.restore_steps,
                                     torch.Generator())
    assert float(np.abs(np.asarray(ref) - x).max()) > 1e-3  # it moved
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the trainer's reconstruction is the same restoration
    rec = tt.reconstruct_device(_t(x))["reconstruction"]
    np.testing.assert_allclose(rec.numpy(), np.asarray(ref), **TOL)
    jrec = jt.reconstruct_device(js, jnp.asarray(x))["reconstruction"]
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), **TOL)


def test_gradient_anomaly_map_matches_jax(vae_pair, monkeypatch):
    cfg, jt, js, tt = vae_pair["ceVAE"]
    x = _x(seed=7)
    _patch_noise(monkeypatch, _tiled(
        np.random.default_rng(8).normal(size=(4, Z))))
    variables = {"params": js.params, "batch_stats": js.batch_stats}

    def apply(xi):
        return jt.model.apply(variables, xi, xi, train=False,
                              rngs={"sample": jax.random.key(0)})

    def loss_vae(xi):
        o = apply(xi)
        return (JL.sum_per_sample(JL.l1_elem(xi, o["x_hat"]))
                + JL.vae_kl(o["z_mu"], o["z_sigma"]))

    xj = jnp.asarray(x)
    l1_vae = JL.l1_elem(xj, apply(xj)["x_hat"])
    ref = jax_restoration.gradient_anomaly_map(loss_vae, l1_vae, xj)

    def outputs_fn(xi):
        o = tt.model.eval()(xi, xi, sample=torch.Generator())
        return (TL.sum_per_sample(TL.l1_elem(xi, o["x_hat"]))
                + TL.vae_kl(o["z_mu"], o["z_sigma"]), o["x_hat"])

    got, _ = restoration.gradient_anomaly_map(outputs_fn, _t(x))
    assert float(np.abs(np.asarray(ref)).max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # and the ceVAE trainers' reconstructions, x - 0.1 * map
    want = jt.reconstruct_device(js, xj)["reconstruction"]
    rec = tt.reconstruct_device(_t(x))["reconstruction"]
    np.testing.assert_allclose(rec.numpy(), np.asarray(want), **TOL)


def test_lambda_sweep_matches_jax(vae_pair, monkeypatch, tmp_path):
    """The batched sweep's per-lambda errors against the JAX package's
    sequential ones (1e-5 relative), and the chosen lambda wherever the
    two smallest errors differ by more than that."""
    cfg, jt, js, tt = vae_pair["VAE_You"]
    bs = cfg.batchsize
    _patch_noise(monkeypatch, _tiled(
        np.random.default_rng(9).normal(size=(bs, Z))))
    ds = SYNTH(SyntheticOptions(numPatients=3, imageSize=32, numSlices=16,
                                targetSize=32,
                                partition={"TRAIN": 0.0, "VAL": 1.0,
                                           "TEST": 0.0}))
    arr = ds.slices("VAL")
    n_batches = max(1, int((len(arr) // bs) * 0.2))
    assert n_batches >= 2
    batches = jnp.asarray(arr[: n_batches * bs].reshape(
        n_batches, bs, *arr.shape[1:]))
    variables = {"params": js.params, "batch_stats": js.batch_stats}
    outputs_fn = jt._restoration_fn(variables)
    lambdas = jnp.arange(20, dtype=jnp.float32) / 10.0

    @jax.jit
    def errors(bb):
        def for_lambda(lam):
            def one(b):
                r = jax_restoration.restore_inputs(
                    outputs_fn, b, lam, cfg.restore_lr, cfg.restore_steps)
                return jnp.sum(jnp.abs(b - r))
            return jnp.mean(jax.lax.map(one, bb))
        return jax.lax.map(for_lambda, lambdas)

    ref = np.asarray(errors(batches))
    got = tt.lambda_sweep_errors(
        _t(np.asarray(batches).reshape(-1, 32, 32, 1)),
        torch.arange(20, dtype=torch.float32) / 10.0, n_batches).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert np.ptp(ref) > 0
    jt.workdir, tt.workdir = None, str(tmp_path)
    want = jt.determine_best_lambda(ds, js)
    best = tt.determine_best_lambda(ds)
    two = np.sort(ref)[:2]
    if two[1] - two[0] > 1e-5 * two[0]:
        assert best == pytest.approx(want)
    assert best == pytest.approx(float(np.argmin(got)) / 10.0)
    assert (tmp_path / "tv_lambda.json").is_file()


def test_lambda_sweep_chunks_equal_one_restoration(monkeypatch):
    """The sweep restored in chunks (one (lambda, batch) pair each, or an
    uneven split of three pairs) gives the errors of one restoration of
    every pair: each pair draws eps from its own generator seeded 0, and
    the objective is per sample."""
    cfg = _cfg("variational_autoencoder", trainer="VAE_You",
               restore_steps=3, tv_lambda=0.5)
    tt = get_trainer("VAE_You")(cfg)
    tt.init_state()
    x = _t(_x(2 * cfg.batchsize, seed=13))
    lambdas = torch.arange(20, dtype=torch.float32) / 10.0
    monkeypatch.setattr(trainer_base, "SWEEP_CHUNK_SLICES", 10 ** 6)
    whole = tt.lambda_sweep_errors(x, lambdas, 2)
    assert np.ptp(whole.numpy()) > 0
    for chunk in (cfg.batchsize, 3 * cfg.batchsize):
        monkeypatch.setattr(trainer_base, "SWEEP_CHUNK_SLICES", chunk)
        got = tt.lambda_sweep_errors(x, lambdas, 2)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5)


def test_batched_volume_restoration_equals_per_volume_calls():
    """Padded stacks with dropout on: each volume draws from its own
    generator at its own shape, so the stack equals per-volume calls."""
    cfg = _cfg("variational_autoencoder", trainer="VAE_You",
               restore_steps=3, tv_lambda=0.5, dropout_rate=0.5)
    tt = get_trainer("VAE_You")(cfg)
    tt.init_state()
    rng = np.random.default_rng(10)
    counts = [5, 2, 4]
    vols = np.zeros((3, 5, 32, 32, 1), np.float32)
    for k, n in enumerate(counts):
        vols[k, :n] = rng.uniform(size=(n, 32, 32, 1))
    for dropout in (False, True):
        got = tt.reconstruct_volumes_device(
            _t(vols), dropout=dropout, counts=counts,
            generators=[torch.Generator().manual_seed(k) for k in range(3)],
        )["reconstruction"]
        for k, n in enumerate(counts):
            alone = tt.reconstruct_device(
                _t(vols[k, :n]), dropout=dropout,
                generator=torch.Generator().manual_seed(k))["reconstruction"]
            np.testing.assert_allclose(got[k, :n].numpy(), alone.numpy(),
                                       atol=1e-6, rtol=1e-6)
        # different generators give different restorations
        assert not torch.equal(got[0, :2], got[1, :2])


# ---------------------------------------------------------------------------
# training


def _pool(b, size=64, seed=11):
    rng = np.random.default_rng(seed)
    return {"x": rng.uniform(size=(b, size, size, 1)).astype(np.float32),
            "mask": _masks(rng, b, size)}


def _load_jax_state(tt, js):
    tt.model.load_state_dict(params_from_flax(
        jax.device_get(js.params), jax.device_get(js.batch_stats)))
    tt.optimizer.load_state_dict(adam_state_from_optax(
        jax.device_get(js.opt_states["main"]), tt.model, tt.optimizer))


@pytest.mark.parametrize("trainer,model", [
    ("VAE", "variational_autoencoder"),
    ("CE", "autoencoder"),
    ("ceVAE", "context_encoder_variational_autoencoder"),
])
def test_train_steps_match_jax(trainer, model, monkeypatch):
    """Three Adam steps, each from the JAX package's state at that step
    (parameters, BatchNorm statistics and Adam moments converted), with the
    same eps and the same context-mask draws, dropout 0: the TRAIN and VAL
    losses agree within 1e-5 relative (their terms, such as the KL that
    cancels in its sum, within the float32 tolerance of
    ``tests/test_torch_train.py``), and each step's update of the whole
    parameter vector agrees within 5 % (L2; a (Leaky)ReLU kink can flip a
    few elements' Adam steps, ``ROADMAP.md`` section 3)."""
    cfg = _cfg(model, 64, trainer=trainer, batchsize=4)
    rng = np.random.default_rng(12)
    _patch_noise(monkeypatch, _tiled(rng.normal(size=(4, Z))))
    n_boxes = np.array([1, 3, 2, 2], np.int32)
    u = rng.uniform(size=(4, 3, 2)).astype(np.float32)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(n_boxes))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(u))
    monkeypatch.setattr(context, "context_mask_draws",
                        lambda g, b, m, device: (_t(n_boxes), _t(u)))
    jt = jax_get_trainer(trainer)(cfg)
    js = jt.init_state()
    tt = get_trainer(trainer)(cfg)
    tt.init_state()
    jstep = jax.jit(jt._build_train_step())
    jval = jax.jit(jt._build_val_step())
    pool = _pool(12)
    for b in range(3):
        batch = {k: v[4 * b: 4 * b + 4] for k, v in pool.items()}
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        tbatch = {k: _t(v) for k, v in batch.items()}
        _load_jax_state(tt, js)
        start = params_from_flax(jax.device_get(js.params), {})
        _, jv = jval(js, jbatch)
        js, jm = jstep(js, jbatch)
        tv = tt.val_step(tbatch)
        tm = tt.train_step(tbatch)
        assert set(tm) == set(jm) and set(tv) == set(jv)
        for k in jm:
            tol = dict(rtol=1e-5) if k == "loss" else LOSS_TOL
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **tol,
                                       err_msg=f"{k} step {b}")
            np.testing.assert_allclose(float(tv[k]), float(jv[k]), **tol,
                                       err_msg=f"VAL {k} step {b}")
        want = params_from_flax(jax.device_get(js.params), {})
        got = dict(tt.model.named_parameters())
        d_jax = torch.cat([(want[k] - start[k]).flatten() for k in want])
        d_err = torch.cat([(got[k].detach() - want[k]).flatten()
                           for k in want])
        assert float(d_err.norm()) <= 0.05 * float(d_jax.norm()), b
        if trainer != "VAE":
            masked = tt.model_inputs(tbatch, train=True)[-1]
            assert bool((masked == 0).any()) and not bool(
                (tbatch["x"] == 0).any())
