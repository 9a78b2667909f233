"""The port's GMVAE family against the JAX package on the CPU in float32:
the three networks on converted weights (eval and train mode, with the same
noise given to both packages), the mixture posterior, the stride-1
transposed convolution and the nearest x2 upsample, input restoration, its
batch-size invariance and padded volume stacks, the lambda sweep, train
steps of ``GMVAE`` and ``GMVAE_spatial``, and ``evaluate()`` of a
``GMVAE_spatial`` trainer.

Each forward draws three normals (``w``, ``z``, ``z_wc``).  The packages'
random streams cannot be matched, so the noise is given: on the JAX side
``jax.random.normal`` is patched to return the draw of its shape (the test
dims make the three shapes differ), and the port takes the same numbers
through its noise seam (a dict of tensors by draw name as ``sample``) or
the same patch of ``models/gmvae.py``'s ``standard_normal``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from test_torch_train import (
    KINK_FRACTION,
    TRAJ_PARAM_ATOL,
    _adam_step_bound,
    _bn_fed_biases,
)
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
from unsupervised_anomaly_detection_brain_mri_tpu.models import (
    gmvae as jax_gmvae,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    get_trainer as jax_get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    restoration as jax_restoration,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train.state import (
    count_params as jax_count_params,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
    Config,
    Options,
    PathConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import synthetic
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import (
    gmvae,
    layers,
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
    restoration,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.base import (
    count_params,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)

E = importlib.import_module(
    "unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate")

TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_RTOL = 2e-5
DIMS = dict(dim_c=4, dim_z=3, dim_w=2)  # the three draws' shapes differ
MODELS = {
    "dense": ("GMVAE", "gaussian_mixture_variational_autoencoder"),
    "spatial": ("GMVAE_spatial",
                "gaussian_mixture_variational_autoencoder_spatial"),
    "You": ("GMVAE_spatial", "gaussian_mixture_variational_autoencoder_You"),
}
DRAWS = ("w", "z", "z_wc")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small and the suite runs in several worker
    processes: one intra-op thread per worker keeps them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(kind, size=32, **kw):
    trainer, model = MODELS[kind]
    base = dict(trainer=trainer, model=model, outputWidth=size,
                outputHeight=size, compute_dtype="float32", dropout_rate=0.0,
                batchsize=4, **DIMS)
    base.update(kw)
    return Config(**base)


def _jax(cfg):
    """The JAX package's Config with the same fields as the port's."""
    return JaxConfig.from_json(cfg.to_json())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _latent_hw(kind, size):
    """(h, w) of the spatial latents (the intermediate resolution 8, or a
    quarter of the image for ``GMVAEYou``); () for the dense variant."""
    return {"dense": (), "spatial": (8, 8), "You": (size // 4, size // 4)}[
        kind]


def _draw_shapes(kind, size, b):
    hw = _latent_hw(kind, size)
    d = DIMS
    return {"w": (b, *hw, d["dim_w"]), "z": (b, *hw, d["dim_z"]),
            "z_wc": (b, *hw, d["dim_z"], d["dim_c"])}


def _slice_noise(kind, size, seed):
    """One slice's three draws: the noise of every slice of every call."""
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s[1:]).astype(np.float32)
            for k, s in _draw_shapes(kind, size, 1).items()}


def _tiled(base, n):
    return {k: np.broadcast_to(v, (n,) + v.shape).copy()
            for k, v in base.items()}


def _patch_noise(monkeypatch, base):
    """Both packages' normals: the draw of each shape is ``base`` (one
    slice's noise) repeated over the batch."""
    by_shape = {v.shape: v for v in base.values()}
    assert len(by_shape) == len(DRAWS)

    def jax_normal(key, shape, dtype=jnp.float32):
        shape = tuple(shape)
        return jnp.asarray(np.broadcast_to(by_shape[shape[1:]], shape))

    def port_normal(sample, shape, device, name=None):
        assert base[name].shape == tuple(shape[1:])
        return _t(np.broadcast_to(base[name], tuple(shape)).copy()).to(
            device)

    monkeypatch.setattr(jax.random, "normal", jax_normal)
    monkeypatch.setattr(gmvae, "standard_normal", port_normal)


def _flax_variables(model, x):
    return jax.device_get(model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1),
         "sample": jax.random.key(2)}, x, train=True, dropout=False))


# ---------------------------------------------------------------------------
# models


CASES = [("dense", 32), ("dense", 64), ("spatial", 32), ("spatial", 64),
         ("You", 32)]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind,size", CASES)
def test_model_matches_flax(kind, size, train, monkeypatch):
    """One forward on converted weights with the same three draws given:
    every output key within 1e-5, and in train mode every BatchNorm's
    running statistics after the call.  At 64x64 in train mode three
    BatchNorm stages normalise with batch statistics that the packages
    reduce in different orders (Flax's one-pass variance), and the
    differences compound to ~4e-5 on outputs of magnitude ~10: there each
    output is held to 1e-5 of its own largest magnitude."""
    cfg = _cfg(kind, size)
    jm, spec = jax_get_model(_jax(cfg), jnp.float32)
    rng = np.random.default_rng(CASES.index((kind, size)))
    x = rng.uniform(size=(3, size, size, 1)).astype(np.float32)
    variables = _flax_variables(jm, x)
    stats = _randomised_batch_stats(variables.get("batch_stats", {}), rng)
    base = _slice_noise(kind, size, 7)
    _patch_noise(monkeypatch, base)
    out = jm.apply({"params": variables["params"], "batch_stats": stats}, x,
                   train=train, rngs={"sample": jax.random.key(3)},
                   mutable=["batch_stats"] if train else False)
    monkeypatch.undo()
    ref, mutated = out if train else (out, None)
    tm, tspec = get_model(cfg)
    assert (tspec.reconstruction_key, tspec.rngs, tspec.takes_prior_z) == (
        spec.reconstruction_key, spec.rngs, spec.takes_prior_z)
    tm.load_state_dict(params_from_flax(variables["params"], stats, tm))
    tm.train(train)
    with torch.no_grad():
        got = tm(_t(x), sample={k: _t(v) for k, v in _tiled(base, 3).items()})
    assert set(got) == set(ref) | {"x_hat"}
    assert got["x_hat"] is got["xz_mu"]
    for k in ref:
        assert got[k].dtype == torch.float32
        scale = 1.0
        if train and size == 64:
            scale = max(1.0, float(np.abs(np.asarray(ref[k])).max()))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, atol=1e-5 * scale, rtol=1e-5)
    if train and stats:
        want = params_from_flax(variables["params"],
                                jax.device_get(mutated["batch_stats"]), tm)
        state = tm.state_dict()
        keys = [k for k in want if k.endswith(("running_mean",
                                               "running_var"))]
        assert keys
        for k in keys:
            np.testing.assert_allclose(state[k].numpy(), want[k].numpy(),
                                       err_msg=k, **TOL)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_parameter_count_matches_jax(kind):
    """At 32x32 and at 128x128 with the presets' dims (shapes only on the
    JAX side)."""
    preset = {"dense": dict(dim_c=9, dim_z=128, dim_w=1),
              "spatial": dict(dim_c=9, dim_z=1, dim_w=1),
              "You": dict(dim_c=9, dim_z=1, dim_w=1)}[kind]
    for size, dims in ((32, DIMS), (128, preset)):
        cfg = _cfg(kind, size, **dims)
        jm, _ = jax_get_model(_jax(cfg), jnp.float32)
        shapes = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.key(0), "sample": jax.random.key(1)},
            jnp.zeros((2, size, size, 1)), train=True))
        assert count_params(get_model(cfg)[0]) == jax_count_params(
            shapes["params"]), size


@pytest.mark.parametrize("spatial", [False, True])
def test_mixture_posterior_matches_jax(spatial):
    rng = np.random.default_rng(3 + spatial)
    lead = (2, 4, 4) if spatial else (2,)
    z = rng.normal(size=lead + (3,)).astype(np.float32)
    mus = rng.normal(size=lead + (3, 5)).astype(np.float32)
    lsi = rng.normal(0.0, 0.5, size=lead + (3, 5)).astype(np.float32)
    ref = jax_gmvae._mixture_posterior(z, mus, lsi)
    got = gmvae._mixture_posterior(_t(z), _t(mus), _t(lsi))
    assert got["pc"].shape == lead + (5,)
    for k in ("pc_logit", "pc"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("h,w", [(4, 4), (5, 7)])
def test_stride1_conv_transpose_matches_flax(h, w):
    rng = np.random.default_rng(h * w)
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    kernel = rng.normal(size=(3, 3, 3, 5)).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    ref = fnn.ConvTranspose(5, (3, 3), strides=(1, 1), padding="SAME").apply(
        {"params": {"kernel": kernel, "bias": bias}}, x)
    holder = torch.nn.Module()
    holder.add_module("dec_convT_1", layers.ConvTranspose2d(3, 5, 3,
                                                            stride=1))
    holder.load_state_dict(params_from_flax(
        {"dec_convT_1": {"kernel": kernel, "bias": bias}}, {}, holder))
    with torch.no_grad():
        out = holder.dec_convT_1(_t(x).permute(0, 3, 1, 2))
    assert out.shape[-2:] == (h, w)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)
    with pytest.raises(ValueError, match="stride 1"):
        layers.ConvTranspose2d(3, 5, 5, stride=1)


@pytest.mark.parametrize("h,w", [(1, 1), (3, 5), (8, 8)])
def test_nearest_upsample_matches_jax_resize(h, w):
    x = np.random.default_rng(h + w).normal(size=(2, h, w, 3)).astype(
        np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 2 * h, 2 * w, 3),
                           method="nearest")
    got = layers.upsample_nearest2x(_t(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref))
    rows, cols = np.arange(2 * h) // 2, np.arange(2 * w) // 2
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  x[:, rows][:, :, cols])


def test_given_noise_is_checked_by_draw_name():
    model, _ = get_model(_cfg("spatial"))
    model.eval()
    x = torch.rand(2, 32, 32, 1)
    noise = {k: _t(v) for k, v in _tiled(_slice_noise("spatial", 32, 0),
                                         2).items()}
    with torch.no_grad():
        a = model(x, sample=noise)
        b = model(x, sample=torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="'z_wc'"):
            model(x, sample={k: v for k, v in noise.items() if k != "z_wc"})
        with pytest.raises(ValueError, match="shape"):
            model(x, sample={**noise, "w": noise["z"]})
    assert torch.equal(a["w_sampled"], a["w_mu"] + noise["w"] * torch.exp(
        0.5 * a["w_log_sigma"]))
    # the spatial decoder reads the features: xz_mu does not see the noise
    assert torch.equal(a["xz_mu"], b["xz_mu"])
    assert not torch.equal(a["z_sampled"], b["z_sampled"])


def test_init_state_and_converter_carry_the_bare_bias():
    """``init_state`` starts ``z_wc_log_sigma_inv_bias`` at 0.1 again, and
    the converter maps the bare Flax leaf (top level and under ``heads``)."""
    for kind, key in (("dense", "z_wc_log_sigma_inv_bias"),
                      ("You", "heads.z_wc_log_sigma_inv_bias")):
        cfg = _cfg(kind)
        t = get_trainer(cfg.trainer)(cfg, device="cpu")
        bias = dict(t.model.named_parameters())[key]
        with torch.no_grad():
            bias.fill_(3.0)
        t.init_state()
        assert torch.equal(bias, torch.full_like(bias, 0.1))
        jm, _ = jax_get_model(_jax(cfg), jnp.float32)
        params = _flax_variables(jm, np.zeros((2, 32, 32, 1), np.float32))[
            "params"]
        sd = params_from_flax(params, {}, t.model)
        np.testing.assert_array_equal(sd[key].numpy(), np.full(
            DIMS["dim_z"] * DIMS["dim_c"], 0.1, np.float32))
    with pytest.raises(ValueError, match="unmapped"):
        params_from_flax({"layer": {"other_bias": np.zeros(2)}}, {},
                         t.model)


# ---------------------------------------------------------------------------
# restoration


@pytest.fixture(scope="module")
def gmvae_pair():
    """JAX GMVAE trainers (dense and spatial) at 32x32 with randomised BN
    statistics, restore_steps 3, tv_lambda 0.5, and the port's twins on the
    same converted weights."""
    out = {}
    for kind in ("dense", "spatial"):
        cfg = _cfg(kind, restore_steps=3, restore_lr=1e-2, tv_lambda=0.5)
        jt = jax_get_trainer(cfg.trainer)(_jax(cfg))
        js = jt.init_state()
        stats = _randomised_batch_stats(jax.device_get(js.batch_stats),
                                        np.random.default_rng(4))
        js = js.replace(batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                           stats))
        tt = get_trainer(cfg.trainer)(cfg, device="cpu")
        tt.model.load_state_dict(params_from_flax(
            jax.device_get(js.params), stats, tt.model))
        out[kind] = (cfg, jt, js, tt)
    return out


def _x(b=4, seed=5, size=32):
    return np.random.default_rng(seed).uniform(
        size=(b, size, size, 1)).astype(np.float32)


@pytest.mark.parametrize("kind", ["dense", "spatial"])
def test_restoration_matches_jax(gmvae_pair, kind, monkeypatch):
    """3 steps of restoration against JAX ``restore_inputs`` with the same
    noise (the port takes it through the seam), and the trainers'
    reconstructions."""
    cfg, jt, js, tt = gmvae_pair[kind]
    x = _x()
    base = _slice_noise(kind, 32, 6)
    _patch_noise(monkeypatch, base)
    variables = {"params": js.params, "batch_stats": js.batch_stats}
    ref = jax_restoration.restore_inputs(
        jt._restoration_fn(variables), jnp.asarray(x), jnp.float32(0.5),
        cfg.restore_lr, cfg.restore_steps)
    noise = {k: _t(v) for k, v in _tiled(base, 4).items()}
    got = restoration.restore_inputs(tt._restoration_fn(False), _t(x), 0.5,
                                     cfg.restore_lr, cfg.restore_steps, noise)
    assert float(np.abs(np.asarray(ref) - x).max()) > 1e-3  # it moved
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    rec = tt.reconstruct_device(_t(x))["reconstruction"]
    np.testing.assert_allclose(rec.numpy(), np.asarray(ref), **TOL)
    jrec = jt.reconstruct_device(js, jnp.asarray(x))["reconstruction"]
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), **TOL)


def test_restoration_is_batch_size_invariant(gmvae_pair):
    """The restoration loss is the batch mean broadcast to (B,): summed it
    is the per-sample loss sum, so a slice restores the same alone as in a
    batch of 6 (a 1/B gradient scale would differ 6x)."""
    cfg, _, _, tt = gmvae_pair["spatial"]
    x = _t(_x(6, seed=8))
    base = _slice_noise("spatial", 32, 9)
    full = tt.reconstruct_device(x, generator={
        k: _t(v) for k, v in _tiled(base, 6).items()})["reconstruction"]
    alone = tt.reconstruct_device(x[:1], generator={
        k: _t(v) for k, v in _tiled(base, 1).items()})["reconstruction"]
    np.testing.assert_allclose(alone[0].numpy(), full[0].numpy(),
                               atol=1e-6, rtol=1e-6)
    assert float((full - x).abs().max()) > 1e-3


def test_padded_volume_stack_equals_each_volume_alone():
    """Padded stacks restore in one restoration: each volume draws from its
    own generator at its own shape, so the stack equals per-volume calls;
    without restoration steps the reconstruction is ``xz_mu``."""
    cfg = _cfg("dense", restore_steps=3, tv_lambda=0.5, dropout_rate=0.5)
    tt = get_trainer("GMVAE")(cfg, device="cpu")
    tt.init_state()
    assert tt.batched_volume_restoration()
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
    plain = get_trainer("GMVAE")(cfg.replace(restore_steps=0), device="cpu")
    plain.model.load_state_dict(tt.model.state_dict())
    assert not plain.batched_volume_restoration()
    x = _t(vols[0])
    out = plain.reconstruct_device(x, generator=torch.Generator().manual_seed(
        1))
    want = plain._call((x,), False, torch.Generator().manual_seed(1))
    assert torch.equal(out["reconstruction"], want["xz_mu"])


def test_lambda_sweep_matches_jax(gmvae_pair, monkeypatch, tmp_path):
    """The batched sweep's per-lambda errors at restore_steps 2 against the
    JAX package's sequential ones (2e-5 relative), and the chosen lambda
    wherever the two smallest errors differ by more than that."""
    cfg, jt, js, tt = gmvae_pair["spatial"]
    cfg = cfg.replace(restore_steps=2)
    jt = jax_get_trainer(cfg.trainer)(_jax(cfg))
    tt.config = cfg
    bs = cfg.batchsize
    _patch_noise(monkeypatch, _slice_noise("spatial", 32, 11))
    ds, jds = (pkg.SYNTH(pkg.SyntheticOptions(
        numPatients=3, imageSize=32, numSlices=16, targetSize=32,
        partition={"TRAIN": 0.0, "VAL": 1.0, "TEST": 0.0}))
        for pkg in (synthetic, jax_synthetic))
    arr = ds.slices("VAL")
    n_batches = max(1, int((len(arr) // bs) * 0.2))
    assert n_batches >= 2
    batches = jnp.asarray(arr[: n_batches * bs].reshape(
        n_batches, bs, *arr.shape[1:]))
    outputs_fn = jt._restoration_fn({"params": js.params,
                                     "batch_stats": js.batch_stats})
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
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    assert np.ptp(ref) > 0
    jt.workdir, tt.workdir = None, str(tmp_path)
    jt.tv_lambda_value = tt.tv_lambda_value = -1.0
    want = jt.determine_best_lambda(jds, js)
    best = tt.determine_best_lambda(ds)
    two = np.sort(ref)[:2]
    if two[1] - two[0] > LOSS_RTOL * two[0]:
        assert best == pytest.approx(want)
    assert best == pytest.approx(float(np.argmin(got)) / 10.0)
    assert (tmp_path / "tv_lambda.json").is_file()


def test_post_fit_sweeps_only_when_restoring(monkeypatch):
    calls = []
    monkeypatch.setattr(trainer_base.GMVAE, "determine_best_lambda",
                        lambda self, ds: calls.append(
                            self.config.restore_steps))
    for steps in (0, 3):
        cfg = _cfg("spatial", restore_steps=steps, tv_lambda=-1.0)
        get_trainer(cfg.trainer)(cfg, device="cpu").post_fit(None)
    cfg = _cfg("spatial", restore_steps=3, tv_lambda=0.4)
    get_trainer(cfg.trainer)(cfg, device="cpu").post_fit(None)
    assert calls == [3]


# ---------------------------------------------------------------------------
# training


def assert_step_matches(want, got, start, cfg, steps):
    """Parameters and running statistics after Adam steps ``steps`` (the
    step numbers t of the updates an element takes) from one state within
    1e-5, as ``tests/test_torch_train.py`` holds them: the BN-fed conv
    biases (true gradient 0) and at most KINK_FRACTION of the other
    elements within the sum of Adam's largest steps instead."""
    bound = 2 * cfg.learningrate * sum(_adam_step_bound(
        t, cfg.beta1, cfg.beta2) for t in steps) + 1e-6
    fed = _bn_fed_biases(got)
    off, total = 0, 0
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        diff = (got[k] - v).abs()
        np.testing.assert_array_less(diff.numpy(), bound, err_msg=k)
        if k not in fed:
            off += int((diff > TRAJ_PARAM_ATOL).sum())
            total += diff.numel()
    assert off <= KINK_FRACTION * total, (off, total)
    moved = max(float((want[k] - start[k]).abs().max()) for k in want
                if not k.endswith("num_batches_tracked"))
    assert moved > 0


@pytest.mark.parametrize("kind", ["dense", "spatial"])
def test_train_step_matches_jax(kind, monkeypatch):
    """Two steps, each from the JAX package's state at that step
    (parameters, BatchNorm statistics and Adam moments converted) with the
    same noise and dropout 0: the TRAIN and VAL losses within 2e-5
    relative, and the parameters and running statistics after each step
    (``assert_step_matches``)."""
    cfg = _cfg(kind, 32, learningrate=1e-3)
    _patch_noise(monkeypatch, _slice_noise(kind, 32, 12))
    jt = jax_get_trainer(cfg.trainer)(_jax(cfg))
    js = jt.init_state()
    tt = get_trainer(cfg.trainer)(cfg, device="cpu")
    tt.init_state()
    jstep = jax.jit(jt._build_train_step())
    jval = jax.jit(jt._build_val_step())
    pool = _x(8, seed=13)
    for b in range(2):
        batch = pool[4 * b: 4 * b + 4]
        tt.model.load_state_dict(params_from_flax(
            jax.device_get(js.params), jax.device_get(js.batch_stats),
            tt.model))
        tt.optimizer.load_state_dict(adam_state_from_optax(
            jax.device_get(js.opt_states["main"]), tt.model, tt.optimizer))
        start = {k: v.clone() for k, v in tt.model.state_dict().items()}
        _, jv = jval(js, {"x": jnp.asarray(batch)})
        js, jm = jstep(js, {"x": jnp.asarray(batch)})
        tv = tt.val_step({"x": _t(batch)})
        tm = tt.train_step({"x": _t(batch)})
        assert set(tm) == set(jm) and set(tv) == set(jv)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, atol=1e-5,
                                       err_msg=f"{k} step {b}")
            np.testing.assert_allclose(float(tv[k]), float(jv[k]),
                                       rtol=LOSS_RTOL, atol=1e-5,
                                       err_msg=f"VAL {k} step {b}")
        assert_step_matches(
            params_from_flax(jax.device_get(js.params),
                             jax.device_get(js.batch_stats), tt.model),
            tt.model.state_dict(), start, cfg, (b + 1,))


# ---------------------------------------------------------------------------
# the slice as a whole


def test_evaluate_matches_jax(monkeypatch, tmp_path):
    """``evaluate()`` of a ``GMVAE_spatial`` trainer (2 restoration steps,
    fixed lambda, the two TEST volumes restored as one padded stack) on
    the same converted weights and noise: AUROC, AUPRC, Dice and the
    threshold within 1e-4."""
    cfg = _cfg("spatial", 64, restore_steps=2, tv_lambda=0.3,
               restore_lr=1e-2)
    jt = jax_get_trainer(cfg.trainer)(_jax(cfg))
    js = jt.init_state()
    stats = _randomised_batch_stats(jax.device_get(js.batch_stats),
                                    np.random.default_rng(14))
    js = js.replace(batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    tt = get_trainer(cfg.trainer)(cfg, device="cpu")
    tt.model.load_state_dict(params_from_flax(jax.device_get(js.params),
                                              stats, tt.model))
    _patch_noise(monkeypatch, _slice_noise("spatial", 64, 15))
    ds = jax_synthetic.SYNTH(jax_synthetic.SyntheticOptions(
        numPatients=4, imageSize=64, numSlices=12, targetSize=64,
        withLesions=True, seed=99,
        partition={"TRAIN": 0.0, "VAL": 0.5, "TEST": 0.5}))
    groups = []
    real = E._reconstruct_volume_group
    monkeypatch.setattr(E, "_reconstruct_volume_group",
                        lambda trainer, xs, *a, **k: groups.append(len(xs))
                        or real(trainer, xs, *a, **k))
    kw = dict(threshold=None, applyHyperIntensityPrior=False,
              erosionIterations=6)
    ref = jax_evaluate(ds, jt, js, JaxOptions(
        paths=JaxPathConfig(sample_dir=str(tmp_path / "jax")), **kw),
        _jax(cfg))
    got = E.evaluate(ds, tt, Options(
        paths=PathConfig(sample_dir=str(tmp_path / "torch")), **kw), cfg)
    assert groups == [2]
    np.testing.assert_allclose(got["reconstructions"], ref["reconstructions"],
                               atol=1e-5, rtol=0)
    for k in ("diff_AUC", "diff_AUPRC", "bestDiceScore", "bestThreshold",
              "DiceScore"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
