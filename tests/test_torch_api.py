"""The port's public API against the JAX package's: every name a JAX
package ``__init__`` exports, the curve samples and the Dice at a
threshold, ``sample_from_prior`` (given the same latents: the same
images), and ``timestamp``, ``normalize`` and ``apply_colormap``."""

import ast
import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vae import _randomised_batch_stats
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    Config as JaxConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu.models import (
    get_model as jax_get_model,
)
from unsupervised_anomaly_detection_brain_mri_tpu.models.layers import (
    sample_from_prior as jax_sample_from_prior,
)
from unsupervised_anomaly_detection_brain_mri_tpu.ops import metrics as JM
from unsupervised_anomaly_detection_brain_mri_tpu.utils import misc as jax_misc
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import preset
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import (
    get_model,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.convert import (
    params_from_flax,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    sample_from_prior,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
    metrics as TM,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import misc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "unsupervised_anomaly_detection_brain_mri_tpu"
PORT_PKG = JAX_PKG + "_torch"
SUBPACKAGES = ("", "train", "eval", "models", "utils", "data", "ops",
               "parallel")
RATIO = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exports(sub):
    """The names a JAX package ``__init__`` imports from its modules."""
    path = os.path.join(ROOT, JAX_PKG, sub, "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    return sorted(a.asname or a.name for node in tree.body
                  if isinstance(node, ast.ImportFrom) for a in node.names)


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=[s or "top" for s in
                                                  SUBPACKAGES])
def test_every_jax_package_export_is_in_the_port(sub):
    port = importlib.import_module(".".join(p for p in (PORT_PKG, sub) if p))
    missing = [n for n in _exports(sub) if not hasattr(port, n)]
    assert not missing, f"{sub or PORT_PKG}: missing {missing}"


def test_the_exports_are_the_port_registries_and_functions():
    from unsupervised_anomaly_detection_brain_mri_tpu_torch import (
        eval as port_eval,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch import (
        models,
        train,
        utils,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
        registry,
    )

    # the package's ``evaluate`` is the function: it shadows its module,
    # as in the JAX package
    evaluate = importlib.import_module(PORT_PKG + ".eval.evaluate")

    assert train.get_trainer("AE") is registry.TRAINER_REGISTRY["AE"]
    assert set(train.TRAINER_REGISTRY) == set(importlib.import_module(
        JAX_PKG + ".train").TRAINER_REGISTRY)
    assert set(models.MODEL_REGISTRY) == set(importlib.import_module(
        JAX_PKG + ".models").MODEL_REGISTRY)
    assert port_eval.evaluate is evaluate.evaluate
    assert utils.timestamp is misc.timestamp


# ---------------------------------------------------------------------------
# ops/metrics.py


def _scores(seed, n=4097):
    """Continuous scores (no ties) and labels; (n - 1) = 4096 shares no
    factor with (num_points - 1), so no sample position is a float
    rounding away from an integer in either package's linspace."""
    rng = np.random.default_rng(seed)
    labels = rng.uniform(size=n) < rng.uniform(0.05, 0.5)
    scores = rng.normal(size=n) + 1.5 * labels
    return scores.astype(np.float32), labels


@pytest.mark.parametrize("num_points", [256, 64])
@pytest.mark.parametrize("seed", range(3))
def test_curve_points_match_jax(seed, num_points):
    scores, labels = _scores(seed)
    for name in ("roc_curve_points", "prc_curve_points"):
        ref = getattr(JM, name)(scores, labels, num_points)
        got = getattr(TM, name)(torch.from_numpy(scores),
                                torch.from_numpy(labels), num_points)
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].shape == (num_points,)
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       err_msg=f"{name} {k}", **RATIO)


@pytest.mark.parametrize("seed", range(3))
def test_dice_at_threshold_matches_jax(seed):
    scores, labels = _scores(seed)
    for t in (-1.0, 0.5, float(np.quantile(scores, 0.9))):
        ref = JM.dice_at_threshold(scores, labels.astype(np.float32), t)
        got = TM.dice_at_threshold(torch.from_numpy(scores),
                                   torch.from_numpy(labels), t)
        np.testing.assert_allclose(float(got), float(ref), **RATIO)


# ---------------------------------------------------------------------------
# models/layers.py::sample_from_prior


@pytest.mark.parametrize("name,method", [("AAE", "decode"),
                                         ("fAnoGAN", "generate")])
def test_sample_from_prior(name, method, monkeypatch):
    """The same generator seed gives the same images, in eval mode and
    without autograd, the module's mode kept; on converted weights they
    are the JAX package's images of the same latents."""
    cfg = preset(name).replace(outputWidth=32, outputHeight=32, zDim=16,
                               compute_dtype="float32")
    jm, spec = jax_get_model(JaxConfig.from_json(cfg.to_json()), jnp.float32)
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(2, 32, 32, 1)).astype(np.float32)
    args = (x, rng.normal(size=(2, 16)).astype(np.float32)) \
        if spec.takes_prior_z else (x,)
    variables = jax.device_get(jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1),
         "gp": jax.random.key(2)}, *args, train=True, dropout=False))
    stats = _randomised_batch_stats(variables.get("batch_stats", {}), rng)
    tm, _ = get_model(cfg)
    tm.load_state_dict(params_from_flax(variables["params"], stats, tm))
    tm.train(True)

    a = sample_from_prior(tm, torch.Generator().manual_seed(5), 4, 16,
                          method=method)
    b = sample_from_prior(tm, torch.Generator().manual_seed(5), 4, 16,
                          method=method)
    c = sample_from_prior(tm, torch.Generator().manual_seed(6), 4, 16,
                          method=method)
    assert a.shape == (4, 32, 32, 1) and a.dtype == torch.float32
    assert not a.requires_grad and tm.training
    assert torch.equal(a, b) and not torch.equal(a, c)

    z = torch.randn((4, 16), generator=torch.Generator().manual_seed(5))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(
                            z.numpy()))
    ref = jax_sample_from_prior(
        jm, {"params": variables["params"], "batch_stats": stats},
        jax.random.key(0), 4, 16, method=method)
    np.testing.assert_allclose(a.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


# ---------------------------------------------------------------------------
# utils/misc.py


def test_timestamp_format():
    a, b = misc.timestamp(), jax_misc.timestamp()
    assert re.fullmatch(r"\d{8}-\d{6}", a)
    assert len(a) == len(b) and a[:8] == b[:8]


@pytest.mark.parametrize("x", [np.linspace(-3, 5, 24).reshape(4, 6),
                               np.full((3, 3), 2.5), np.arange(8.0)])
def test_normalize_matches_jax(x):
    np.testing.assert_array_equal(misc.normalize(x), jax_misc.normalize(x))


def test_apply_colormap_matches_jax():
    img = np.random.default_rng(1).uniform(size=(1, 12, 10, 1))
    got = misc.apply_colormap(img)
    assert got.shape == (12, 10, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_misc.apply_colormap(img))
    import matplotlib.pyplot as plt

    np.testing.assert_array_equal(
        misc.apply_colormap(img, plt.cm.gray),
        jax_misc.apply_colormap(img, plt.cm.gray))
