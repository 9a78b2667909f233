"""The port's ``fAnoGAN_schlegl`` against the benchmark's plain reference
(``benchmark/reference/{resnet,fanogan_schlegl,adversarial}.py``) on the
CPU in float32 with TF32 off, on seeded random weights at a small size
(ResNet ``dim`` 8, 32 x 32, batch 2, zDim 8; the port's registry patched to
build ``dim`` 8): the critic, generator and encoder; the generator loss,
the critic loss with its gradient penalty (a double backward) and the izif
encoder loss, each with its group's gradients; two whole WGAN steps (one
generator and five critic updates each, one Adam a group); and the SAME
transposed convolutions against their definition.  The reference modules
import neither JAX nor anything of the port."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.common import compare, weights
from benchmark.reference import adversarial as A
from benchmark.reference import fanogan_schlegl as F
from benchmark.reference import layers as R
from benchmark.reference import resnet as RN
from benchmark.reference.layers import float32_products
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import preset
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import (
    fanogan,
    registry,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
    losses as L,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
DIM, SIZE, B, Z = 8, 32, 2, 8
SEED = 7  # the trainer's config.seed: its generator and gp streams
CFG = {"dim": DIM, "numChannels": 1, "zDim": Z, "outputWidth": SIZE,
       "outputHeight": SIZE, "intermediateResolutions": [4, 4],
       "scale": 10.0, "kappa": 1.0, "critic_iters": 5,
       "adam_betas": [0.5, 0.9], "learningrate": 1e-3}


def small_schlegl(monkeypatch, dim=DIM):
    """The port's registry builds Schlegl's ResNets at ``dim`` (it always
    builds the published 64)."""
    def build(config, dtype):
        return fanogan.FAnoGANSchlegl(
            image_size=config.outputWidth, channels=config.numChannels,
            z_dim=config.zDim,
            intermediate_resolution=config.intermediateResolutions[0],
            dim=dim, dtype=dtype)

    monkeypatch.setitem(registry.MODEL_REGISTRY, "fanogan_schlegl",
                        dataclasses.replace(
                            registry.MODEL_REGISTRY["fanogan_schlegl"],
                            build=build))


@pytest.fixture(autouse=True)
def _small_float32(monkeypatch):
    """One intra-op thread (small shapes in several workers), TF32 off, and
    the port's registry building Schlegl's ResNets at ``DIM``."""
    small_schlegl(monkeypatch)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with float32_products():
        yield
    torch.set_num_threads(n)


def _trainer(lr=1e-3):
    config = preset("fAnoGAN_schlegl", outputWidth=SIZE, outputHeight=SIZE,
                    zDim=Z, intermediateResolutions=(4, 4), batchsize=B,
                    learningrate=lr, compute_dtype="float32", seed=SEED)
    tr = get_trainer("fAnoGAN")(config, device="cpu")
    p_leaves, b_leaves = F.leaves({**CFG, "learningrate": lr})
    params = weights.make(p_leaves, 3, CPU)
    bufs = weights.make(b_leaves, 3, CPU)
    weights.load_into(tr.model, {**params, **bufs})
    tr.optimizer = tr.make_optimizer()
    return tr, params, bufs


def _x(seed=1):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        size=(B, SIZE, SIZE, 1)).astype(np.float32))


def _draws(seed=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((B, Z), generator=g), torch.rand((B, 1, 1, 1),
                                                        generator=g)


def _given_alpha(monkeypatch, tr, alpha):
    monkeypatch.setattr(tr, "_noise", lambda sample, gp: {"sample": sample,
                                                          "gp": alpha})


def _zero_true_gradient(grads):
    """The leaves whose gradient is nought but for rounding (under a
    thousandth of the median leaf's norm, as ``common/compare.py`` leaves
    them out): every bias of the critic (an additive constant of the score
    that the WGAN loss cancels, or one a LayerNorm removes), and the
    generator's LayerNorm-fed conv biases."""
    norms = {k: float(v.norm()) for k, v in grads.items()}
    median = float(np.median(list(norms.values())))
    return {k for k, v in norms.items() if v < compare.SKIP_GRAD * median}


def assert_grads_close(port, ref):
    """Each leaf within 2e-4 of its own largest element (float32 sums in
    other orders through LayerNorms whose input mean is large against its
    spread: the ResNets' gradients are ill-conditioned there), the
    nought-gradient leaves within 2e-4 of the median leaf's largest."""
    zero = _zero_true_gradient(ref)
    scale = float(np.median([float(v.abs().max()) for v in ref.values()]))
    assert set(port) == set(ref)
    for k in ref:
        tol = 2e-4 * (scale if k in zero else float(ref[k].abs().max()))
        torch.testing.assert_close(port[k], ref[k], rtol=0, atol=tol,
                                   msg=lambda m, k=k: f"{k}: {m}")


def _port_grads(tr, group, loss):
    names = tr.groups[group]
    named = dict(tr.model.named_parameters())
    grads = torch.autograd.grad(loss, [named[n] for n in names],
                                allow_unused=True)
    return {n: torch.zeros_like(named[n]) if g is None else g
            for n, g in zip(names, grads)}


def _ref_grads(params, group, loss_fn):
    leaves = dict(params)
    own = F.groups(list(params))[group]
    leaves.update({k: params[k].clone().requires_grad_(True) for k in own})
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in own],
                                allow_unused=True)
    return loss, {k: torch.zeros_like(params[k]) if g is None else g
                  for k, g in zip(own, grads)}


# ---------------------------------------------------------------------------
# networks


@pytest.mark.parametrize("part", ["critic", "generator", "encoder"])
def test_networks_agree(part):
    """Each network's outputs within 2e-5 of max(1, their largest
    magnitude): float32 sums in other orders (the critic's scores reach
    ~4)."""
    tr, params, bufs = _trainer()
    tr.model.train()
    x, (z, _) = _x(), _draws()
    if part == "critic":
        got, want = tr.model.discriminate(x), F.critic(params, x)
    elif part == "generator":
        got, want = (tr.model.generate(z),), (F.generate(params, z, CFG),)
    else:
        got, want = (tr.model.encode(x),), (F.encode(params, dict(bufs), x),)
    for g, w in zip(got, want):
        tol = 2e-5 * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w, rtol=0, atol=tol)


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 2)])
def test_transposed_convolutions_match_their_definition(k, stride):
    """The reference's SAME transposed convolution equals the dilated input
    correlated with the flipped kernel (``layers.conv_transpose_dilated``),
    lax's pads (1, 1), (2, 1) and (0, 1), within float32 rounding."""
    g = torch.Generator().manual_seed(k + stride)
    x = torch.randn((2, 3, 5, 6), generator=g)
    w = torch.randn((3, 4, k, k), generator=g)
    b = torch.randn((4,), generator=g)
    got = RN.conv_transpose(x, w, b, stride)
    want = R.conv_transpose_dilated(x, w, b, stride)
    assert got.shape == (2, 4, 5 * stride, 6 * stride)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# losses and their gradients


def test_generator_loss_and_gradients(monkeypatch):
    tr, params, _ = _trainer()
    x, (z, alpha) = _x(), _draws()
    _given_alpha(monkeypatch, tr, alpha)
    with tr.only("gen"):
        loss = L.wgan_gen_loss(tr.forward_train({"x": x}, z)["d_"])
        got = _port_grads(tr, "gen", loss)
    want_loss, want = _ref_grads(
        params, "gen", lambda p: F.gen_loss(p, x, z, alpha, CFG))
    # one float32 forward: relative rounding
    np.testing.assert_allclose(float(loss.detach()), float(want_loss.detach()),
                               rtol=1e-5)
    assert_grads_close(got, want)


def test_critic_loss_with_the_penalty_and_gradients(monkeypatch):
    """The critic's loss, its gradient penalty taken by a real
    ``autograd.grad(create_graph=True)`` on both sides, and the gradient
    through it (a double backward through every conv, LayerNorm and
    ReLU)."""
    tr, params, _ = _trainer()
    x, (z, alpha) = _x(), _draws()
    _given_alpha(monkeypatch, tr, alpha)
    with tr.only("disc"):
        loss = tr.image_disc_loss(tr.forward_train({"x": x}, z), "x_hat")
        got = _port_grads(tr, "disc", loss)
    want_loss, want = _ref_grads(
        params, "disc", lambda p: F.disc_loss(p, x, z, alpha, CFG))
    # the loss is the penalty's ~10^2-10^3: relative rounding of its sums
    np.testing.assert_allclose(float(loss.detach()), float(want_loss.detach()),
                               rtol=1e-5)
    assert_grads_close(got, want)


def test_izif_encoder_loss_and_gradients(monkeypatch):
    tr, params, bufs = _trainer()
    x, (_, alpha) = _x(), _draws()
    _given_alpha(monkeypatch, tr, alpha)
    with tr.only("enc"):
        loss = tr.compute_losses(tr.forward_train({"x": x}),
                                 {"x": x})["enc_loss"]
        got = _port_grads(tr, "enc", loss)
    want_loss, want = _ref_grads(
        params, "enc", lambda p: F.enc_loss(p, dict(bufs), x, CFG))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss.detach()),
                               rtol=1e-5)
    assert_grads_close(got, want)


# ---------------------------------------------------------------------------
# whole steps


@pytest.mark.parametrize("seeds", [(1, 2), (7, 8)], ids=str)
def test_two_wgan_steps_agree(seeds):
    """Two WGAN steps of the trainer (each one generator update, then five
    critic updates, every update with fresh draws from the trainer's
    ``generator`` and ``gp`` streams) against ``adversarial.follow`` from
    the same weights and stream seeds: the groups in the schedule's order,
    every update's loss within 1e-2 relative, and each group's parameters
    after within 3 % of the group's change (the norm of the gap over the
    leaves whose gradient is not nought), the encoder's unchanged.

    At lr 1e-5, not the preset's 1e-3.  Adam moves every element by about
    lr whatever its gradient's size, so an element whose gradient lies at
    float32's rounding steps either way, and the critic's penalty amplifies
    the difference: at 1e-3 float32 and float64 references part by 2 % of
    the second step's generator loss, and at 1e-4 by more than 0.05 lr on
    most elements of some critic leaves.  At 1e-5, over six pairs of
    batches, the worst gap read 0.99 % of the change and the worst loss
    2.2e-3 relative (these two pairs hold the best and the worst)."""
    from benchmark.kinds.wgan_train import FirstUpdates

    lr = 1e-5
    tr, params, _ = _trainer(lr)
    tr.epoch = 0
    xs = [_x(seeds[0]), _x(seeds[1])]
    first = FirstUpdates(tr, 2)
    for x in xs:
        metrics = tr.train_step({"x": x})
    first.remove()
    ref = A.follow(F, {**CFG, "learningrate": lr}, params, xs,
                   {"generator": torch.Generator().manual_seed(SEED),
                    "gp": torch.Generator().manual_seed(SEED + 2)})
    got = first.steps()
    assert [g for g, _ in got["losses"]] == [g for g, _ in ref["losses"]] \
        == (["gen"] + ["disc"] * 5) * 2
    np.testing.assert_allclose([v for _, v in got["losses"]],
                               [v for _, v in ref["losses"]], rtol=1e-2)
    assert float(metrics["gen_loss"]) == got["losses"][6][1]
    assert float(metrics["disc_loss"]) == got["losses"][-1][1]
    zero = _zero_true_gradient({**ref["grad1"]["gen"],
                                **ref["grad1"]["disc"]})
    after = got["params"]
    for g in ("gen", "disc"):
        keys = [k for k in ref["grad1"][g] if k not in zero]

        def norm(diff):
            return float(torch.sqrt(sum((diff(k) ** 2).sum() for k in keys)))

        gap = norm(lambda k: after[k] - ref["params"][k])
        change = norm(lambda k: ref["params"][k] - params[k])
        assert gap <= 0.03 * change, (g, gap / change)
    for k in F.groups(list(params))["enc"]:
        torch.testing.assert_close(after[k], params[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# independence


REFERENCE = sorted((ROOT / "benchmark" / "reference").glob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax",
             "unsupervised_anomaly_detection_brain_mri_tpu",
             "unsupervised_anomaly_detection_brain_mri_tpu_torch"}


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_jax_or_the_port(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & FORBIDDEN, sorted(names & FORBIDDEN)
    assert "importlib" not in names
