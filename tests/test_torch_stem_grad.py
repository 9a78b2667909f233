"""The stem's input-gradient path on the CPU.

``ops/stem_dgrad.py``'s plain twin, through the stem's autograd Function
(``models/layers.py::_StemConv``), against ``torch.autograd`` of the
layer's own ops (cast, ``F.pad``, ``F.conv2d``); ``UnifiedEncoder``'s
selector, which takes that Function only where a call can need its
input's gradient and nothing else (the restoration), and keeps the
library's path in training, serving without restoration and the critics'
gradient penalty; the restoration's frozen parameters, and their casts to
the compute dtype kept for it (``layers.kept_casts``).  The kernel itself
runs only on the card (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest
import torch

from unsupervised_anomaly_detection_brain_mri_tpu_torch import Options
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import Config
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import make_phantom
from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.inference import (
    AnomalyDetector,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import layers
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import stem_dgrad
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
    restoration,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker process: the suite runs several."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stem(dtype):
    torch.manual_seed(0)
    conv = layers.Conv2d(1, 32, 5, 2, dtype)
    with torch.no_grad():
        conv.bias.uniform_(-0.5, 0.5)
    return conv


def _bf16_ulp(t):
    """bf16's spacing at each value of ``t`` (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126)))
                      - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 128, 128), (3, 37, 45), (2, 131, 64)])
def test_plain_twin_matches_autograd_of_the_stem_ops(shape, dtype):
    """The Function's forward is the layer's, bit for bit; its backward's
    float32 input gradient is autograd's through the cast, the pad and the
    convolution (float32: 1e-6 of the largest; bf16: one ulp)."""
    conv = _stem(dtype)
    gen = torch.Generator().manual_seed(1)
    # NHWC slices viewed as NCHW, as the models hand them to the encoder
    x = torch.randn(shape + (1,), generator=gen).permute(0, 3, 1, 2)
    x.requires_grad_(True)
    y = conv(x)
    g = torch.randn(y.shape, generator=gen).to(dtype)
    (want,) = torch.autograd.grad(y, x, g)

    conv.requires_grad_(False)
    ph, pw = conv.same_pads(shape[1:])
    assert (ph, pw) == (layers._same_pads(shape[1], 5, 2),
                        layers._same_pads(shape[2], 5, 2))
    y2 = layers._StemConv.apply(x, conv)
    assert torch.equal(y2, y.detach())
    (got,) = torch.autograd.grad(y2, x, g)
    assert got.dtype == torch.float32 and got.shape == x.shape
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max())
    else:
        assert bool(((got - want).abs() <= _bf16_ulp(want)).all())
    direct = stem_dgrad.stem_input_grad_plain(
        g, conv.weight.to(dtype), shape[1:], ph, pw)
    assert torch.equal(direct, got)


def _count_stem(monkeypatch):
    """Counts of the encoder's calls of the stem Function and of its plain
    backward."""
    calls = {"forward": 0, "backward": 0}
    apply = layers._StemConv.apply
    plain = layers.stem_input_grad_plain

    def forward(*a, **k):
        calls["forward"] += 1
        return apply(*a, **k)

    def backward(*a, **k):
        calls["backward"] += 1
        return plain(*a, **k)

    monkeypatch.setattr(layers._StemConv, "apply", forward)
    monkeypatch.setattr(layers, "stem_input_grad_plain", backward)
    return calls


def _vae_you(dtype="float32", restore_steps=5):
    cfg = Config(trainer="VAE_You", model="variational_autoencoder",
                 outputWidth=32, outputHeight=32, zDim=16,
                 compute_dtype=dtype, restore_steps=restore_steps,
                 tv_lambda=0.5)
    t = get_trainer("VAE_You")(cfg, device="cpu")
    t.init_state()
    return t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selector_engages_in_a_restoration_and_changes_nothing(monkeypatch,
                                                               dtype):
    """A 32x32 VAE_You restoration takes the stem Function at every step,
    and restores exactly what the library's path restores."""
    t = _vae_you(dtype)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(6, 32, 32, 1)).astype(np.float32))
    noise = torch.from_numpy(np.random.default_rng(1).normal(
        size=(6, 16)).astype(np.float32))
    calls = _count_stem(monkeypatch)
    got = t.reconstruct_device(x, generator=noise)["reconstruction"]
    assert calls == {"forward": 5, "backward": 5}
    monkeypatch.setattr(layers.UnifiedEncoder, "_input_grad_only",
                        lambda self, x: False)
    want = t.reconstruct_device(x, generator=noise)["reconstruction"]
    assert calls == {"forward": 5, "backward": 5}
    assert torch.equal(got, want)


def _ae(**kw):
    cfg = Config(trainer="AE", model="autoencoder", outputWidth=32,
                 outputHeight=32, zDim=16, compute_dtype="float32", **kw)
    t = get_trainer("AE")(cfg, device="cpu")
    t.init_state()
    return t


def _ae_train_step():
    t = _ae()
    t.train_step({"x": torch.rand(4, 32, 32, 1)})


def _ae_detect():
    t = _ae()
    det = AnomalyDetector(t, t.config, Options(erosionIterations=1,
                                               minLesionSize=2), 0.1)
    det.detect(make_phantom(np.random.default_rng(0), 48, 12,
                            True)["volume"])


def _wgan_gp_critic_step():
    cfg = Config(trainer="fAnoGAN", model="fanogan", outputWidth=32,
                 outputHeight=32, zDim=16, compute_dtype="float32",
                 intermediateResolutions=(8, 8), batchsize=4)
    t = get_trainer("fAnoGAN")(cfg, device="cpu")
    t.init_state()
    t.d_iters = 1
    t.epoch = 0  # the WGAN phase: a generator and a critic update
    t.train_step({"x": torch.rand(4, 32, 32, 1)})


@pytest.mark.parametrize("run", [_ae_train_step, _ae_detect,
                                 _wgan_gp_critic_step],
                         ids=["ae_train_step", "ae_detect",
                              "wgan_gp_critic_step"])
def test_selector_keeps_the_library_path_elsewhere(monkeypatch, run):
    """Training (weights train), serving without restoration (no grad) and
    the critics' gradient penalty (differentiated twice, with trainable
    weights) never take the stem Function."""
    calls = _count_stem(monkeypatch)
    run()
    assert calls == {"forward": 0, "backward": 0}


def _freeze(enc):
    enc.eval()
    enc.requires_grad_(False)


@pytest.mark.parametrize("case,engaged", [
    ("input_only", True),
    ("train_mode", False),
    ("input_without_grad", False),
    ("trainable_weight", False),
    ("trainable_bias", False),
    ("no_grad", False),
    ("s2d_stem", False),
])
def test_selector_reads_what_the_call_can_need(monkeypatch, case, engaged):
    """Stage 0 takes the Function only in eval mode, for an input that
    requires grad under grad mode, with the stem's weight and bias frozen,
    and not for the space-to-depth stem."""
    enc = layers.UnifiedEncoder(32, space_to_depth_stem=case == "s2d_stem")
    _freeze(enc)
    x = torch.rand(2, 1, 32, 32, requires_grad=case != "input_without_grad")
    if case == "train_mode":
        enc.train()
    if case == "trainable_weight":
        enc.enc_conv_0.weight.requires_grad_(True)
    if case == "trainable_bias":
        enc.enc_conv_0.bias.requires_grad_(True)
    calls = _count_stem(monkeypatch)
    with torch.set_grad_enabled(case != "no_grad"):
        enc(x)
    assert calls["forward"] == int(engaged)


def _frozen_during(monkeypatch, t):
    """Records, at every restoration step, whether every parameter was
    frozen."""
    seen = []
    grads = restoration.restoration_grads

    def recorded(*a, **k):
        seen.append(all(not p.requires_grad for p in t.model.parameters()))
        return grads(*a, **k)

    monkeypatch.setattr(restoration, "restoration_grads", recorded)
    return seen


@pytest.mark.parametrize("case", ["restore", "restore_raises",
                                  "lambda_sweep"])
def test_restoration_freezes_the_parameters_and_restores_them(monkeypatch,
                                                              case):
    """A restoration, and each chunk of the lambda sweep, runs with every
    parameter frozen; afterwards each parameter requires grad as it did
    before, also when the restoration raises (a parameter frozen before
    stays frozen)."""
    t = _vae_you(restore_steps=2)
    params = list(t.model.parameters())
    params[0].requires_grad_(False)
    before = [p.requires_grad for p in params]
    seen = _frozen_during(monkeypatch, t)
    x = torch.rand(3, 32, 32, 1)
    if case == "restore":
        t.reconstruct_device(x)
    elif case == "lambda_sweep":
        t.lambda_sweep_errors(x, torch.tensor([0.0, 0.5]), 1)
    else:
        def fail(*a, **k):
            seen.append(all(not p.requires_grad for p in params))
            raise RuntimeError("restoration failed")

        monkeypatch.setattr(restoration, "restoration_grads", fail)
        with pytest.raises(RuntimeError, match="restoration failed"):
            t.reconstruct_device(x)
    assert seen and all(seen)
    assert [p.requires_grad for p in params] == before


def test_kept_casts_cast_a_frozen_parameter_once():
    """Inside ``kept_casts`` a layer casts a weight that requires no grad
    once and hands the copy out again, and recasts it after an in-place
    change; a trainable bias, and every cast outside the block, are
    ``Tensor.to``'s."""
    conv = _stem(torch.bfloat16)
    conv.weight.requires_grad_(False)
    outside = conv._cast("weight")
    assert torch.equal(outside, conv.weight.to(torch.bfloat16))
    assert conv._cast("weight") is not outside
    with layers.kept_casts(conv):
        first = conv._cast("weight")
        assert torch.equal(first, outside)
        with layers.kept_casts(conv):
            assert conv._cast("weight") is first
        assert conv._cast("weight") is first
        assert conv._cast("bias") is not conv._cast("bias")
        with torch.no_grad():
            conv.weight.add_(1.0)
        again = conv._cast("weight")
        assert again is not first
        assert torch.equal(again, conv.weight.to(torch.bfloat16))
        assert conv._cast("weight") is again
        assert list(conv.kept) == ["weight"]
    assert conv.kept is None
    assert conv._cast("weight") is not again


def _kept(model):
    return {(id(m), name): id(cast) for m in model.modules()
            if isinstance(m, layers._ColumnParallel) and m.kept
            for name, (_, cast) in m.kept.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_restoration_casts_each_parameter_once(monkeypatch, dtype):
    """Every step of a restoration hands each layer the casts the first
    step made (in float32 the parameters themselves), and the kept casts
    are dropped after it."""
    t = _vae_you(dtype, restore_steps=3)
    kept = []
    grads = restoration.restoration_grads

    def recorded(*a, **k):
        out = grads(*a, **k)
        kept.append(_kept(t.model))
        return out

    monkeypatch.setattr(restoration, "restoration_grads", recorded)
    t.reconstruct_device(torch.rand(3, 32, 32, 1))
    n_params = sum(2 for m in t.model.modules()
                   if isinstance(m, layers._ColumnParallel))
    assert len(kept) == 3 and kept[0] == kept[1] == kept[2]
    assert len(kept[0]) == n_params
    assert _kept(t.model) == {}
