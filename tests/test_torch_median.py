"""The port's 5^3 median (ops/median.py) against scipy, the JAX XLA path and
the Pallas kernel in interpret mode, and the CUDA kernel's selection rule
(``median_select_reference``) against a sort (the CUDA kernel itself is held
against the plain version on the card by tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax.numpy as jnp

from unsupervised_anomaly_detection_brain_mri_tpu.ops import (
    postprocess as JP,
)
from unsupervised_anomaly_detection_brain_mri_tpu.ops.pallas_median import (
    median_filter_3d_pallas,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import _build
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import median as M
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import trace

SHAPES = [(1, 5, 6), (2, 7, 9), (7, 9, 11), (7, 16, 16), (2, 1, 5),
          (3, 1, 1), (16, 32, 32)]


def _vol(shape, seed=0, tied=False):
    rng = np.random.default_rng(seed)
    if tied:  # repeated values, exact zeros and negatives
        v = (np.floor(rng.uniform(size=shape) * 9) / 8.0 - 0.5)
        return (v * (rng.uniform(size=shape) > 0.4)).astype(np.float32)
    return rng.uniform(size=shape).astype(np.float32)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_median_equals_scipy_reflect(shape, tied):
    vol = _vol(shape, tied=tied)
    got = M.median_filter_3d(torch.from_numpy(vol)).numpy()
    np.testing.assert_array_equal(
        got, ndi.median_filter(vol, size=5, mode="reflect"))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_median_equals_jax_xla_path(shape):
    vol = _vol(shape, seed=1)
    got = M.median_filter_3d(torch.from_numpy(vol)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JP.median_filter_3d(vol)))


def test_plain_median_chunking_is_invisible():
    vol = _vol((9, 8, 10), seed=2)
    t = torch.from_numpy(vol)
    np.testing.assert_array_equal(M.median_filter_3d(t, chunk=4).numpy(),
                                  M.median_filter_3d(t, chunk=16).numpy())


@pytest.mark.parametrize("shape", [(7, 16, 16), (2, 9, 11)])
def test_plain_median_matches_pallas_interpret(shape):
    vol = _vol(shape, seed=3)
    got = M.median_filter_3d(torch.from_numpy(vol)).numpy()
    ref = np.asarray(median_filter_3d_pallas(jnp.asarray(vol), cs=2,
                                             interpret=True))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_symmetric_pad_matches_numpy_for_tiny_axes():
    # scipy 'reflect' is numpy 'symmetric' (edge repeated), which
    # torch.nn.functional.pad(mode="reflect") is not
    for n in (1, 2, 3, 6):
        a = np.arange(n, dtype=np.float32)
        got = M._symmetric_pad(torch.from_numpy(a[None, None]), 2)[0, 0]
        np.testing.assert_array_equal(got.numpy(),
                                      np.pad(a, 2, mode="symmetric"))


def test_auto_dispatch_on_cpu_uses_plain_version_without_launch():
    vol = torch.from_numpy(_vol((4, 9, 7), seed=4))
    with trace.recording() as rec:
        got = M.median_filter_3d_auto(vol, 5)
    assert "median_kernel" not in rec.counters()
    assert torch.equal(got, M.median_filter_3d(vol))


def test_cuda_wrapper_rejects_cpu_tensor():
    with trace.recording() as rec, pytest.raises(ValueError, match="CUDA"):
        M.median_filter_3d_cuda(torch.zeros(3, 4, 5))
    assert "median_kernel" not in rec.counters()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_name_tracks_source_hash(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    (tmp_path / "k.cu").write_text("// two\n")
    second = _build.library_path()
    assert first != second
    assert first.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")


def test_kernel_source_exports_the_bound_symbol():
    src = (_build.CSRC / "median5.cu").read_text()
    assert 'extern "C" int uad_median5_f32(' in src
    assert "pallas_median.py" in src  # names the TPU kernel it replaces



# ---------------------------------------------------------------------------
# the kernel's selection rule


def _windows(kind, n=4096, seed=0):
    """(n, 125) float32 window values of one data set."""
    rng = np.random.default_rng(seed)
    shape = (n, 125)
    if kind == "uniform":
        return rng.uniform(size=shape).astype(np.float32)
    if kind == "tied_signed_zeros":
        v = (np.floor(rng.uniform(size=shape) * 9) / 8.0 - 0.5)
        v = (v * (rng.uniform(size=shape) > 0.4)).astype(np.float32)
        v[rng.uniform(size=shape) < 0.2] = -0.0
        return v
    if kind == "spread":  # e^-80..e^80, both signs, +-0.0 mixed in
        v = (np.exp(rng.uniform(-80, 80, size=shape))
             * rng.choice([-1.0, 1.0], size=shape)).astype(np.float32)
        u = rng.uniform(size=shape)
        v[u < 0.1] = 0.0
        v[u < 0.05] = -0.0
        return v
    if kind == "all_equal":
        return np.repeat(rng.normal(size=(n, 1)), 125, axis=1).astype(
            np.float32)
    if kind in ("62_below", "63_below"):
        # exactly 62 (or 63) keys <= the largest of a low group, the rest in
        # a high group: the median is the high group's smallest key (or the
        # low group's largest)
        k = 62 if kind == "62_below" else 63
        low = rng.uniform(-3.0, -1.0, size=(n, k))
        high = rng.uniform(1.0, 3.0, size=(n, 125 - k))
        if n > 1:  # some windows with the groups tied to one value each
            low[: n // 4] = -2.0
            high[: n // 8] = 2.0
        v = np.concatenate([low, high], axis=1)
        return rng.permuted(v, axis=1).astype(np.float32)
    raise ValueError(kind)


SELECT_KINDS = ["uniform", "tied_signed_zeros", "spread", "all_equal",
                "62_below", "63_below"]


@pytest.mark.parametrize("kind", SELECT_KINDS)
def test_select_reference_equals_sort(kind):
    w = _windows(kind, seed=SELECT_KINDS.index(kind))
    med, rounds = M.median_select_reference(torch.from_numpy(w))
    assert med.dtype == torch.float32 and rounds.dtype == torch.int64
    np.testing.assert_array_equal(med.numpy(), np.sort(w, axis=1)[:, 62])
    assert int(rounds.min()) >= 0 and int(rounds.max()) <= 32
    if kind == "all_equal":
        assert not rounds.any()  # a constant window takes no round


@pytest.mark.parametrize("kind", ["uniform", "tied_signed_zeros", "spread"])
def test_select_reference_equals_scipy_on_volumes(kind):
    """The rule over every window of a volume ('reflect' borders, the
    windows as chip_smoke.py builds them) is scipy's median filter."""
    vol = _windows(kind, n=6 * 9 * 11 // 125 + 1, seed=5).ravel()[
        : 6 * 9 * 11].reshape(6, 9, 11)
    t = torch.from_numpy(vol)
    windows = M._symmetric_pad(t, 2).unfold(0, 5, 1).unfold(1, 5, 1).unfold(
        2, 5, 1).reshape(-1, 125)
    med, _ = M.median_select_reference(windows)
    np.testing.assert_array_equal(
        med.view(vol.shape).numpy(),
        ndi.median_filter(vol, size=5, mode="reflect"))


def test_element_snapping_takes_few_rounds_on_uniform_data():
    """Plain key-space bisection takes ~26 rounds on uniform windows; the
    snapping rule ~6.7 on average and ~9.4 for the slowest of 32."""
    _, rounds = M.median_select_reference(torch.from_numpy(
        _windows("uniform", n=32 * 256, seed=9)))
    assert 5.5 < float(rounds.double().mean()) < 8.0
    warp_max = rounds.view(-1, 32).max(dim=1).values.double().mean()
    assert 8.0 < float(warp_max) < 11.0


def test_order_keys_preserve_float_order():
    v = np.array([-np.inf, -3e38, -1.5, -1e-45, -0.0, 0.0, 1e-45, 2.0,
                  3e38, np.inf], np.float32)
    keys = M._to_key(torch.from_numpy(v))
    assert bool((keys[1:] > keys[:-1]).all())  # -0.0 sorts before +0.0
    assert int(keys.min()) >= 0 and int(keys.max()) <= 0xFFFFFFFF
    back = M._from_key(keys).numpy()
    assert back.tobytes() == v.tobytes()


def test_select_reference_rejects_other_shapes():
    with pytest.raises(ValueError, match="125"):
        M.median_select_reference(torch.zeros(4, 27))
