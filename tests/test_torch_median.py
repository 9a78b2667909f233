"""The port's 5^3 median (ops/median.py) against scipy, the JAX XLA path and
the Pallas kernel in interpret mode (the CUDA kernel itself is held against
the plain version on the card by tests/test_torch_gpu.py)."""

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
    before = M.LAUNCHES
    got = M.median_filter_3d_auto(vol, 5)
    assert M.LAUNCHES == before
    assert torch.equal(got, M.median_filter_3d(vol))


def test_cuda_wrapper_rejects_cpu_tensor():
    before = M.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        M.median_filter_3d_cuda(torch.zeros(3, 4, 5))
    assert M.LAUNCHES == before


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

