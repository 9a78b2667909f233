"""The port's post-processing ops against the JAX ops, exactly, on the same
masks and volumes."""

import numpy as np
import pytest
import torch

from unsupervised_anomaly_detection_brain_mri_tpu.ops import (
    postprocess as JP,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
    postprocess as TP,
)


def _mask(shape, density, seed):
    return np.random.default_rng(seed).uniform(size=shape) < density


def _snake(shape=(2, 9, 9)):
    """One serpentine component: rows joined at alternating ends, so the
    graph distance from its minimal voxel to its end is long."""
    m = np.zeros(shape, bool)
    S, H, W = shape
    m[0, 0::4, :] = True
    for r in range(0, H - 2, 4):
        m[0, r + 1: r + 4, W - 1 if (r // 4) % 2 == 0 else 0] = True
    m[1, H - 1, :] = m[0, H - 1, :]
    return m


@pytest.mark.parametrize("iterations", [1, 3])
def test_binary_erosion_equals_jax(iterations):
    m = _mask((4, 9, 11), 0.8, iterations)
    got = TP.binary_erosion_2d(torch.from_numpy(m), iterations).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(JP.binary_erosion_2d(m, iterations)))


@pytest.mark.parametrize("density", [0.2, 0.45, 0.7])
def test_connected_components_equal_jax(density):
    m = _mask((5, 11, 13), density, int(density * 100))
    got, conv = TP.connected_components_3d(torch.from_numpy(m),
                                           return_converged=True)
    ref, ref_conv = JP.connected_components_3d(m, return_converged=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert conv is True and bool(ref_conv)
    sizes = TP.per_voxel_component_size(got)
    np.testing.assert_array_equal(
        sizes.numpy(), np.asarray(JP.per_voxel_component_size(ref)))


@pytest.mark.parametrize("min_size", [2, 7])
def test_filter_small_components_equals_jax(min_size):
    m = _mask((6, 12, 10), 0.35, min_size)
    got = TP.filter_small_components(torch.from_numpy(m), min_size).numpy()
    ref = np.asarray(JP.filter_small_components(m, min_size))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("max_iters", [1, 2, 1024])
def test_snake_component_equals_jax_including_the_iteration_cap(max_iters):
    m = _snake()
    got, conv = TP.connected_components_3d(torch.from_numpy(m), max_iters,
                                           return_converged=True)
    ref, ref_conv = JP.connected_components_3d(m, max_iters,
                                               return_converged=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert conv == bool(ref_conv) == (max_iters == 1024)
    filt, fconv = TP.filter_small_components(torch.from_numpy(m), 7,
                                             max_iters, return_converged=True)
    rfilt, rconv = JP.filter_small_components(m, 7, max_iters,
                                              return_converged=True)
    np.testing.assert_array_equal(filt.numpy(), np.asarray(rfilt))
    assert fconv == bool(rconv)


@pytest.mark.parametrize("keep_positive", [True, False])
def test_residual_and_prior_equal_jax(keep_positive):
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(3, 8, 8)).astype(np.float32)
    rec = rng.uniform(size=(3, 8, 8)).astype(np.float32)
    q = float(np.quantile(x, 0.9))
    got = TP.positive_residual(torch.from_numpy(x), torch.from_numpy(rec),
                               keep_positive)
    ref = JP.positive_residual(x, rec, keep_positive)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got_p = TP.hyperintensity_prior_mask(got, torch.from_numpy(x), q)
    ref_p = JP.hyperintensity_prior_mask(ref, x, np.float32(q))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))


@pytest.mark.parametrize("shape,density", [
    ((6, 12, 10), 0.1), ((6, 12, 10), 0.5), ((3, 4, 9, 8), 0.3),
    ((2, 2, 5, 6, 7), 0.4), ((1, 1, 1), 1.0), ((4, 5, 6), 0.0)])
def test_labels_are_one_plus_the_minimal_flat_index_as_scipy(shape, density):
    """On converged inputs the labels equal SciPy's 26-connected
    ``ndimage.label`` renamed to 1 + the flat index (within its volume) of
    each component's minimal voxel, stacks included."""
    import _torch_ccl as C

    m = _mask(shape, density, 3)
    got, conv = TP.connected_components_3d(torch.from_numpy(m), 10 ** 6,
                                           return_converged=True)
    assert bool(torch.as_tensor(conv).all())
    np.testing.assert_array_equal(got.numpy(), C.min_index_labels(m))


def test_cpu_masks_never_reach_the_kernels():
    """A CPU tensor takes the plain propagation: the chain's counter
    ``cc_kernel`` stays put, ``cc_rounds`` counts its rounds; the CUDA
    entries refuse it."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import ccl
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import (
        trace,
    )

    m = torch.from_numpy(_mask((5, 11, 13), 0.3, 4))
    with trace.recording() as rec:
        labels, conv = TP.connected_components_3d(m, return_converged=True)
        out = TP.filter_small_components(m, 7)
    counters = rec.counters()
    assert "cc_kernel" not in counters and counters["cc_rounds"] >= 2
    assert conv is True
    np.testing.assert_array_equal(
        out.numpy(), TP.filter_small_components_plain(m, 7).numpy())
    for fn in (ccl.connected_components_3d_cuda,
               lambda x: ccl.filter_small_components_cuda(x, 7)):
        with pytest.raises(ValueError):
            fn(m)
