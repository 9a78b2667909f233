"""The traffic generators: the same seed gives the same data, another seed
other data of the same sizes, and the copies equal their originals."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark.common import phantoms as P

ROOT = Path(__file__).resolve().parents[2]


def test_training_pool_is_a_function_of_the_seed():
    a = P.training_pool(7, 2, 32, 12)
    b = P.training_pool(7, 2, 32, 12)
    c = P.training_pool(8, 2, 32, 12)
    assert a.shape == c.shape == (24, 32, 32, 1) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert 0.0 <= a.min() and a.max() <= 1.0


def test_served_scans_are_a_function_of_the_seed_with_fixed_sizes():
    shape, lesions = (45, 54, 20), [0, 1, 2, 3]
    a, share_a, brain_a = P.served_scans(2 ** 40 + 5, shape, lesions,
                                         [0, 3], [0, 20])
    b, share_b, _ = P.served_scans(2 ** 40 + 5, shape, lesions, [0, 3],
                                   [0, 20])
    c, _, _ = P.served_scans(11, shape, lesions, [0, 3], [0, 20])
    assert [v.shape for v in a] == [shape] * 4 == [v.shape for v in c]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert share_a == share_b and 0.0 < share_a < 0.05
    assert all(n > 0 for n in brain_a)
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))


def test_make_phantom_equals_the_ports():
    port = importlib.import_module(
        "unsupervised_anomaly_detection_brain_mri_tpu_torch.data.synthetic")
    for lesions in (False, True):
        mine = P.make_phantom(np.random.default_rng(3), 32, 16, lesions)
        theirs = port.make_phantom(np.random.default_rng(3), 32, 16, lesions)
        for k in theirs:
            np.testing.assert_array_equal(mine[k], theirs[k])


def test_normalize_equals_the_ports():
    port = importlib.import_module(
        "unsupervised_anomaly_detection_brain_mri_tpu_torch.data.preprocess")
    v = np.random.default_rng(1).gamma(2.0, 100.0, (20, 20, 8))
    np.testing.assert_array_equal(
        P.normalize_volume(v), port.normalize_volume(v, "scaling",
                                                     upper_percentile=99.8))


def test_head_and_intensity_equal_the_test_fixtures():
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        fixture = importlib.import_module("_torch_realdata")
    finally:
        sys.path.remove(str(ROOT / "tests"))
    shape = (30, 36, 30)
    for n in range(4):
        mine = P.head_labels(shape, n, np.random.default_rng(n))
        theirs = fixture.head_labels(shape, n, np.random.default_rng(n))
        np.testing.assert_array_equal(mine, theirs)
        np.testing.assert_array_equal(
            P.intensity(mine, P.FLAIR, np.random.default_rng(9), 3.0, 20.0),
            fixture.intensity(theirs, fixture._FLAIR,
                              np.random.default_rng(9), 3.0, 20.0))


@pytest.mark.parametrize("mix", ["train", "serve"])
def test_mix_files_hold_parameters_only(mix):
    from benchmark.common import manifest as M

    data = M.read_json(M.BENCH / "traffic" / f"{mix}.json")
    assert data["kind"] == mix
    assert all(isinstance(v, (int, float, str, list, dict))
               for v in data.values())
