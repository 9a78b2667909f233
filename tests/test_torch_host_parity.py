"""The port's own host layer against the JAX package's: each copied
module's code equals its JAX source; config, presets, the CLI parser,
``config.json``, the phantom, normalisation, the volume formats, the
native helper library and the TFRecord interchange, on the same inputs.
And the trainer's default device: the card."""

import ast
import dataclasses
import enum
import inspect
import json
import os

import numpy as np
import pytest
import torch

from unsupervised_anomaly_detection_brain_mri_tpu import cli as jax_cli
from unsupervised_anomaly_detection_brain_mri_tpu import config as jax_config
from unsupervised_anomaly_detection_brain_mri_tpu.data import (
    formats as jax_formats,
)
from unsupervised_anomaly_detection_brain_mri_tpu.data import (
    native as jax_native,
)
from unsupervised_anomaly_detection_brain_mri_tpu.data import (
    preprocess as jax_preprocess,
)
from unsupervised_anomaly_detection_brain_mri_tpu.data import (
    synthetic as jax_synthetic,
)
from unsupervised_anomaly_detection_brain_mri_tpu.data import (
    tfrecord as jax_tfrecord,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli
from unsupervised_anomaly_detection_brain_mri_tpu_torch import config
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import (
    formats,
    native,
    preprocess,
    synthetic,
    tfrecord,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.base import (
    BaseTrainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "unsupervised_anomaly_detection_brain_mri_tpu"
PORT_PKG = JAX_PKG + "_torch"


def _plain(obj):
    """A dataclass tree as JSON-able values (enums by value)."""
    return json.loads(json.dumps(
        dataclasses.asdict(obj),
        default=lambda o: o.value if isinstance(o, enum.Enum) else str(o)))


# ---------------------------------------------------------------------------
# the copies' code


def _statements(pkg, rel):
    """The top-level statements of ``pkg/rel`` without the module
    docstring, as AST dumps, with the port's package name read as the JAX
    package's."""
    with open(os.path.join(ROOT, pkg, rel)) as f:
        tree = ast.parse(f.read().replace(PORT_PKG, JAX_PKG))
    body = tree.body[1:] if ast.get_docstring(tree) is not None else tree.body
    return [(_defines(node), ast.dump(node)) for node in body]


def _defines(node):
    if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
        return {node.name}
    targets = getattr(node, "targets", None) or [getattr(node, "target",
                                                         None)]
    return {n.id for t in targets if t is not None
            for n in ast.walk(t) if isinstance(n, ast.Name)}


# (module, whole copy, names the port defines differently)
COPIES = [
    ("config.py", True, ()),
    ("utils/misc.py", False, ()),  # only json_sanitize
    ("data/formats.py", True, ()),
    ("data/volume.py", True, ()),
    # the library is built from the port's csrc_host/ into build/native/
    ("data/native.py", True, ("_PKG", "_SRC", "_SO", "_build")),
    ("data/preprocess.py", True, ()),
    ("data/synthetic.py", True, ()),
    ("data/base.py", True, ()),
    ("data/tfrecord.py", True, ()),
    ("data/brainweb.py", True, ()),
    ("data/ms_datasets.py", True, ()),
    ("eval/artifacts.py", True, ()),
    ("data/validate.py", True, ()),
]


@pytest.mark.parametrize("rel,whole,exempt", COPIES,
                         ids=[c[0] for c in COPIES])
def test_copied_module_code_equals_jax(rel, whole, exempt):
    """Only the module docstring, the package name and the exempt names
    may differ, so a one-sided edit to either copy fails here."""
    def kept(pkg):
        return [dump for names, dump in _statements(pkg, rel)
                if not names & set(exempt)]

    ours, theirs = kept(PORT_PKG), kept(JAX_PKG)
    if whole:
        assert ours == theirs
    else:  # a part: the port's statements, in the JAX module's order
        it = iter(theirs)
        assert all(dump in it for dump in ours)
    port_names = set().union(*(n for n, _ in _statements(PORT_PKG, rel)))
    assert set(exempt) <= port_names


# ---------------------------------------------------------------------------
# config


@pytest.mark.parametrize("name", ["Config", "Options", "PathConfig",
                                  "MeshConfig"])
def test_dataclass_fields_and_defaults_equal_jax(name):
    ours, theirs = getattr(config, name), getattr(jax_config, name)
    assert ours is not theirs
    assert ([f.name for f in dataclasses.fields(ours)]
            == [f.name for f in dataclasses.fields(theirs)])
    assert _plain(ours()) == _plain(theirs())


@pytest.mark.parametrize("name", ["Dataset", "Optimizer"])
def test_enums_equal_jax_by_value(name):
    ours, theirs = getattr(config, name), getattr(jax_config, name)
    assert [(m.name, m.value) for m in ours] == [(m.name, m.value)
                                                 for m in theirs]
    for m in ours:  # str-enums compare equal by value across the packages
        assert m == theirs(m.value) and ours(theirs(m.value)) is m


@pytest.mark.parametrize("name", sorted(jax_config.EXPERIMENT_PRESETS))
def test_preset_equals_jax(name):
    assert config.EXPERIMENT_PRESETS[name] == \
        jax_config.EXPERIMENT_PRESETS[name]
    assert config.preset(name).to_json() == jax_config.preset(name).to_json()
    ours = config.preset(name, zDim=64)
    assert ours.to_json() == jax_config.preset(name, zDim=64).to_json()
    assert ours.model_dir("Synth") == jax_config.preset(
        name, zDim=64).model_dir("Synth")


def _nondefault(module):
    return module.Config(
        trainer="VAE_You", model="variational_autoencoder", batchsize=3,
        learningrate=2e-3, optimizer=module.Optimizer.RMSPROP,
        intermediateResolutions=(4, 8), mesh=module.MeshConfig(data=2),
        compute_dtype="float32", tv_lambda=0.4, seed=7)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_config_json_round_trip_across_packages(direction, tmp_path):
    src, dst = ((jax_config, config) if direction == "jax_to_port"
                else (config, jax_config))
    cfg = _nondefault(src)
    path = tmp_path / "config.json"
    path.write_text(cfg.to_json())
    back = dst.Config.from_json(path.read_text())
    assert type(back) is dst.Config
    assert isinstance(back.optimizer, dst.Optimizer)
    assert isinstance(back.mesh, dst.MeshConfig)
    assert back.intermediateResolutions == (4, 8)
    assert back.to_json() == cfg.to_json()
    assert back == _nondefault(dst)


# ---------------------------------------------------------------------------
# CLI


def _actions(parser):
    return [(a.option_strings, a.dest, a.default, a.choices, a.nargs, a.type,
             a.const, a.required, a.help) for a in parser._actions]


def test_parser_flags_defaults_and_choices_equal_jax():
    assert cli.CLI_DEFAULTS == jax_cli.CLI_DEFAULTS
    ours, theirs = cli.make_parser(), jax_cli.make_parser()
    assert _actions(ours) == _actions(theirs)
    assert ours.description == theirs.description
    argv = ["--preset", "VAE", "-w", "64", "-n", "4", "--precision",
            "float32", "--synthetic", "--tpu-fast", "-L", "0.01"]
    assert vars(ours.parse_args(argv)) == vars(theirs.parse_args(argv))


@pytest.mark.parametrize("kind,role", [("SYNTH", "healthy"),
                                       ("SYNTH", "pathological")])
def test_build_dataset_gives_the_jax_cohort(kind, role):
    o = dict(sliceStart=0, sliceEnd=8, cache=False)
    ours = cli.build_dataset(config.Options(**o),
                             config.Config(outputWidth=32, outputHeight=32),
                             config.Dataset[kind], role)
    theirs = jax_cli.build_dataset(
        jax_config.Options(**o),
        jax_config.Config(outputWidth=32, outputHeight=32),
        jax_config.Dataset[kind], role)
    assert type(ours) is synthetic.SYNTH
    assert dataclasses.asdict(ours.options) == dataclasses.asdict(
        theirs.options)
    for split in ("TRAIN", "VAL", "TEST"):
        assert ours.patients_of(split) == theirs.patients_of(split)
        np.testing.assert_array_equal(ours.slices(split),
                                      theirs.slices(split))


def test_build_dataset_rejects_unknown_like_jax():
    for module, cfg_module in ((cli, config), (jax_cli, jax_config)):
        with pytest.raises(ValueError, match="unknown dataset"):
            module.build_dataset(cfg_module.Options(), cfg_module.Config(),
                                 "nope", "healthy")


# ---------------------------------------------------------------------------
# data


@pytest.mark.parametrize("seed,lesions", [(0, True), (3, False)])
def test_make_phantom_bit_equal(seed, lesions):
    ours = synthetic.make_phantom(np.random.default_rng(seed), 32, 12,
                                  lesions)
    theirs = jax_synthetic.make_phantom(np.random.default_rng(seed), 32, 12,
                                        lesions)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        assert ours[k].tobytes() == theirs[k].tobytes(), k


@pytest.mark.parametrize("method,lower", [("scaling", None),
                                          ("standardization", 1.0)])
def test_normalize_volume_equals_jax(method, lower):
    vol = np.random.default_rng(2).gamma(2.0, 50.0, size=(20, 18, 6))
    vol[0, 0, 0] = np.nan
    kw = dict(method=method, lower_percentile=lower, upper_percentile=99.0)
    ours = preprocess.normalize_volume(vol, **kw)
    theirs = jax_preprocess.normalize_volume(vol, **kw)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


def _volume():
    return np.random.default_rng(7).normal(size=(9, 7, 5)).astype(np.float32)


@pytest.mark.parametrize("direction", ["port_writes", "jax_writes"])
def test_nifti_round_trip_across_packages(direction, tmp_path):
    write, read = ((formats.write_nifti, jax_formats.read_nifti)
                   if direction == "port_writes"
                   else (jax_formats.write_nifti, formats.read_nifti))
    vol = _volume()
    affine = np.array([[0.0, 1.1, 0.0, -10.0], [1.2, 0.0, 0.0, 20.0],
                       [0.0, 0.0, 1.3, 5.0], [0.0, 0.0, 0.0, 1.0]])
    path = str(tmp_path / "v.nii.gz")
    write(path, vol, affine=affine)
    data, meta = read(path)
    assert data.shape == vol.shape
    np.testing.assert_array_equal(data, vol)
    np.testing.assert_allclose(np.asarray(meta["affine"])[:3], affine[:3],
                               atol=1e-6)


@pytest.mark.parametrize("encoding", ["raw", "gzip"])
def test_nrrd_round_trip_across_packages(encoding, tmp_path):
    vol = _volume()
    a, b = str(tmp_path / "a.nrrd"), str(tmp_path / "b.nrrd")
    formats.write_nrrd(a, vol, encoding=encoding)
    jax_formats.write_nrrd(b, vol, encoding=encoding)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(jax_formats.read_nrrd(a)[0], vol)
    np.testing.assert_array_equal(formats.read_nrrd(b)[0], vol)


def test_minc1_round_trip_across_packages(tmp_path):
    vol = _volume()
    a, b = str(tmp_path / "a.mnc"), str(tmp_path / "b.mnc")
    formats.write_minc1(a, vol)
    jax_formats.write_minc1(b, vol)
    np.testing.assert_allclose(jax_formats.read_minc(a)[0],
                               formats.read_minc(b)[0], rtol=0, atol=0)


def test_native_library_builds_from_the_port_into_build():
    """The port's copy of the native helpers lives in its package and is
    built under ``<repo>/build/``, never beside the source or in
    ``native/``."""
    src = os.path.join(ROOT, "unsupervised_anomaly_detection_brain_mri_tpu_"
                             "torch", "csrc_host", "uadmri_native.cpp")
    assert os.path.abspath(native._SRC) == src
    assert os.path.abspath(native._SO).startswith(
        os.path.join(ROOT, "build") + os.sep)
    with open(src) as f, open(os.path.join(ROOT, "native",
                                           "uadmri_native.cpp")) as g:
        assert f.read() == g.read()


def test_native_helpers_equal_jax(tmp_path):
    if not (native.available() and jax_native.available()):
        pytest.skip("no C++ compiler for the native helpers")
    rng = np.random.default_rng(8)
    vol = rng.gamma(2.0, 40.0, size=(3000,)).astype(np.float32)
    np.testing.assert_array_equal(
        native.percentile_normalize(vol.copy(), 1.0, 99.0),
        jax_native.percentile_normalize(vol.copy(), 1.0, 99.0))
    img = rng.uniform(size=(21, 17)).astype(np.float32)
    np.testing.assert_array_equal(native.resize_bilinear(img, 32, 30),
                                  jax_native.resize_bilinear(img, 32, 30))
    images = rng.uniform(size=(4, 8, 8)).astype(np.float32)
    labels = (images > 0.5).astype(np.float32)
    sets = np.array([0, 1, 2, 0], np.int32)
    path = str(tmp_path / "pool.uadc")
    native.write_cache(path, images, labels, sets)
    for got, want in zip(jax_native.read_cache(path, mmap=False),
                         (images, labels, sets)):
        np.testing.assert_array_equal(got, want)
    data = rng.bytes(1000)
    assert native.crc32c(data) == jax_native.crc32c(data)


@pytest.mark.parametrize("direction", ["port_writes", "jax_writes"])
def test_tfrecord_round_trip_across_packages(direction, tmp_path):
    write, read = ((tfrecord.write_tf_record, jax_tfrecord.read_tf_record)
                   if direction == "port_writes"
                   else (jax_tfrecord.write_tf_record,
                         tfrecord.read_tf_record))
    rng = np.random.default_rng(9)
    images = rng.uniform(size=(5, 6, 6)).astype(np.float32)
    labels = (images > 0.7).astype(np.float32)
    sets = np.array([0, 0, 1, 2, 2], np.int32)
    path = str(tmp_path / "pool.tfrecord")
    write(images, labels, sets, path)
    for got, want in zip(read(path, verify=True), (images, labels, sets)):
        np.testing.assert_array_equal(np.asarray(got).reshape(want.shape),
                                      want)


# ---------------------------------------------------------------------------
# the trainer's device


def test_trainer_asks_for_the_card_by_default():
    assert inspect.signature(BaseTrainer.__init__).parameters[
        "device"].default == "cuda"
    cfg = config.Config(outputWidth=32, outputHeight=32, zDim=16)
    if torch.cuda.is_available():
        assert get_trainer("AE")(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            get_trainer("AE")(cfg)
