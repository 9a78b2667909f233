"""The port's loaders and ``evaluate()`` on real-format files against the
JAX package: BrainWeb fetched through the port's downloader from a fake
server that writes MINC1 as BrainWeb ships it (40^3, as
`tests/test_brainweb_fixture.py`), MSLUB and MSISBI2015 as NIfTI and
MSSEG2008 as NRRD in their loaders' naming (`tests/_torch_realdata.py`).

Each package reads its own copy of the tree: both persist the patient
split and the slice cache into the dataset's directory, and a package
given the other's tree would read its split back and prove nothing.

Cut from the real archives: 40^3 volumes (BrainWeb's are 181x217x181);
BrainWeb's normal and severe phantoms at pn0/pn3 x rf0/rf20 (the real
download is all 4 phantoms at 4 x 3 levels); MSLUB 7 patients (the real
30; VAL 5, TEST 2 by ``DATASET_PARTITIONS``' counts), MSISBI2015 6 (VAL
5, TEST 1), MSSEG2008 3 (VAL 2, TEST 1).
"""

import dataclasses
import importlib
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import _torch_realdata as R
from unsupervised_anomaly_detection_brain_mri_tpu import cli as jax_cli
from unsupervised_anomaly_detection_brain_mri_tpu import config as jax_config
from unsupervised_anomaly_detection_brain_mri_tpu.eval import (
    determine_threshold_on_labeled_patients as jax_threshold_transfer,
)
from unsupervised_anomaly_detection_brain_mri_tpu.eval import (
    evaluate as jax_evaluate,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    get_trainer as jax_get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli, config
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import (
    ms_datasets,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.download import (
    download_brainweb_dataset,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.formats import (
    write_nifti,
    write_nrrd,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval import (
    determine_threshold_on_labeled_patients,
    evaluate,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.convert import (
    params_from_flax,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train import (
    get_trainer,
)

jax_ms_datasets = importlib.import_module(
    "unsupervised_anomaly_detection_brain_mri_tpu.data.ms_datasets")

N = 40  # cubic fixture edge
SIZE = 32
METRIC_TOL = 1e-4
PHANTOMS = dict(phantoms=["normal", "msles3"], noise_levels=("pn0", "pn3"),
                inu_levels=("rf0", "rf20"))
ROOTS = {"BRAINWEBDIR": "brainweb", "MSLUBDIR": "mslub",
         "MSISBI2015DIR": "msisbi2015", "MSSEG2008DIR": "msseg2008"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_tree(root, shape=(N, N, N)):
    """The four cohorts under ``root`` (BrainWeb through the port's
    downloader and ``FakeBrainWeb``); returns the fake server."""
    server = R.FakeBrainWeb(shape)
    download_brainweb_dataset(os.path.join(root, ROOTS["BRAINWEBDIR"]),
                              opener=server, **PHANTOMS)
    R.mslub_tree(os.path.join(root, ROOTS["MSLUBDIR"]), write_nifti, 7,
                 shape)
    R.msisbi2015_tree(os.path.join(root, ROOTS["MSISBI2015DIR"]),
                      write_nifti, 6, shape)
    R.msseg2008_tree(os.path.join(root, ROOTS["MSSEG2008DIR"]), write_nrrd, 3,
                     shape)
    R.msisbi2015_tree(os.path.join(root, "msisbi2015_t2"), write_nifti, 2,
                      shape, protocols=("flair", "t2"))
    return server


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("realdata_src"))
    server = make_tree(root)
    return root, server


def copy_of(source_root, dest):
    """A fresh copy of the fixture tree for one package."""
    shutil.copytree(source_root, dest)
    return str(dest)


def paths_of(module, root):
    return module.PathConfig(**{
        f: os.path.join(root, ROOTS[k]) for k, f in (
            ("BRAINWEBDIR", "brainweb_dir"), ("MSLUBDIR", "mslub_dir"),
            ("MSISBI2015DIR", "msisbi2015_dir"),
            ("MSSEG2008DIR", "msseg2008_dir"))})


def test_server_requests_and_the_tree(source):
    root, server = source
    # 2 phantoms x 2 noise x 2 INU levels, and 2 groundtruths
    assert len(server.requests) == 10
    bw = os.path.join(root, ROOTS["BRAINWEBDIR"])
    assert sorted(os.listdir(os.path.join(bw, "normal"))) == [
        f"t2_normal_{n}_{i}.mnc.gz" for n in ("pn0", "pn3")
        for i in ("rf0", "rf20")]
    assert sorted(os.listdir(os.path.join(bw, "groundtruth"))) == [
        "normal.mnc.gz", "severe_lesions.mnc.gz"]


CASES = [("BRAINWEB", "healthy"), ("BRAINWEB", "pathological"),
         ("MSLUB", "pathological"), ("MSISBI2015", "pathological"),
         ("MSSEG2008", "pathological")]


def _pool(ds):
    return {s: (ds.patients_of(s), ds.slices(s), ds.labels(s),
                ds.brainmasks(s)) for s in ("TRAIN", "VAL", "TEST")}


def _assert_same_pool(ours, theirs):
    for s in ("TRAIN", "VAL", "TEST"):
        (p, x, y, b), (q, x2, y2, b2) = ours[s], theirs[s]
        assert [a["name"] for a in p] == [a["name"] for a in q], s
        np.testing.assert_array_equal(x, x2, err_msg=s)
        np.testing.assert_array_equal(y, y2, err_msg=s)
        np.testing.assert_array_equal(b, b2, err_msg=s)


@pytest.mark.parametrize("kind,role", CASES,
                         ids=[f"{k}-{r}" for k, r in CASES])
def test_build_dataset_gives_the_jax_cohort(source, tmp_path, kind, role):
    """``cli.build_dataset`` without ``--synthetic``: the same patients per
    split, and bit-equal slices, labels and brainmasks, cold and again
    from each package's own cache; the first evaluated volume's reload
    (volume, groundtruth, brainmask, skullmap, geometry) bit-equal."""
    trees = {pkg: copy_of(source[0], tmp_path / pkg) for pkg in ("port",
                                                                  "jax")}
    o = dict(sliceStart=0, sliceEnd=N)
    c = dict(outputWidth=SIZE, outputHeight=SIZE)

    def build(mod, cli_mod, root):
        return cli_mod.build_dataset(
            mod.Options(paths=paths_of(mod, root), **o), mod.Config(**c),
            mod.Dataset[kind], role)

    ours = build(config, cli, trees["port"])
    theirs = build(jax_config, jax_cli, trees["jax"])
    assert dataclasses.asdict(ours.options) == dict(
        dataclasses.asdict(theirs.options),
        dir=theirs.options.dir.replace(trees["jax"], trees["port"]))
    assert ours.options.cache
    pool = _pool(ours)
    _assert_same_pool(pool, _pool(theirs))
    split = "TRAIN" if role == "healthy" else "TEST"
    assert pool[split][0] and (role == "healthy" or pool["VAL"][0])
    if role == "pathological":
        assert pool[split][2].sum() > 0  # lesions survive the loader
    # a second build reads each package's persisted split and cache
    _assert_same_pool(_pool(build(config, cli, trees["port"])), pool)
    _assert_same_pool(_pool(build(jax_config, jax_cli, trees["jax"])), pool)

    got = ours.load_volume_and_groundtruth(ours.patients_of(split)[0])
    ref = theirs.load_volume_and_groundtruth(theirs.patients_of(split)[0])
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (N, N, N)
    geo, ref_geo = ours.last_geometry, theirs.last_geometry
    assert geo.keys() == ref_geo.keys()
    for k in geo:
        np.testing.assert_array_equal(np.asarray(geo[k], object),
                                      np.asarray(ref_geo[k], object),
                                      err_msg=k)


def test_msisbi2015_pools_every_protocol_and_reloads_the_first(source,
                                                               tmp_path):
    """With FLAIR and T2 the pool holds both volumes' slices (twice the
    FLAIR-only pool) in both packages; the evaluation's reload reads the
    first protocol volume only."""
    trees = {pkg: copy_of(os.path.join(source[0], "msisbi2015_t2"),
                          tmp_path / pkg) for pkg in ("port", "jax")}
    common = dict(sliceStart=0, sliceEnd=N, sliceResolution=(SIZE, SIZE),
                  partition={"TRAIN": 0.0, "VAL": 0.5, "TEST": 0.5},
                  cache=False)
    out = {}
    for pkg, mod in (("port", ms_datasets), ("jax", jax_ms_datasets)):
        both = mod.MSISBI2015(mod.MSOptions(dir=trees[pkg],
                                            filterProtocol=("FLAIR", "T2"),
                                            **common))
        flair = mod.MSISBI2015(mod.MSOptions(dir=trees[pkg],
                                             filterProtocol=("FLAIR",),
                                             **common))
        assert len(both.patients[0]["filtered_files"]) == 2
        assert sum(len(both.slices(s)) for s in ("VAL", "TEST")) == 2 * sum(
            len(flair.slices(s)) for s in ("VAL", "TEST"))
        patient = both.patients_of("TEST")[0]
        np.testing.assert_array_equal(
            both.load_volume_and_groundtruth(patient)[0],
            flair.load_volume_and_groundtruth(patient)[0])
        out[pkg] = _pool(both)
    _assert_same_pool(out["port"], out["jax"])


# ---------------------------------------------------------------------------
# evaluate() on the loaders' cohorts


@pytest.fixture(scope="module")
def pair():
    """A seeded JAX AE at 32x32 with randomised BN statistics, and the
    port's AE on the same converted weights (float32)."""
    cfg = config.Config(trainer="AE", model="autoencoder", batchsize=8,
                        outputWidth=SIZE, outputHeight=SIZE, zDim=16,
                        compute_dtype="float32")
    jt = jax_get_trainer("AE")(jax_config.Config.from_json(cfg.to_json()))
    js = jt.init_state()
    rng = np.random.default_rng(0)

    def draw(path, a):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 2.0, np.shape(a)).astype(np.float32)
        return rng.normal(0.0, 0.3, np.shape(a)).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(
        draw, jax.device_get(js.batch_stats))
    js = js.replace(batch_stats=jax.tree_util.tree_map(jax.numpy.asarray,
                                                       stats))
    tt = get_trainer("AE")(cfg, device="cpu")
    tt.model.load_state_dict(params_from_flax(jax.device_get(js.params),
                                              stats, tt.model))
    return cfg, jt, js, tt


EVAL_CASES = [("BRAINWEB", True), ("BRAINWEB", False), ("MSLUB", True),
              ("MSISBI2015", False)]


@pytest.mark.parametrize("kind,prior", EVAL_CASES,
                         ids=[f"{k}-{'prior' if p else 'noprior'}"
                              for k, p in EVAL_CASES])
def test_evaluate_matches_jax(source, pair, tmp_path, kind, prior):
    """``evaluate()`` of the cohort's TEST volumes (reloaded from the
    files, zoomed to 32x32, eroded 3 times as the CLI does at 32) with the
    plain median in the port: AUROC, AUPRC, best Dice and its threshold
    within 1e-4 of the JAX package's; for BRAINWEB also the threshold
    fitted on VAL."""
    cfg, jt, js, tt = pair
    trees = {pkg: copy_of(source[0], tmp_path / pkg) for pkg in ("port",
                                                                  "jax")}
    kw = dict(sliceStart=0, sliceEnd=N, erosionIterations=3,
              applyHyperIntensityPrior=prior)
    opts = config.Options(paths=dataclasses.replace(
        paths_of(config, trees["port"]),
        sample_dir=str(tmp_path / "port_samples")), **kw)
    jopts = jax_config.Options(paths=dataclasses.replace(
        paths_of(jax_config, trees["jax"]),
        sample_dir=str(tmp_path / "jax_samples")), **kw)
    ds = cli.build_dataset(opts, cfg, config.Dataset[kind], "pathological")
    jds = jax_cli.build_dataset(
        jopts, jax_config.Config.from_json(cfg.to_json()),
        jax_config.Dataset[kind], "pathological")
    got = evaluate(ds, tt, opts, cfg)
    ref = jax_evaluate(jds, jt, js, jopts, jt.config)
    assert got["slices_per_patient"] == ref["slices_per_patient"] == [N] * len(
        ds.patients_of("TEST"))
    for k in ("diff_AUC", "diff_AUPRC", "bestDiceScore", "bestThreshold"):
        assert np.isfinite(got[k]), k
        assert abs(got[k] - ref[k]) <= METRIC_TOL, (k, got[k], ref[k])
    if kind == "BRAINWEB" and not prior:
        o = opts.replace(threshold=None)
        best, t = determine_threshold_on_labeled_patients([ds], tt, o, cfg)
        jbest, jt_ = jax_threshold_transfer(
            [jds], jt, js, jopts.replace(threshold=None), jt.config)
        assert abs(best - jbest) <= METRIC_TOL
        assert abs(t - jt_) <= METRIC_TOL
