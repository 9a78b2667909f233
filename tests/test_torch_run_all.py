"""The port's all-preset sweep (``run_all.py``) on the CPU: its copies of
``compare_scoreboard`` and ``_comparable_settings`` against
`examples/run_all.py` on the JAX tests' cases, ``--device`` left out of the
settings in every spelling, the exits (``--download``, an unknown preset, a
preset that raises), the three committed tables, the JAX seed spread's
file, and the five presets whose quality left the JAX table, from one
start in both packages: one epoch (``AAE``, ``fAnoGAN``,
``GMVAE_spatial``) or one recipe batch against the JAX package's own
spread over row orders (``constrainedAAE``, ``constrainedAAE_Chen``).
"""

import contextlib
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    Config as JaxConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    Options as JaxOptions,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    get_trainer as jax_get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli, run_all
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
    EXPERIMENT_PRESETS,
    Options,
    preset,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.convert import (
    params_from_flax,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = {name: os.path.join(run_all.SCOREBOARDS, f"{name}.json")
          for name in ("expected_cpu", "expected_h100", "expected_h100_fast")}
JAX_TABLE = os.path.join(ROOT, "examples", "scoreboard_expected.json")
SEEDS = os.path.join(run_all.SCOREBOARDS, "jax_cpu_seeds.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker process: the suite runs several."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_run_all():
    spec = importlib.util.spec_from_file_location(
        "jax_run_all", os.path.join(ROOT, "examples", "run_all.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# the comparison, against the JAX original

_EXP = {"tolerances": {"AUROC": 0.05, "finalTrainLoss": 0.35},
        "presets": {"AE": {"AUROC": 0.90, "finalTrainLoss": 100.0},
                    "VAE": {"AUROC": 0.95}}}
_GOOD = {"AE": [{"AUROC": 0.93, "finalTrainLoss": 120.0}],
         "VAE": [{"AUROC": 0.92}]}
_SET = dict(_EXP, settings=["--synthetic", "-E", "1", "-w", "32"])
COMPARE_CASES = {
    "good": (_GOOD, _EXP),
    "regressed_and_nan": ({"AE": [{"AUROC": 0.80, "finalTrainLoss": 100.0}],
                           "VAE": [{"AUROC": float("nan")}]}, _EXP),
    "missing_preset": ({"AE": [{"AUROC": 0.9, "finalTrainLoss": 100.0}]},
                       _EXP),
    "relative_loss": ({"AE": [{"AUROC": 0.9, "finalTrainLoss": 200.0}],
                       "VAE": [{"AUROC": 0.95}]}, _EXP),
    "backend_mismatch": (dict(_GOOD, _backend="tpu"),
                         dict(_EXP, backend="cpu")),
    "backend_match": (dict(_GOOD, _backend="cpu"), dict(_EXP, backend="cpu")),
    "settings_mismatch": (dict(_GOOD, _settings=["--synthetic", "-E", "4",
                                                 "-w", "32"]), _SET),
    "settings_swapped": (dict(_GOOD, _settings=["--synthetic", "-E", "32",
                                                "-w", "1"]), _SET),
    "settings_bare": (dict(_GOOD, _settings=[]), _SET),
    **{f"config_{i}": (dict(_GOOD, _settings=["-w", "32", *spelling,
                                              "--synthetic", "-E", "1"]),
                       _SET)
       for i, spelling in enumerate((["-c", "/tmp/x/paths.json"],
                                     ["--config", "/tmp/x/paths.json"],
                                     ["--config=/tmp/x/paths.json"],
                                     ["-c/tmp/x/paths.json"]))},
    "profile_mismatch": ({"_backend": "cpu", "_profile": "parity",
                          "AE": [{"AUROC": 0.9}]},
                         {"backend": "cpu", "profile": "tpu-fast",
                          "presets": {"AE": {"AUROC": 0.9}}}),
    "profile_flags_dropped": ({"_backend": "cpu", "_profile": "parity",
                               "_settings": ["-E", "1"],
                               "AE": [{"AUROC": 0.9}]},
                              {"backend": "cpu", "profile": "parity",
                               "settings": ["--parity", "-E", "1"],
                               "presets": {"AE": {"AUROC": 0.9}}}),
}
SETTINGS_CASES = [
    ["--tv-lambda", "-1", "-E", "1"],
    ["--numEpochs", "1", "-w", "32"],
    ["-E", "1", "--outputWidth", "32"],
    ["--synthetic", "-E", "1", "-w", "32", "-c", "/p.json"],
    ["--tpu-fast", "-E", "1", "--parity"],
    ["-cfoo.json", "--config=bar.json", "-b", "8", "-O", "0.5"],
]


@pytest.mark.parametrize("case", sorted(COMPARE_CASES))
def test_compare_scoreboard_matches_the_jax_original(case):
    """The port's copy gives ``examples/run_all.py``'s answers (the hint
    after a refusal's dash names the port's tables), and the answer each
    case's JAX test asserts."""
    scoreboard, expected = COMPARE_CASES[case]
    theirs = _jax_run_all().compare_scoreboard(scoreboard, expected)
    ours = run_all.compare_scoreboard(scoreboard, expected)
    assert ([p.split(" — ")[0] for p in ours]
            == [p.split(" — ")[0] for p in theirs])
    passes = case in ("good", "backend_match", "profile_flags_dropped") \
        or case.startswith("config_")
    assert (ours == []) == passes, ours
    for key, word in (("backend_mismatch", "backend mismatch"),
                      ("profile_mismatch", "profile mismatch"),
                      ("settings_", "settings mismatch"),
                      ("missing_preset", "no scoreboard rows"),
                      ("relative_loss", "finalTrainLoss"),
                      ("regressed_and_nan", "NaN")):
        if case.startswith(key):
            assert any(word in p for p in ours), ours


@pytest.mark.parametrize("tokens", SETTINGS_CASES,
                         ids=lambda t: "_".join(t)[:40])
def test_comparable_settings_matches_the_jax_original(tokens):
    assert (run_all._comparable_settings(tokens)
            == _jax_run_all()._comparable_settings(tokens))


@pytest.mark.parametrize("spelling", [
    ["--device", "cuda"], ["--device=cuda"], ["--device", "cpu"],
    ["--devic", "cuda:0"], ["--dev=cpu"], ["--de", "cpu"]])
def test_device_is_left_out_of_the_settings_in_every_spelling(spelling):
    recipe = ["--synthetic", "-E", "1", "-w", "32"]
    assert (run_all._comparable_settings(recipe[:1] + spelling + recipe[1:])
            == run_all._comparable_settings(recipe))
    expected = dict(_EXP, settings=recipe)
    assert run_all.compare_scoreboard(
        dict(_GOOD, _settings=spelling + recipe), expected) == []
    # its value never lands on another flag
    assert "cuda" not in str(run_all._comparable_settings(spelling + ["-E",
                                                                       "1"]))


# ---------------------------------------------------------------------------
# the exits


def test_download_exits_2(capsys):
    assert run_all.main(["--download", "--synthetic", "--device", "cpu"]) == 2
    assert "not ported" in capsys.readouterr().err


def test_unknown_preset_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(cli, "main", lambda argv: pytest.fail("ran"))
    assert run_all.main(["--presets", "AE,NoSuchNet", "--device", "cpu"]) == 2
    assert "NoSuchNet" in capsys.readouterr().err


def test_a_preset_that_raises_is_listed_as_failed(monkeypatch, tmp_path,
                                                  capsys):
    """The sweep goes on past it, the scoreboard keeps the others' rows,
    and the exit code is 1."""
    ran = []

    def fake_main(argv):
        name = argv[argv.index("--preset") + 1]
        ran.append(name)
        if name == "VAE":
            raise RuntimeError("boom")
        with open(argv[argv.index("--metrics-out") + 1], "w") as f:
            f.write(json.dumps({"AUROC": 0.9}) + "\n")
        return 0

    monkeypatch.setattr(cli, "main", fake_main)
    board = tmp_path / "sb.json"
    rc = run_all.main(["--presets", "AE,VAE,CE", "--scoreboard", str(board),
                       "--synthetic", "--device", "cpu"])
    assert rc == 1 and ran == ["AE", "VAE", "CE"]
    out = capsys.readouterr()
    assert "FAILED presets: ['VAE']" in out.out and "boom" in out.err
    sb = json.loads(board.read_text())
    assert set(sb) >= {"AE", "CE"} and "VAE" not in sb
    assert (sb["_backend"], sb["_profile"]) == ("cpu", "parity")
    assert sb["_settings"] == ["--synthetic", "--device", "cpu"]
    assert sb["_device"] is None and set(sb["_wall_s"]) == {"AE", "VAE", "CE"}


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cli, "main", lambda argv: pytest.fail("ran"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_all.main(["--presets", "AE", "--synthetic"])


# ---------------------------------------------------------------------------
# the tables


@pytest.mark.parametrize("name", sorted(TABLES))
def test_table_is_complete(name):
    """18 presets, the backend and profile, the JAX tables' recipe under
    ``_comparable_settings`` and their tolerances, AUROC in [0.5, 1]."""
    with open(TABLES[name]) as f:
        table = json.load(f)
    with open(JAX_TABLE) as f:
        jax_table = json.load(f)
    assert set(table["presets"]) == set(EXPERIMENT_PRESETS)
    assert table["backend"] == ("cpu" if name == "expected_cpu" else "cuda")
    assert table["profile"] == ("tpu-fast" if name.endswith("_fast")
                                else "parity")
    assert (run_all._comparable_settings(table["settings"])
            == run_all._comparable_settings(jax_table["settings"]))
    assert table["tolerances"] == jax_table["tolerances"]
    for preset_name, row in table["presets"].items():
        assert 0.5 <= row["AUROC"] <= 1.0, preset_name
        assert set(row) >= {"AUROC", "AUPRC", "bestDice", "finalTrainLoss"}


def test_jax_seed_spread_file():
    """The JAX package's spread at the tables' recipe: every preset, >= 5
    seeds (>= 3 for constrainedAAE_Chen), min <= median <= max."""
    with open(SEEDS) as f:
        seeds = json.load(f)
    with open(JAX_TABLE) as f:
        jax_table = json.load(f)
    assert (run_all._comparable_settings(seeds["recipe"])
            == run_all._comparable_settings(jax_table["settings"]))
    assert seeds["commit"] and set(seeds["presets"]) == set(EXPERIMENT_PRESETS)
    for name, row in seeds["presets"].items():
        assert len(row["seeds"]) >= (3 if name == "constrainedAAE_Chen"
                                     else 5), name
        for key in run_all.METRIC_KEYS:
            if row[key] is None:
                assert key == "finalTrainLoss" and name.startswith("fAnoGAN")
                continue
            assert row[key]["min"] <= row[key]["median"] <= row[key]["max"]
            assert len(row[key]["values"]) == len(row["seeds"])


# ---------------------------------------------------------------------------
# step 0: the five presets whose quality left the JAX table, from one start
#
# Each left the JAX table by its init draw: at the recipe, the JAX
# package's own other seeds move every one of them as far (PERF.md, the
# seed spread; scoreboards/jax_cpu_seeds.json).  From one start with the
# draws given, one epoch agrees (AAE, fAnoGAN, GMVAE_spatial), and where
# lr 1e-3 and 20 AE updates a batch amplify rounding (constrainedAAE,
# Chen), the port's batch lies inside the spread that the JAX package
# shows when only the order of the batch's rows changes.

def _one_start():
    spec = importlib.util.spec_from_file_location(
        "one_start_epoch", os.path.join(ROOT, "tools", "one_start_epoch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# a free-running epoch of float32 updates from one start drifts at the
# (Leaky)ReLU kinks and Adam's sign flips of near-zero gradients
EPOCH_RTOL = 0.02


@pytest.mark.parametrize("name", ["AAE", "fAnoGAN", "GMVAE_spatial"])
def test_one_epoch_from_one_start_matches_jax(name):
    """One epoch at the recipe's widths (32x32, zDim 16, batch 8, float32;
    the CLI's healthy cohort cut to 6 phantoms) from the JAX init with
    dropout 0 and the draws given: every TRAIN and VAL loss within
    EPOCH_RTOL, and the same number of updates of each optimizer group
    (AE, critic and generator updates per batch)."""
    out = _one_start().one_epoch(name, patients=6)
    assert [(h["epoch"], h["phase"]) for h in out["port"]] == [
        (h["epoch"], h["phase"]) for h in out["jax"]]
    assert len(out["jax"]) >= 2
    for want, got in zip(out["jax"], out["port"]):
        assert set(got) == set(want)
        for key, value in want.items():
            if key not in ("epoch", "phase"):
                np.testing.assert_allclose(
                    got[key], value, rtol=EPOCH_RTOL, atol=1e-6,
                    err_msg=f"{name} {want['phase']} {key}")
    assert out["port_updates"] == out["jax_updates"]


def _recipe_batch(name):
    """A JAX trainer, the port's on the JAX init, and the recipe cohort's
    first batch."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.synthetic import (
        SYNTH,
        SyntheticOptions,
    )

    cfg = preset(name).replace(batchsize=8, zDim=16, outputWidth=32,
                               outputHeight=32, compute_dtype="float32",
                               numEpochs=1, dropout_rate=0.0)
    jt = jax_get_trainer(cfg.trainer)(JaxConfig.from_json(cfg.to_json()),
                                      JaxOptions())
    js = jt.init_state()
    tt = get_trainer(cfg.trainer)(cfg, Options(), device="cpu")
    tt.init_state()
    tt.model.load_state_dict(params_from_flax(
        jax.device_get(js.params), jax.device_get(js.batch_stats), tt.model))
    ds = SYNTH(SyntheticOptions(numPatients=4, imageSize=32, numSlices=8,
                                targetSize=32, partition={
                                    "TRAIN": 0.7, "VAL": 0.3, "TEST": 0.0}))
    x = tt._pool_from_dataset(ds, "TRAIN")["x"].numpy()[:8]
    return jt, js, tt, x


ROW_ORDERS = [np.arange(8), np.array([3, 1, 7, 0, 5, 2, 6, 4]),
              np.arange(8)[::-1], np.array([1, 0, 3, 2, 5, 4, 7, 6]),
              np.array([6, 4, 2, 0, 7, 5, 3, 1])]


@pytest.mark.parametrize("name,dim,critic_rtol", [
    ("constrainedAAE", 0, 1e-4), ("constrainedAAE_Chen", 8, 1e-2)])
def test_critic_schedule_batch_within_jax_rounding_spread(name, dim,
                                                          critic_rtol):
    """One batch of the schedule at the recipe (lr 1e-3; Chen's ResNets at
    ``dim`` 8) from the JAX init, dropout 0, the draws given: 20 AE, 20
    critic and 1 generator update in both packages (each group's update
    count), and every loss of the port's batch within the JAX package's
    own spread over ROW_ORDERS, widened by that spread.  Reordering the
    batch's rows (and the draws' rows with them) is the same update up to
    float32 rounding, which Adam's first steps at lr 1e-3 amplify: the
    sign of a near-zero gradient moves its parameter by a whole lr.

    With one AE update (an epoch past 5) before the 20 critic updates, the
    batch's losses agree within 1e-4 relative; Chen's critic and
    generator losses within ``critic_rtol`` (1e-2): its LayerNorm-fed
    parameters take Adam's first step of either sign."""
    one_start = _one_start()
    with contextlib.ExitStack() as stack:
        if dim:
            stack.enter_context(one_start.resnet_dim(dim))
        jt, js, tt, x = _recipe_batch(name)
        jstep = jax.jit(jt._build_train_step(**jt.epoch_static(0, "TRAIN")))
        runs = []
        for order in ROW_ORDERS:
            with one_start.given_draws(order):
                runs.append(jstep(js, {"x": jnp.asarray(x[order])}))
        with one_start.given_draws():
            tt.epoch = 0
            tm = tt.train_step({"x": torch.from_numpy(x)})
            port_updates = one_start._port_counts(tt.optimizer)
            jm1 = jax.jit(jt._build_train_step(ae_iters=1))(
                js, {"x": jnp.asarray(x)})[1]
            tt.init_state()
            tt.model.load_state_dict(params_from_flax(
                jax.device_get(js.params), jax.device_get(js.batch_stats),
                tt.model))
            tt.epoch = 6
            tm1 = tt.train_step({"x": torch.from_numpy(x)})
    for k in jm1:
        np.testing.assert_allclose(
            float(tm1[k]), float(jm1[k]), atol=1e-6, err_msg=f"{name} {k}",
            rtol=critic_rtol if k in ("disc_loss", "gen_loss") else 1e-4)
    updates = {"ae": 20, "disc": 20, "gen": 1}
    assert port_updates == updates
    assert one_start._jax_counts(jax.device_get(runs[0][0].opt_states)) \
        == updates
    assert set(tm) == set(runs[0][1])
    for k in tm:
        vals = [float(m[k]) for _, m in runs]
        lo, hi = min(vals), max(vals)
        assert lo - (hi - lo) <= float(tm[k]) <= hi + (hi - lo), (
            name, k, float(tm[k]), vals)
