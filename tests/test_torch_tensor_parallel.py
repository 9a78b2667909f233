"""The port's tensor parallelism on the CPU over gloo, against one process.

Float32, 32x32, batch 8, the configs of ``tests/test_torch_parallel_
train.py``.  Ranks of ``_torch_parallel_worker.py`` (task ``tp``) run a
``(data, model)`` mesh: world 2 as dp1 x tp2 and world 4 as dp2 x tp2.
Each takes one ``AE`` step from the seeded init (the wide layers column
parallel: each rank holds its model index's rows of their weights and
Adam moments) and saves its checkpoint, and computes the sharded median
over its data group.  At world 2 they also take one ``AAE`` batch (its
three Adam groups over the shards), restore a one-process checkpoint and
reconstruct from it, and run ``evaluate()``.  This process computes the
same in one process while they run.  The bounds are the data-parallel
ones (``_assert_step_states``), since a sharded layer adds its bias after
the gather and sums its input gradient over the model group in another
order.
"""

import numpy as np
import pytest
import torch
from torch import nn

import _torch_parallel_worker as worker
from test_torch_parallel_train import (
    AAE_D_ITERS,
    CONFIGS,
    EVAL_DS,
    EVAL_KEYS,
    METRIC_RTOL,
    _assert_step_states,
    _batch,
    _eval_state,
    _options,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
    Options,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.synthetic import (
    SYNTH,
    SyntheticOptions,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate import (
    evaluate,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models import layers
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops.median import (
    median_filter_3d,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.mesh import (
    MeshContext,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.sharding import (
    shard_like_params,
    shard_model,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)

TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = {"dp1xtp2": (2, {"data": 1, "model": 2}),
          "dp2xtp2": (4, {"data": 2, "model": 2})}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vol():
    return torch.from_numpy(np.random.default_rng(7).uniform(
        size=(12, 16, 16)).astype(np.float32))


def _one_process(name, x, workdir=None):
    tr = get_trainer(CONFIGS[name].trainer)(CONFIGS[name], device="cpu",
                                            workdir=workdir)
    tr.init_state()
    if name == "AAE":
        tr.d_iters = AAE_D_ITERS
    metrics = tr.train_step({"x": x})
    return tr, {"metrics": metrics, "state": worker.trainer_state(tr)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both meshes' ranks, and this process's references computed while
    they run."""
    d = tmp_path_factory.mktemp("tp")
    x = _batch(0)
    common = {"AE": {"config": CONFIGS["AE"].to_json(), "x": x},
              "vol": _vol()}
    procs = {}
    for key, (world, mesh) in MESHES.items():
        inputs = {**common, "mesh": mesh,
                  "AE": {**common["AE"], "workdir": str(d / f"{key}_wd")}}
        if key == "dp1xtp2":
            # a one-process checkpoint for the ranks to restore
            tr, _ = _one_process("AE", _batch(2), str(d / "one_wd"))
            tr.save_checkpoint(1)
            inputs.update({
                "AAE": {"config": CONFIGS["AAE"].to_json(), "x": _batch(1),
                        "d_iters": AAE_D_ITERS},
                "restore": {"config": CONFIGS["AE"].to_json(),
                            "workdir": str(d / "one_wd"), "x": _batch(3)[:5]},
                "evaluate": {"config": CONFIGS["AE"].to_json(),
                             "eval_state": _eval_state(), "eval_ds": EVAL_DS,
                             "options": _options(),
                             "sample_dir": str(d / "samples"),
                             "keys": EVAL_KEYS}})
        (d / key).mkdir()
        procs[key] = (d / key, worker.spawn("tp", world, d / key, inputs))
    try:
        refs = {"AE": _one_process("AE", x)[1],
                "AAE": _one_process("AAE", _batch(1))[1]}
        tr = get_trainer("AE")(CONFIGS["AE"], device="cpu",
                               workdir=str(d / "one_wd"))
        tr.restore_training_checkpoint()
        refs["restored"] = worker.trainer_state(tr)
        refs["recon"] = tr.reconstruct_device(_batch(3)[:5])[
            "reconstruction"]
        tr = get_trainer("AE")(CONFIGS["AE"], device="cpu")
        tr.model.load_state_dict(_eval_state())
        opts = Options(**_options())
        opts.paths.sample_dir = str(d / "samples1")
        refs["evaluate"] = evaluate(SYNTH(SyntheticOptions(**EVAL_DS)), tr,
                                    opts, CONFIGS["AE"])
    finally:
        outs = {key: worker.collect(p, wd) for key, (wd, p) in procs.items()}
    return d, outs, refs


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ae_step_equals_one_process(runs, mesh):
    """Every rank's whole state after the step (gathered over its model
    group) is the same, and equals one process's within the data-parallel
    bounds; the metrics (the data group's mean) within 1e-5.  Rank r sits
    at data index r // 2, model index r % 2, and the layers whose
    out-channel count is even hold half of it."""
    _, outs, refs = runs
    outs = outs[mesh]
    assert [o["layout"] for o in outs] == [(r // 2, r % 2)
                                           for r in range(len(outs))]
    ref = refs["AE"]
    for out in outs:
        for k, v in outs[0]["AE"]["state"].items():
            assert torch.equal(out["AE"]["state"][k], v), k
    out = outs[0]["AE"]
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(float(out["metrics"][k]), float(v),
                                   rtol=METRIC_RTOL["AE"], err_msg=k)
    _assert_step_states(out["state"], ref["state"], "AE", f"AE {mesh}")
    layers_tp = outs[0]["tp_layers"]
    assert "encoder.enc_conv_0" in layers_tp
    assert "decoder.dec_convT_0" in layers_tp
    assert "decoder.dec_conv_final" not in layers_tp  # one output channel
    shapes = outs[0]["local_shapes"]
    assert shapes["encoder.enc_conv_0.weight"] == (16, 1, 5, 5)
    assert shapes["decoder.dec_convT_0.weight"][1] == 64
    assert shapes["decoder.dec_conv_final.weight"] == (1, 64, 1, 1)


def test_aae_batch_equals_one_process(runs):
    """One ``AAE`` batch under dp1 x tp2 (2 AE, 2 critic and 1 generator
    updates, each group's Adam over its shards; the critic's gradient
    penalty differentiates through the layers' collectives twice): the
    metrics within 1e-4 and the whole state within the data-parallel bounds."""
    _, outs, refs = runs
    out, ref = outs["dp1xtp2"][0]["AAE"], refs["AAE"]
    assert set(out["metrics"]) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(float(out["metrics"][k]), float(v),
                                   rtol=METRIC_RTOL["AAE"], err_msg=k)
    _assert_step_states(out["state"], ref["state"], "AAE", "AAE dp1xtp2")


def test_tensor_parallel_checkpoint_loads_in_one_process(runs):
    """The writer saved whole tensors: one process restores the dp1 x tp2
    checkpoint (model, Adam moments, step) bit-equal to the ranks' gathered
    state, and its weights for serving too."""
    d, outs, _ = runs
    for mesh in MESHES:
        tr = get_trainer("AE")(CONFIGS["AE"], device="cpu",
                               workdir=str(d / f"{mesh}_wd"))
        assert tr.restore_training_checkpoint() == 1
        got = worker.trainer_state(tr)
        want = outs[mesh][0]["AE"]["state"]
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
        serving = get_trainer("AE")(CONFIGS["AE"], device="cpu",
                                    workdir=str(d / f"{mesh}_wd"))
        serving.load_checkpoint()
        for k, v in serving.model.state_dict().items():
            assert torch.equal(v, want[f"model.{k}"]), k


def test_one_process_checkpoint_loads_under_tensor_parallelism(runs):
    """A one-process checkpoint restored under dp1 x tp2 gathers back to
    the one-process state bit for bit, and the ranks' reconstruction from
    it equals one process's within 1e-5."""
    _, outs, refs = runs
    for out in outs["dp1xtp2"]:
        assert out["restored_epoch"] == 1
        for k, v in refs["restored"].items():
            assert torch.equal(out["restored"][k], v), k
        np.testing.assert_allclose(out["recon"].numpy(),
                                   refs["recon"].numpy(), **TOL)


def test_evaluate_under_tensor_parallelism_equals_one_process(runs):
    """``evaluate()`` of the lesioned cohort under dp1 x tp2 (one median
    per volume on every rank): every metric within rtol 1e-5 and the
    residuals within 1e-5 of one process's."""
    _, outs, refs = runs
    for out in outs["dp1xtp2"]:
        for k in EVAL_KEYS:
            np.testing.assert_allclose(out["evaluate"]["metrics"][k],
                                       refs["evaluate"][k], rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(out["evaluate"]["diffs"].numpy(),
                                   refs["evaluate"]["diffs"], atol=1e-5)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_median_over_the_data_group(runs, mesh):
    """Each rank's shard of the sharded median, by its data index, is the
    whole volume's median's rows bit for bit (the ranks of a model group
    hold the same shard)."""
    _, outs, _ = runs
    want = median_filter_3d(_vol())
    n_data = MESHES[mesh][1]["data"]
    per = want.shape[0] // n_data
    for out in outs[mesh]:
        d = out["layout"][0]
        assert torch.equal(out["median"], want[d * per:(d + 1) * per])


def test_shard_like_params_leaves_a_wrong_shape_replicated():
    """A moment shaped like its sharded parameter's whole tensor is cut to
    the rank's rows; one of another shape (a factored moment) and the
    step stay as they are (JAX ``tests/test_parallel.py``'s
    ``test_shard_like_params_requires_shape_match``)."""
    ctx = MeshContext(rank=1, n_data=1, device=torch.device("cpu"),
                      n_model=2, data_index=0, model_index=1)
    model = nn.Sequential(layers.Linear(8, 16), layers.Linear(16, 1))
    shard_model(model, ctx)
    assert tuple(model[0].weight.shape) == (8, 8)
    assert model[1].tp is None  # one output: replicated
    opt = torch.optim.Adam(model.parameters())
    whole = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    state = {"state": {0: {"step": torch.tensor(3.0), "exp_avg": whole,
                           "exp_avg_sq": torch.ones(16)}},
             "param_groups": opt.state_dict()["param_groups"]}
    cut = shard_like_params(ctx, model, opt, state)
    assert torch.equal(cut["state"][0]["exp_avg"], whole[8:])
    assert torch.equal(cut["state"][0]["exp_avg_sq"], torch.ones(16))
    assert torch.equal(cut["state"][0]["step"], torch.tensor(3.0))
    assert state["state"][0]["exp_avg"] is whole  # the input is untouched
