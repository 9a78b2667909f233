"""The port's parallel layer on the CPU: the mesh, its collectives, the
halo-exchange median, global BatchNorm statistics and sharded
reconstruction at world sizes 2 and 4 over gloo (one process per rank,
``_torch_parallel_worker.py``, task ``basics``), against numpy, one process
and the JAX package; and in this process ``pad_batch_to``, ``make_mesh``'s
and ``initialize_multihost``'s guards, and the CLI at ``--mesh-data 1``."""

import ast
import json
import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_parallel_worker as worker
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    MeshConfig as JaxMeshConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu.parallel import (
    mesh as jax_mesh,
)
from unsupervised_anomaly_detection_brain_mri_tpu.parallel.distributed_eval import (
    sharded_median_filter_3d as jax_sharded_median,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
    Config,
    MeshConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (
    Norm,
    ShardedSource,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops.median import (
    median_filter_3d,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel import (
    make_mesh,
    mesh,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.collectives import (
    initialize_multihost,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AE = Config(trainer="AE", model="autoencoder", batchsize=8, outputWidth=32,
            outputHeight=32, zDim=16, compute_dtype="float32")
VOLUME = (16, 12, 12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return {"vol": f32(rng.uniform(size=VOLUME)),
            # a large mean against the spread: the variance must not cancel
            "norm_x": f32(rng.normal(size=(8, 3, 5, 5)) + 2.0),
            "norm_dy": f32(rng.normal(size=(8, 3, 5, 5))),
            "norm_w": torch.tensor([0.5, 1.5, -1.0]),
            "norm_b": torch.tensor([0.1, 0.0, -0.2]),
            "ae_config": AE.to_json(),
            "recon_x": f32(rng.uniform(size=(5, 32, 32, 1)))}


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def basics(request, tmp_path_factory):
    """The ranks' outputs at this world size, and the inputs."""
    world = request.param
    d = tmp_path_factory.mktemp(f"basics{world}")
    inputs = _inputs()
    return world, inputs, worker.collect(worker.spawn("basics", world, d,
                                                      inputs), d)


def test_collectives_match_numpy(basics):
    """``psum_mean``, ``all_gather_batch`` (tiled along axis 0) and the
    ring shifts, as the JAX package's ``psum``/``all_gather``/``ppermute``
    helpers: rank r holds (r + 1) * [1, 2], r x ones((2, 3)) and r."""
    world, _, outs = basics
    mean = np.mean([np.array([1.0, 2.0]) * (r + 1) for r in range(world)], 0)
    gathered = np.repeat(np.arange(world, dtype=np.float32), 2)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["psum_mean"].numpy(), mean, rtol=1e-6)
        np.testing.assert_array_equal(out["gather"].numpy(),
                                      np.repeat(gathered[:, None], 3, 1))
        np.testing.assert_array_equal(out["right"].numpy(),
                                      np.full(2, (r - 1) % world))
        np.testing.assert_array_equal(out["left"].numpy(),
                                      np.full(2, (r + 1) % world))
        np.testing.assert_array_equal(out["local"].numpy(), np.full((2, 2),
                                                                     r))
        np.testing.assert_array_equal(out["replicated"].numpy(),
                                      np.ones((2, 3)))


def test_guards_raise_on_every_rank(basics):
    """``make_mesh`` refuses data != world size and data x model !=
    world size; the sharded median refuses a shard of fewer slices than
    its halo."""
    for out in basics[2]:
        assert out["data_guard"] and out["model_guard"] and out["halo_guard"]


def test_sharded_median_is_bit_equal_to_the_whole_volume(basics):
    """The shards of ``sharded_median_filter_3d``, in rank order, equal the
    whole volume's median bit for bit, and the JAX package's sharded
    median on as many devices."""
    world, inputs, outs = basics
    got = torch.cat([out["median"] for out in outs])
    assert torch.equal(got, median_filter_3d(inputs["vol"]))
    ctx = jax_mesh.make_mesh(JaxMeshConfig(data=world, model=1),
                             jax.devices()[:world])
    # jitted: eager shard_map dispatches the 125 window slices one by one
    ref = np.asarray(jax.jit(lambda v: jax_sharded_median(ctx, v))(
        jnp.asarray(inputs["vol"].numpy())))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_norm_uses_global_batch_statistics(basics):
    """Train-mode ``Norm`` on each rank's rows under the mesh against one
    process on the whole batch: output and input gradient (rows in rank
    order), weight and bias gradients (summed over the ranks, as the
    trainers' gradient mean completes them), and the running mean and
    biased variance on every rank, within 1e-5."""
    _, inputs, outs = basics
    norm = Norm(3)
    with torch.no_grad():
        norm.weight.copy_(inputs["norm_w"])
        norm.bias.copy_(inputs["norm_b"])
    x = inputs["norm_x"].clone().requires_grad_(True)
    y = norm(x)
    (y * inputs["norm_dy"]).sum().backward()
    runs = [out["norm"] for out in outs]
    for key, want in (("y", y.detach()), ("grad_x", x.grad)):
        np.testing.assert_allclose(torch.cat([r[key] for r in runs]).numpy(),
                                   want.numpy(), err_msg=key, **TOL)
    for key, want in (("grad_w", norm.weight.grad),
                      ("grad_b", norm.bias.grad)):
        np.testing.assert_allclose(sum(r[key] for r in runs).numpy(),
                                   want.numpy(), err_msg=key, **TOL)
    for r in runs:
        for key in ("running_mean", "running_var"):
            np.testing.assert_allclose(r[key].numpy(),
                                       getattr(norm, key).numpy(),
                                       err_msg=key, **TOL)


def test_reconstruct_uneven_batch_equals_one_process(basics):
    """``reconstruct_device`` of 5 slices with MC dropout: padded to a
    multiple of the ranks, each rank's rows with its share of the dropout
    masks, gathered and cropped; every output on every rank equals one
    process's."""
    _, inputs, outs = basics
    tr = get_trainer("AE")(AE, device="cpu")
    tr.init_state()
    ref = tr.reconstruct_device(inputs["recon_x"], dropout=True,
                                generator=torch.Generator().manual_seed(3))
    for out in outs:
        assert set(out["recon"]) == set(ref)
        for k, v in ref.items():
            assert out["recon"][k].shape == v.shape, k
            np.testing.assert_allclose(out["recon"][k].numpy(), v.numpy(),
                                       err_msg=k, **TOL)


# ---------------------------------------------------------------------------
# in this process


@pytest.mark.parametrize("rows,multiple", [(10, 8), (3, 8), (8, 4), (5, 2)])
def test_pad_batch_to_equals_jax(rows, multiple):
    """The copy's output equals the JAX package's, a pad longer than the
    batch (3 rows on 8) included."""
    b = np.arange(rows * 2, dtype=np.float32).reshape(rows, 2)
    got = mesh.pad_batch_to(b, multiple)
    np.testing.assert_array_equal(got, jax_mesh.pad_batch_to(b, multiple))
    assert got.shape[0] % multiple == 0


def test_pad_batch_to_source_equals_jax():
    """The function is a copy: its code, docstring aside, is the JAX
    package's."""
    def code(module):
        with open(module.__file__) as f:
            tree = ast.parse(f.read())
        fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                  and n.name == "pad_batch_to")
        fn.body = fn.body[1:]  # the docstring
        return ast.dump(fn)

    assert code(mesh) == code(jax_mesh)


def test_sharded_source_draws_the_ranks_rows_of_the_whole_batch():
    """A rank's share of a generator: a batch-leading draw is the rows of
    the one-process draw of the whole batch (padding rows zero) and
    advances the generator as that draw does; a scalar draw is the
    one-process draw; a draw led by any other size raises."""
    def gen():
        return torch.Generator().manual_seed(3)

    whole = torch.randn((5, 4), generator=gen())
    for start, stop in ((0, 3), (3, 6)):
        g = gen()
        got = ShardedSource(g, 5, start, stop).draw(torch.randn, (3, 4),
                                                    torch.device("cpu"))
        want = torch.cat([whole, whole.new_zeros(1, 4)])[start:stop]
        assert torch.equal(got, want)
        ref = gen()
        torch.randn((5, 4), generator=ref)
        assert torch.equal(torch.rand((), generator=g),
                           torch.rand((), generator=ref))
    scalar = ShardedSource(gen(), 5, 0, 3).draw(torch.rand, (),
                                                 torch.device("cpu"))
    assert torch.equal(scalar, torch.rand((), generator=gen()))
    for shape in ((5, 4), (2,), (6, 1)):
        with pytest.raises(ValueError, match="leads with the rank's rows"):
            ShardedSource(gen(), 5, 0, 3).draw(torch.randn, shape,
                                               torch.device("cpu"))


def test_make_mesh_guards_in_one_process():
    """Without a process group the world is this process: data=1 (or
    None) is a one-rank mesh that issues no collective; data=2 raises;
    model=2 raises, since data x model must be the world size (tensor
    parallelism is ported: ``tests/test_torch_tensor_parallel.py``); the
    default devices need a card."""
    ctx = make_mesh(MeshConfig(data=1), devices=["cpu"])
    assert (ctx.n_data, ctx.n_model, ctx.rank, ctx.parallel) == (1, 1, 0,
                                                                 False)
    assert make_mesh(MeshConfig(), devices=["cpu"]).n_data == 1
    with pytest.raises(ValueError, match="process group has 1"):
        make_mesh(MeshConfig(data=2), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="model=2"):
        make_mesh(MeshConfig(data=1, model=2), devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(MeshConfig(data=1))


def test_one_rank_mesh_trains_as_one_process():
    """A trainer on a one-rank mesh takes the one-process path: the same
    step, bit for bit."""
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(8, 32, 32, 1)).astype(np.float32))
    states = []
    for ctx in (None, make_mesh(MeshConfig(data=1), devices=["cpu"])):
        tr = get_trainer("AE")(AE, device="cpu", mesh=ctx)
        tr.init_state()
        tr.train_step({"x": x})
        states.append(tr.model.state_dict())
    for k, v in states[0].items():
        assert torch.equal(states[1][k], v), k


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_multihost_no_ops(capsys, monkeypatch):
    """One process is a no-op; so is the argless call without torchrun's
    environment, which says so in one line."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    initialize_multihost(num_processes=1)
    initialize_multihost(backend="gloo")
    assert not dist.is_initialized()
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and "single-process run" in out[0]


def test_initialize_multihost_unreachable_coordinator_raises():
    """Rank 1 of 2 with a coordinator that nobody serves raises within its
    timeout (plus the store's retry) instead of running alone; so does
    rank 0, whose peer never comes."""
    timeout = 2.0
    for rank in (1, 0):
        t0 = time.perf_counter()
        with pytest.raises(Exception):
            initialize_multihost(f"127.0.0.1:{_free_port()}", 2, rank,
                                 backend="gloo", timeout_s=timeout)
        assert time.perf_counter() - t0 < timeout + 15
        assert not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator_address"):
        initialize_multihost(num_processes=2, backend="gloo")


@pytest.fixture(scope="module")
def cli_rows(tmp_path_factory):
    """``--preset AE --synthetic --device cpu`` at 32x32, 1 epoch, without
    a mesh and with ``--mesh-data 1``: the ``--metrics-out`` rows."""
    rows = {}
    for name, extra in (("plain", []), ("mesh1", ["--mesh-data", "1"])):
        root = tmp_path_factory.mktemp(name)
        paths = root / "paths.json"
        paths.write_text(json.dumps({"SAMPLEDIR": str(root / "samples")}))
        metrics = root / "metrics.jsonl"
        assert cli.main(["--preset", "AE", "--synthetic", "-w", "32", "-g",
                         "32", "-z", "16", "-b", "8", "-s", "0", "-e", "12",
                         "-E", "1", "--precision", "float32", "--device",
                         "cpu", "--workdir", str(root / "wd"),
                         "--metrics-out", str(metrics), "-c", str(paths),
                         *extra]) == 0
        rows[name] = [json.loads(ln) for ln in
                      metrics.read_text().splitlines()]
    return rows


def test_cli_mesh_data_2_trains_evaluates_and_calibrates(cli_rows,
                                                        tmp_path):
    """``--mesh-data 2`` through the CLI in two processes with torchrun's
    environment, over gloo on the CPU: both ranks finish; rank 0 alone
    writes the workdir, the artifacts, ``calibration.json`` and
    ``--metrics-out``, whose rows are those of one process: the same
    evaluations, the final train loss within the free-running tolerance of
    float32 trajectories (1e-3), and AUROC and AUPRC, computed from weights
    that drifted that far, within 1e-2.  (On the same weights the
    evaluation itself agrees within 1e-5:
    ``test_torch_parallel_train.py``.)"""
    paths = tmp_path / "paths.json"
    paths.write_text(json.dumps({"SAMPLEDIR": str(tmp_path / "samples")}))
    metrics = tmp_path / "metrics.jsonl"
    argv = ["--preset", "AE", "--synthetic", "-w", "32", "-g", "32", "-z",
            "16", "-b", "8", "-s", "0", "-e", "12", "-E", "1",
            "--precision", "float32", "--device", "cpu", "--workdir",
            str(tmp_path / "wd"), "--metrics-out", str(metrics), "-c",
            str(paths), "--mesh-data", "2"]
    outs = worker.collect(worker.spawn("cli", 2, tmp_path, {"argv": argv},
                                       port=_free_port()), tmp_path)
    assert [o["rc"] for o in outs] == [0, 0]
    assert (tmp_path / "wd" / "calibration.json").is_file()
    found = [p for p, _, names in os.walk(tmp_path / "samples")
             if "evalPC.json" in names]
    assert len(found) == 3

    def kind(row):  # the description without the transferred threshold
        return row["description"].split("-VALthresh_")[0]

    rows = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    assert [kind(r) for r in rows] == [kind(r) for r in cli_rows["plain"]]
    for got, want in zip(rows, cli_rows["plain"]):
        for k, rtol in (("finalTrainLoss", 1e-3), ("AUROC", 1e-2),
                        ("AUPRC", 1e-2)):
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       err_msg=k)


def test_cli_mesh_data_1_equals_no_mesh(cli_rows):
    """A one-rank mesh through the CLI gives the same ``--metrics-out``
    as no mesh: the same rows, number for number."""
    assert len(cli_rows["plain"]) == 3
    assert cli_rows["mesh1"] == cli_rows["plain"]
