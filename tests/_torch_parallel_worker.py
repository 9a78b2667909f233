"""One rank of the port's data- and tensor-parallel checks on the CPU over
gloo.

Run by ``tests/test_torch_parallel.py``, ``tests/test_torch_parallel_
train.py`` and ``tests/test_torch_tensor_parallel.py``, one process per
rank:

    python tests/_torch_parallel_worker.py TASK RANK WORLD DIR

The ranks join a gloo group through ``file://DIR/init``, read their inputs
from ``DIR/inputs.pt`` (written by ``spawn``; its ``mesh`` entry, the
``MeshConfig`` fields, defaults to a data axis of the world), run TASK and
write what the test compares to ``DIR/out_RANK.pt`` (read back by
``collect``).  This
module imports no JAX and nothing of the JAX package: the tests hold its
results against the JAX package in their own process.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (  # noqa: E402
    Config,
    MeshConfig,
    Options,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.models.layers import (  # noqa: E402
    Norm,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.collectives import (  # noqa: E402
    all_gather_batch,
    initialize_multihost,
    psum_mean,
    shift_left,
    shift_right,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.distributed_eval import (  # noqa: E402
    sharded_median_filter_3d,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.mesh import (  # noqa: E402
    global_batch_from_local,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (  # noqa: E402
    get_trainer,
)


def raises(exc, fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except exc:
        return True
    return False


def trainer_state(trainer):
    """Parameters, buffers and Adam moments by name (every optimizer's
    state, for the adversarial trainers' groups)."""
    out = {f"model.{k}": v.clone() for k, v in
           trainer.model.state_dict().items()}
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    opts = getattr(trainer.optimizer, "optimizers", {"main": trainer.optimizer})
    for group, opt in opts.items():
        for p, st in opt.state.items():
            for k in ("exp_avg", "exp_avg_sq"):
                out[f"{group}.{names[id(p)]}.{k}"] = st[k].clone()
    return out


def norm_check(ctx, inputs):
    """Train-mode ``Norm`` on this rank's rows under the mesh: output,
    input gradient, weight and bias gradients (this rank's), running
    statistics."""
    x = ctx.shard_batch(inputs["norm_x"]).requires_grad_(True)
    dy = ctx.shard_batch(inputs["norm_dy"])
    norm = Norm(x.shape[1])
    with torch.no_grad():
        norm.weight.copy_(inputs["norm_w"])
        norm.bias.copy_(inputs["norm_b"])
    norm.mesh = ctx
    norm.train()
    y = norm(x)
    (y * dy).sum().backward()
    return {"y": y.detach(), "grad_x": x.grad, "grad_w": norm.weight.grad,
            "grad_b": norm.bias.grad, "running_mean": norm.running_mean,
            "running_var": norm.running_var}


def reconstruct_check(ctx, inputs):
    """``reconstruct_device`` of an uneven batch with MC dropout."""
    cfg = Config.from_json(inputs["ae_config"])
    tr = get_trainer("AE")(cfg, device="cpu", mesh=ctx)
    tr.init_state()
    g = torch.Generator().manual_seed(3)
    out = tr.reconstruct_device(inputs["recon_x"], dropout=True, generator=g)
    return {k: v for k, v in out.items()}


def task_basics(ctx, inputs, world):
    rank = ctx.rank
    out = {
        "psum_mean": psum_mean(ctx, torch.tensor([1.0, 2.0]) * (rank + 1)),
        "gather": all_gather_batch(ctx, torch.full((2, 3), float(rank))),
        "right": shift_right(ctx, torch.full((2,), float(rank))),
        "left": shift_left(ctx, torch.full((2,), float(rank))),
        "median": sharded_median_filter_3d(
            ctx, ctx.shard_batch(inputs["vol"])),
        "data_guard": raises(ValueError, make_mesh,
                             MeshConfig(data=world + 1), ["cpu"] * world),
        "model_guard": raises(ValueError, make_mesh,
                              MeshConfig(data=world, model=2),
                              ["cpu"] * world),
        "halo_guard": raises(ValueError, sharded_median_filter_3d, ctx,
                             torch.zeros((1, 8, 8))),
        "local": global_batch_from_local(
            ctx, {"x": np.full((2, 2), rank, np.float32)})["x"],
    }
    # a second bring-up is benign
    initialize_multihost(f"file://{inputs['init']}", world, rank,
                         backend="gloo")
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(float(rank + 1))
    out["replicated"] = ctx.replicate(lin).weight.detach().clone()
    out["norm"] = norm_check(ctx, inputs)
    out["recon"] = reconstruct_check(ctx, inputs)
    return out


def step_of(name, ctx, inputs):
    """One train step of trainer ``name`` from ``inputs[name]``'s state on
    this rank's rows of the batch; the state after it and the step's
    metrics averaged over the group."""
    spec = inputs[name]
    cfg = Config.from_json(spec["config"])
    tr = get_trainer(cfg.trainer)(cfg, device="cpu", mesh=ctx)
    tr.init_state()
    if "state_dict" in spec:
        tr.model.load_state_dict(spec["state_dict"])
    if "d_iters" in spec:
        tr.d_iters = spec["d_iters"]
    metrics = tr.train_step(ctx.shard_batch({"x": spec["x"]}))
    keys = sorted(metrics)
    means = psum_mean(ctx, torch.stack([metrics[k] for k in keys]))
    return {"metrics": dict(zip(keys, means)), "state": trainer_state(tr)}


def task_train(ctx, inputs, world):
    out = {name: step_of(name, ctx, inputs)
           for name in ("AE", "AAE", "GMVAE", "VAE")}
    # VAE_You: a stack of volumes restored at once, one generator each
    spec = inputs["VAE_You"]
    tr = get_trainer("VAE_You")(Config.from_json(spec["config"]),
                                device="cpu", mesh=ctx)
    tr.init_state()
    gens = [torch.Generator().manual_seed(10 + k)
            for k in range(len(spec["vols"]))]
    out["VAE_You"] = tr.reconstruct_volumes_device(
        spec["vols"], generators=gens,
        counts=spec["counts"])["reconstruction"]
    # the lambda sweep's (lambda, batch) restorations split over the ranks
    out["sweep"] = tr.lambda_sweep_errors(
        spec["sweep_x"], torch.arange(20, dtype=torch.float32) / 10.0,
        spec["sweep_batches"])
    out["evaluate"] = evaluate_run(ctx, inputs)
    return out


def evaluate_run(ctx, inputs):
    """``fit`` of one epoch under the mesh (rank 0 writes the workdir), the
    same epoch with the pool streamed, then ``evaluate()`` of the TEST
    cohort on given weights (rank 0 writes the artifacts)."""
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.synthetic import (
        SYNTH,
        SyntheticOptions,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate import (
        evaluate,
    )

    spec = inputs["evaluate"]
    cfg = Config.from_json(spec["config"])
    tr = get_trainer("AE")(cfg, device="cpu", mesh=ctx,
                           workdir=spec["workdir"])
    tr.fit(SYNTH(SyntheticOptions(**spec["train_ds"])))
    out = {"history": tr.history, "state": trainer_state(tr)}
    # the same epoch with the pool streamed from the host in chunks
    tr = get_trainer("AE")(cfg, Options(streamPool=True,
                                        streamPoolChunkBatches=2),
                           device="cpu", mesh=ctx)
    tr.fit(SYNTH(SyntheticOptions(**spec["train_ds"])))
    out["streamed"] = {"history": tr.history, "state": trainer_state(tr),
                       "streamed": tr.streamed_last_epoch}
    tr = get_trainer("AE")(cfg, device="cpu", mesh=ctx)
    tr.model.load_state_dict(spec["eval_state"])
    opts = Options(**spec["options"])
    opts.paths.sample_dir = spec["sample_dir"]
    res = evaluate(SYNTH(SyntheticOptions(**spec["eval_ds"])), tr, opts,
                   cfg)
    out["metrics"] = {k: res[k] for k in spec["keys"]}
    out["diffs"] = torch.from_numpy(np.asarray(res["diffs"]))
    return out


def whole_state(trainer):
    """``trainer_state`` with whole tensors under tensor parallelism: the
    model's and every optimizer's state gathered over the model group."""
    out = {f"model.{k}": v.clone() for k, v in
           trainer._whole_model_state().items()}
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    for group, opt in trainer._optimizers().items():
        state = trainer._whole_optimizer_state()
        state = state if group == "" else state[group]
        order = [names[id(p)] for g in opt.param_groups for p in g["params"]]
        for i, st in state["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                out[f"{group or 'main'}.{order[i]}.{k}"] = st[k].clone()
    return out


def tp_step(name, ctx, inputs):
    """One train step of trainer ``name`` under the mesh, from the seeded
    init (or ``inputs[name]['state_dict']``): the whole state after it and
    the metrics averaged over the data group."""
    spec = inputs[name]
    cfg = Config.from_json(spec["config"])
    tr = get_trainer(cfg.trainer)(cfg, device="cpu", mesh=ctx,
                                  workdir=spec.get("workdir"))
    tr.init_state()
    if "d_iters" in spec:
        tr.d_iters = spec["d_iters"]
    metrics = tr.train_step(ctx.shard_batch({"x": spec["x"]}))
    keys = sorted(metrics)
    means = psum_mean(ctx, torch.stack([metrics[k] for k in keys]))
    return tr, {"metrics": dict(zip(keys, means)), "state": whole_state(tr)}


def task_tp(ctx, inputs, world):
    """Tensor parallelism: an ``AE`` step (its checkpoint saved), with the
    world-2 mesh also an ``AAE`` batch, a one-process checkpoint restored
    and reconstructed, and ``evaluate()``; the sharded median over the
    data group."""
    tr, out = tp_step("AE", ctx, inputs)
    out = {"AE": out, "layout": (ctx.data_index, ctx.model_index),
           "tp_layers": sorted(
        n for n, m in tr.model.named_modules()
        if getattr(m, "tp", None) is not None),
        "local_shapes": {n: tuple(p.shape)
                         for n, p in tr.model.named_parameters()}}
    tr.save_checkpoint(1)
    out["median"] = sharded_median_filter_3d(
        ctx, ctx.shard_batch(inputs["vol"]))
    if "AAE" not in inputs:
        return out
    out["AAE"] = tp_step("AAE", ctx, inputs)[1]
    spec = inputs["restore"]
    tr = get_trainer("AE")(Config.from_json(spec["config"]), device="cpu",
                           mesh=ctx, workdir=spec["workdir"])
    out["restored_epoch"] = tr.restore_training_checkpoint()
    out["restored"] = whole_state(tr)
    out["recon"] = tr.reconstruct_device(spec["x"])["reconstruction"]
    out["evaluate"] = tp_evaluate(ctx, inputs)
    return out


def tp_evaluate(ctx, inputs):
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.synthetic import (
        SYNTH,
        SyntheticOptions,
    )
    from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate import (
        evaluate,
    )

    spec = inputs["evaluate"]
    cfg = Config.from_json(spec["config"])
    tr = get_trainer("AE")(cfg, device="cpu", mesh=ctx)
    tr._load_model_state(spec["eval_state"])
    opts = Options(**spec["options"])
    opts.paths.sample_dir = spec["sample_dir"]
    res = evaluate(SYNTH(SyntheticOptions(**spec["eval_ds"])), tr, opts,
                   cfg)
    return {"metrics": {k: res[k] for k in spec["keys"]},
            "diffs": torch.from_numpy(np.asarray(res["diffs"]))}


TASKS = {"basics": task_basics, "train": task_train, "tp": task_tp}


def spawn(task, world, workdir, inputs, port=None):
    """Start the ``world`` ranks of ``task`` on ``inputs`` (a dict that
    ``torch.save`` takes) in ``workdir``; returns the processes.  With
    ``port`` the ranks get ``torchrun``'s environment (coordinator
    ``127.0.0.1:port``) instead of joining through ``file://``."""
    torch.save(inputs, os.path.join(str(workdir), "inputs.pt"))
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1")
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT"):
            env.pop(k, None)
        if port is not None:
            env.update(RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
        log = open(os.path.join(str(workdir), f"log_{rank}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), task, str(rank),
             str(world), str(workdir)], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def collect(procs, workdir, timeout=240):
    """Wait for the ranks and return their outputs in rank order; a rank
    that fails or outlives ``timeout`` seconds fails the caller with its
    log."""
    try:
        codes = [p.wait(timeout=timeout) for p, _ in procs]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for rank, code in enumerate(codes):
        if code != 0:
            with open(os.path.join(str(workdir), f"log_{rank}.txt")) as f:
                raise RuntimeError(f"rank {rank} exited with {code}:\n"
                                   + f.read()[-4000:])
    return [torch.load(os.path.join(str(workdir), f"out_{rank}.pt"),
                       weights_only=False) for rank in range(len(procs))]


def main():
    task, rank, world, workdir = (sys.argv[1], int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    if task == "cli":
        # the CLI joins the group from torchrun's environment itself
        from unsupervised_anomaly_detection_brain_mri_tpu_torch import cli

        rc = cli.main(inputs["argv"])
        torch.save({"rc": rc}, os.path.join(workdir, f"out_{rank}.pt"))
        return
    inputs["init"] = os.path.join(workdir, "init")
    initialize_multihost(f"file://{inputs['init']}", world, rank,
                         backend="gloo", timeout_s=120)
    ctx = make_mesh(MeshConfig(**inputs.get("mesh", {"data": world})),
                    devices=["cpu"] * world)
    out = TASKS[task](ctx, inputs, world)
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    ctx.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
