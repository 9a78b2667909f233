"""The port's measurement layer on the CPU: ``utils/misc.py::device_peaks``
against the JAX table, the FLOP and byte counters of ``bench_torch.py``
(the AE train step's FLOPs and each roofline stage's against XLA's cost
analysis of the JAX package's programs), ``bench_torch.main`` end to end
at a small size, its failure path, and both roofline tools' JSON.

The counters count what ``torch.utils.flop_counter`` has formulas for
(convolutions and matrix products, forward and backward); XLA's cost
analysis counts elementwise and normalisation arithmetic too.  The whole
AE step (bf16 compute, both packages' default) is held within 5 % (its
ratio is 0.97-0.98 at the sizes below); a single stage within 15 %, since
there the elementwise share is larger (0.90-1.14 at batch 2, 32x32).
Times on the CPU are the host's and are not checked.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    Config as JaxConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu.models import (
    layers as jax_layers,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    get_trainer as jax_get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu.utils.misc import (
    device_peaks as jax_device_peaks,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import Config
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils.misc import (
    device_peaks,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SMALL = ["--device", "cpu", "--batch", "4", "--image", "32", "--slices",
         "8", "--depth", "4", "--restore-steps", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(rel):
    """A script of ``tools/`` as a module."""
    name = "tool_" + os.path.basename(rel)[:-3]
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# device_peaks


@pytest.mark.parametrize("kind", ["TPU v5 lite", "tpu v4", "cpu"])
def test_device_peaks_keeps_the_jax_rows(kind):
    assert device_peaks(kind) == jax_device_peaks(kind)


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3",
                                  "nvidia h100 sxm5 80gb"])
def test_device_peaks_h100_sxm(kind):
    """bf16 dense and HBM3 of NVIDIA's H100 SXM data sheet (700 W)."""
    assert device_peaks(kind) == (989e12, 3.35e12)


def test_device_peaks_h100_pcie_is_not_the_sxm_row():
    assert device_peaks("NVIDIA H100 PCIe") == (756e12, 2.0e12)
    # another H100 form gets the placeholder, never the SXM peaks
    assert device_peaks("NVIDIA H100 NVL") == device_peaks("cpu")


# ---------------------------------------------------------------------------
# counters


def test_count_flops_of_a_matmul_and_its_backward():
    a = torch.ones(3, 5, requires_grad=True)
    b = torch.ones(5, 7)
    assert bench_torch.count_flops(torch.mm, a, b) == 2 * 3 * 5 * 7

    def fwd_bwd():
        (a @ b).sum().backward()

    # forward, and the backward's product for a's gradient only
    assert bench_torch.count_flops(fwd_bwd) == 2 * (2 * 3 * 5 * 7)


def test_count_bytes_reads_inputs_writes_outputs_and_skips_views():
    x = torch.ones(64, 32)
    y = torch.ones(64, 32)
    assert bench_torch.count_bytes(torch.add, x, y) == 3 * x.numel() * 4
    assert bench_torch.count_bytes(lambda: x.view(-1).t()) == 0
    assert bench_torch.count_bytes(lambda: x.to(torch.bfloat16)) == (
        x.numel() * (4 + 2))


@pytest.mark.parametrize("batch,size,z", [(4, 32, 16), (2, 32, 128)])
def test_ae_step_flops_match_xla_cost_analysis(batch, size, z):
    """One AE train step: the port's counter against XLA's flops of the
    JAX package's jitted train step (bf16 compute in both), within 5 %."""
    cfg = Config(trainer="AE", model="autoencoder", batchsize=batch,
                 outputWidth=size, outputHeight=size, zDim=z,
                 intermediateResolutions=(8, 8))
    x = np.random.default_rng(0).uniform(
        size=(batch, size, size, 1)).astype(np.float32)
    jt = jax_get_trainer("AE")(JaxConfig.from_json(cfg.to_json()))
    compiled = jax.jit(jt._build_train_step()).lower(
        jt.init_state(), {"x": jnp.asarray(x)}).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    tt = get_trainer("AE")(cfg, device="cpu")
    tt.init_state()
    ours = bench_torch.count_flops(tt.train_step, {"x": torch.from_numpy(x)})
    assert ours > 0
    assert ca["flops"] / ours == pytest.approx(1.0, abs=0.05)


@pytest.mark.parametrize("fast", [False, True], ids=["parity", "fast"])
def test_stage_flops_match_the_jax_tool(fast):
    """The four stages of each profile (the same modules as the JAX tool's,
    at batch 2, 32x32): the port's counted FLOPs of each forward+backward
    against XLA's of the JAX tool's gradient program, within 15 %."""
    J = _load(os.path.join("tools", "parity_stage_roofline.py"))
    T = _load(os.path.join("tools", "parity_stage_roofline_torch.py"))
    B, H, inter = 2, 32, 8
    rng = np.random.default_rng(0)
    x_img = jnp.asarray(rng.uniform(size=(B, H, H, 1)).astype(np.float32))
    h_lat = jnp.asarray(rng.uniform(size=(B, inter, inter, 128)).astype(
        np.float32))
    x_half = jnp.asarray(rng.uniform(size=(B, H // 2, H // 2, 32)).astype(
        np.float32))
    bf16 = jnp.bfloat16
    jax_stages = [
        (jax_layers.UnifiedEncoder(H, inter, space_to_depth_stem=fast,
                                   dtype=bf16), x_img, {"train": True}),
        (jax_layers.DenseBottleneck(128, 0.2, dtype=bf16), h_lat,
         {"dropout": False}),
        (jax_layers.UnifiedDecoder(H, 1, inter, depth_to_space_head=fast,
                                   fast_convt_grad=fast, dtype=bf16),
         h_lat, {"train": True}),
        (J.D2SHeadStage() if fast else J.DecoderLastStage(), x_half,
         {"train": True}),
    ]
    ours = T.stages(B, H, fast, CPU)
    assert len(ours) == len(jax_stages) == 4
    for (name, module, x, _), (jm, jx, kw) in zip(ours, jax_stages):
        _, single, _ = J._stage_program(jm, jx, kw)
        xla_flops, _ = J._cost(single, jx)
        counted = bench_torch.count_flops(T._fwd_bwd, module, x)
        assert xla_flops / counted == pytest.approx(1.0, abs=0.15), name


def test_stage_inputs_have_the_layout_the_model_gives_its_layers():
    """The port's models permute NHWC slices, so their layers see
    channels-last tensors (and cuDNN runs its channels-last kernels); the
    tool's stage inputs must too, or a stage times NCHW kernels the step
    never runs."""
    T = _load(os.path.join("tools", "parity_stage_roofline_torch.py"))
    cfg = Config(trainer="AE", model="autoencoder", batchsize=2,
                 outputWidth=32, outputHeight=32, compute_dtype="float32")
    model = get_trainer("AE")(cfg, device="cpu").model
    x = torch.rand(2, 32, 32, 1)
    with torch.no_grad():
        h = model.encoder(x.permute(0, 3, 1, 2))
    cl = torch.channels_last
    assert h.is_contiguous(memory_format=cl)
    for name, _, inp, _ in T.stages(2, 32, False, CPU):
        assert inp.is_contiguous(memory_format=cl), name


# ---------------------------------------------------------------------------
# bench_torch.main


def test_bench_runs_every_section_and_prints_the_contract(capsys):
    assert bench_torch.main(SMALL) == 0
    out = _last_json(capsys)
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert out["metric"] == "brainweb_ae_train_throughput"
    assert out["unit"] == "slices/sec/chip"
    assert out["value"] > 0 and out["vs_baseline"] > 0
    d = out["detail"]
    assert "error" not in d
    assert list(d["section_secs"]) == ["startup"] + [
        f.__name__ for f in bench_torch.SECTIONS]
    for key in bench_torch.ROW_KEYS:
        assert d[key] is not None and np.isfinite(d[key]), key
    assert d["device_kind"] == "cpu" and d["nvidia_smi"] is None
    assert "no device metric" in d["timing"]
    # the CPU tensor takes the plain median: equal, and no kernel launch
    assert d["median5_equals_plain"] is True and d["median5_launches"] == 0
    # the AAE's update counts come from the trainer's schedule
    assert (d["aae_updates_per_batch"], d["aae_updates_per_batch_steady"]) \
        == (20 + 20 + 1, 1 + 20 + 1)
    for key in ("torch", "cuda", "cudnn_allow_tf32", "matmul_allow_tf32",
                "mfu_flop_model"):
        assert key in d


def test_a_section_that_raises_exits_1_with_what_was_measured(
        capsys, monkeypatch):
    def broken(run):
        raise ValueError("broken section")

    monkeypatch.setattr(bench_torch, "SECTIONS",
                        (bench_torch.ae_headline, broken))
    assert bench_torch.main(SMALL) == 1
    out = _last_json(capsys)
    assert out["value"] > 0 and out["vs_baseline"] is None
    assert out["detail"]["native_ae_slices_per_sec"] == out["value"]
    assert out["detail"]["error"].startswith("section broken failed: "
                                             "ValueError: broken section")


def test_the_watchdog_prints_the_line_and_exits_1():
    """A run over its budget: the headline line with the section in flight
    named in ``detail["error"]``, and exit code 1."""
    env = dict(os.environ, UADMRI_BENCH_WATCHDOG_SECS="0.5",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "bench_torch.py", *SMALL],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 1, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["metric"] == "brainweb_ae_train_throughput"
    assert out["detail"]["error"].startswith(
        "watchdog: the 0.5 s budget ran out during [")


@pytest.mark.parametrize("script", ["bench_torch.py",
                                    "tools/hbm_roofline_torch.py",
                                    "tools/parity_stage_roofline_torch.py"])
def test_a_cuda_device_without_cuda_raises(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = bench_torch.main if script == "bench_torch.py" \
        else _load(script).main
    with pytest.raises(RuntimeError, match="cuda"):
        main([])


# ---------------------------------------------------------------------------
# the roofline tools


@pytest.mark.parametrize("fast", [False, True], ids=["parity", "fast"])
def test_stage_roofline_json(fast, capsys):
    T = _load(os.path.join("tools", "parity_stage_roofline_torch.py"))
    argv = ["--device", "cpu", "--batch", "2", "--image", "32"]
    assert T.main(argv + (["--fast"] if fast else [])) == 0
    text = capsys.readouterr().out
    assert "| stage | measured ms |" in text
    out = json.loads(text.strip().splitlines()[-1])
    assert out["profile"] == ("fast" if fast else "parity")
    assert (out["batch"], out["image"]) == (2, 32)
    assert (out["peak_flops"], out["peak_bytes_per_sec"]) == device_peaks(
        "cpu")
    assert len(out["stages"]) == 4
    last = out["stages"][-1]["stage"]
    assert ("HEAD stage" in last) if fast else ("LAST stage" in last)
    for row in out["stages"]:
        assert row["gflops"] > 0 and row["gbytes"] > 0
        assert row["bound"] in ("compute", "bandwidth")
        assert np.isfinite(row["measured_ms"])
    assert out["stage_sum_ms"] > 0


def test_hbm_roofline_json(capsys):
    T = _load(os.path.join("tools", "hbm_roofline_torch.py"))
    assert T.main(["--device", "cpu", "--batch", "2", "--image", "32",
                   "--slices", "8", "--stream-mb", "4"]) == 0
    out = _last_json(capsys)
    assert set(out["peak"]) == {"copy_4MB_GBps", "triad_4MB_GBps",
                                "achievable_GBps"}
    ae = out["ae"]
    assert ae["bytes_accessed_per_epoch_GB"] > 0
    assert ae["flops_per_epoch_G"] > 0
    assert ae["last_stage_map_MB"] == round(2 * 32 * 32 * 32 * 2 / 1e6, 1)
    assert "hbm_utilization_pct" in out
