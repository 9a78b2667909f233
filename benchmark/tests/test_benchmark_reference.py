"""The plain reference agrees with the port on the CPU: the networks at
32 x 32, the training steps through the harness, and the serving pipeline
(at 128 x 128, where the 12 erosions leave a brain), the port computing in
float32 as the reference does."""

import importlib

import numpy as np
import pytest
import torch

from benchmark.common import manifest as M
from benchmark.common import weights
from benchmark.kinds import train as T
from benchmark.reference import ae, backbone as B, vae_you
from benchmark.reference import serving as RS

PORT = "unsupervised_anomaly_detection_brain_mri_tpu_torch"
SMALL = {"outputWidth": 32, "outputHeight": 32, "zDim": 16, "batchsize": 8,
         "compute_dtype": "float32"}


def _cfg(name, **over):
    return {**M.read_json(M.BENCH / "configs" / f"{name}.json"), **SMALL,
            **over}


def _port_model(cfg):
    from benchmark.common.context import port_config

    config = port_config(cfg, 0)
    model, _ = importlib.import_module(f"{PORT}.models.registry").get_model(
        config, torch.float32)
    return model


@pytest.mark.parametrize("name,ref", [("AE", ae), ("VAE_You", vae_you)])
@pytest.mark.parametrize("train", [True, False])
def test_networks_agree(name, ref, train):
    cfg = _cfg(name)
    p_leaves, b_leaves = ref.leaves(cfg)
    params = weights.make(p_leaves, 3, torch.device("cpu"))
    bufs = weights.make(b_leaves, 3, torch.device("cpu"))
    bufs = {k: v + 0.1 * torch.rand(v.shape) for k, v in bufs.items()}
    model = _port_model(cfg)
    weights.load_into(model, {**params, **bufs})
    model.train(train)
    x = torch.rand(4, 32, 32, 1)
    gens = [torch.Generator().manual_seed(9) for _ in range(4)]
    drop = gens[0] if train else None
    net = B.Net(params, dict(bufs), train, "float32")
    if name == "AE":
        got = model(x, dropout_generator=drop)
        want = net.autoencoder(x, cfg["dropout_rate"], gens[1] if train
                               else None)
    else:
        got = model(x, dropout_generator=drop, sample=gens[2])
        want = net.vae(x, cfg["dropout_rate"], gens[1] if train else None,
                       gens[3])
    for k in want:
        torch.testing.assert_close(got[k].float(), want[k], rtol=2e-5,
                                   atol=2e-5)


def test_train_steps_agree_through_the_harness():
    from benchmark.common.context import Run

    mix = M.read_json(M.BENCH / "traffic" / "train.json")
    for name in ("AE", "VAE_You"):
        cell = {"name": f"{name}.train", "config": name, "traffic": "train",
                "chips": 1}
        ctx = Run(device=torch.device("cpu"), seed=2 ** 33 + 1, seconds=0.0,
                  trace=False, cell=cell, config=_cfg(name),
                  mix={**mix, "pool_volumes": 2, "slices": 16}, limits={})
        numbers = T.run(ctx)[1]
        assert numbers["loss_rel"] < 1e-4, (name, numbers)
        assert numbers["grad1_rel"] < 1e-3, (name, numbers)
        assert numbers["update3_rel"] < 1e-2, (name, numbers)
        assert numbers["grad1_dir"] < 1e-5, (name, numbers)


def test_fp8_control_differs_from_float32():
    x = torch.linspace(-3, 3, 1000)
    q = RS.bf16(x.numpy())
    assert 0 < np.abs(q - x.numpy()).max() < 0.02
    from benchmark.reference.layers import quantize

    y = quantize(x, "fp8")
    assert 0 < (y - x).abs().max() < 0.2
    assert torch.equal(quantize(x, "float32"), x)


def test_transposed_convolution_equals_its_definition():
    from benchmark.common.flops import count_flops
    from benchmark.reference.layers import (conv_transpose,
                                            conv_transpose_dilated)

    w = torch.randn(3, 2, 5, 5)
    x = torch.randn(2, 3, 8, 8)
    b = torch.randn(2)
    torch.testing.assert_close(conv_transpose(x, w, b),
                               conv_transpose_dilated(x, w, b), rtol=1e-5,
                               atol=1e-5)
    # the products a SAME transposed convolution needs: each input pixel
    # times the kernel, for every pair of channels
    assert count_flops(conv_transpose, x, w, b) == 2 * 2 * 64 * 25 * 3 * 2


def test_median_and_components_agree_with_scipy():
    from scipy import ndimage as ndi

    rng = np.random.default_rng(0)
    vol = rng.uniform(size=(9, 12, 11)).astype(np.float32)
    np.testing.assert_array_equal(
        RS.median5(torch.from_numpy(vol)).numpy(),
        ndi.median_filter(vol, size=5, mode="reflect"))
    port = importlib.import_module(f"{PORT}.ops.postprocess")
    binary = rng.uniform(size=(10, 20, 20)) > 0.7
    np.testing.assert_array_equal(
        RS.filter_components(binary, 7),
        port.filter_small_components(torch.from_numpy(binary), 7).numpy())


SERVE = {"config": {"restore_steps": 3,
                    "compute_dtype": "float32"},
         "mix": {"shape": [181, 217, 40], "statistics_slices": 16,
                 "lesions": [3], "compared_requests": 1,
                 "compared_steps": 3}}


@pytest.mark.parametrize("name", ["AE", "VAE_You"])
def test_serving_agrees(name):
    from benchmark import calibrate

    (row,) = calibrate.readings(f"{name}.serve", [2 ** 35], False,
                                torch.device("cpu"), SERVE, seconds=0.1)
    if name == "AE":
        assert row["rec_rel_l1"] < 1e-5
    else:
        assert row["step_rec_rel"] < 1e-5 and row["step_grad_dir"] < 1e-6
        assert row["step0_input"] == 0.0 and row["step_update"] < 1e-6
    assert row["prep_max"] == 0.0 and row["post_own_max"] == 0.0
    assert row["score_own_map"] == 0.0 and row["mask_own_map"] == 0.0
