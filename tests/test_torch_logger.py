"""The port's TensorBoard ``Logger`` against the JAX package's (which writes
through ``tensorboardX``), read back by ``tensorboard``'s own
``EventAccumulator``: the same calls give the same tags and steps in the
same phase directories, scalar values exactly and the image grid's decoded
pixels within 1/255; and a 2-epoch ``AE`` fit with ``tbEveryNBatches = 2``
writes the JAX trainer's tags at its steps."""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator,
)

from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    Config as JaxConfig,
)
from unsupervised_anomaly_detection_brain_mri_tpu.config import (
    Options as JaxOptions,
)
from unsupervised_anomaly_detection_brain_mri_tpu.data.synthetic import (
    SYNTH as JaxSYNTH,
)
from unsupervised_anomaly_detection_brain_mri_tpu.data.synthetic import (
    SyntheticOptions as JaxSyntheticOptions,
)
from unsupervised_anomaly_detection_brain_mri_tpu.train import (
    get_trainer as jax_get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu.utils.logger import (
    Logger as JaxLogger,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import (
    Config,
    Options,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.synthetic import (
    SYNTH,
    SyntheticOptions,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils.logger import (
    Logger,
    encode_png,
)

DS = dict(numPatients=3, imageSize=32, numSlices=12, targetSize=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(logdir):
    """phase -> {"scalars": {tag: [(step, value)]}, "images": {tag:
    [(step, pixels)]}} of every phase directory under ``logdir``."""
    out = {}
    for phase in sorted(os.listdir(logdir)):
        ea = EventAccumulator(os.path.join(logdir, phase),
                              size_guidance={"scalars": 0, "images": 0})
        ea.Reload()
        tags = ea.Tags()
        out[phase] = {
            "scalars": {t: [(e.step, e.value) for e in ea.Scalars(t)]
                        for t in tags["scalars"]},
            "images": {t: [(e.step, np.asarray(Image.open(io.BytesIO(
                e.encoded_image_string)))) for e in ea.Images(t)]
                for t in tags["images"]}}
    return out


def _log(logger):
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(60, 16, 12, 1)).astype(np.float32)
    rec = rng.normal(size=(60, 16, 12, 1)).astype(np.float32)
    logger.log_scalars(0, {"loss": 1.2345678, "kl": np.float32(0.25),
                           "vec": np.ones(3)}, "TRAIN")
    logger.log_scalars(1, {"loss": 0.5}, "TRAIN")
    logger.log_scalars(1, {"loss": 0.75, "reconstructionLoss": 9.5}, "VAL")
    logger.log_visuals(3, x[:4], rec[:4], "TRAIN")
    logger.log_visuals(4, x, rec, "VAL")  # capped at 50 rows
    logger.log_visuals(5, np.zeros_like(x[:2]), x[:2], "TEST")
    logger.flush()
    logger.close()


def test_event_files_read_back_equal_to_jax(tmp_path):
    _log(Logger(str(tmp_path / "port")))
    _log(JaxLogger(str(tmp_path / "jax")))
    ours, theirs = _read(tmp_path / "port"), _read(tmp_path / "jax")
    assert sorted(ours) == sorted(theirs) == ["test", "train", "val"]
    for phase in theirs:
        assert ours[phase]["scalars"] == theirs[phase]["scalars"], phase
        assert sorted(ours[phase]["images"]) == sorted(
            theirs[phase]["images"])
        for tag, events in theirs[phase]["images"].items():
            got = ours[phase]["images"][tag]
            assert [s for s, _ in got] == [s for s, _ in events]
            for (_, a), (_, b) in zip(got, events):
                assert a.shape == b.shape
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert theirs["val"]["images"]["reconstruction"][0][1].shape == (
        50 * 16, 3 * 12, 3)


def test_png_decodes_to_its_pixels():
    rgb = np.random.default_rng(1).integers(0, 256, (5, 7, 3), np.uint8)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(encode_png(rgb)))), rgb)


def _tags_and_steps(logdir):
    return {phase: {kind: {t: [s for s, _ in ev] for t, ev in d.items()}
                    for kind, d in content.items()}
            for phase, content in _read(logdir).items()}


def test_fit_writes_the_jax_trainers_tags(tmp_path):
    """2 epochs of 5 batches with ``tbEveryNBatches = 2``: per epoch the
    TRAIN and VAL scalars and grids at the epoch, and every second global
    step's ``batch/<metric>`` scalars and grid, as the JAX trainer writes
    them."""
    cfg = Config(trainer="AE", model="autoencoder", outputWidth=32,
                 outputHeight=32, zDim=16, batchsize=4, numEpochs=2,
                 compute_dtype="float32")
    opts = dict(tensorboard=True, tbEveryNBatches=2)
    tr = get_trainer("AE")(cfg, Options(**opts), device="cpu",
                           workdir=str(tmp_path / "port"))
    tr.fit(SYNTH(SyntheticOptions(**DS)))
    jt = jax_get_trainer("AE")(JaxConfig.from_json(cfg.to_json()),
                               JaxOptions(**opts),
                               workdir=str(tmp_path / "jax"))
    jt.fit(JaxSYNTH(JaxSyntheticOptions(**DS)))
    # tensorboardX writes from a queue: closing drains it
    jt.logger.close()
    tr.logger.close()
    ours = _tags_and_steps(tmp_path / "port" / "logs")
    theirs = _tags_and_steps(tmp_path / "jax" / "logs")
    assert ours == theirs
    steps = theirs["train"]["scalars"]["batch/loss"]
    assert len(steps) >= 4 and all(s % 2 == 0 for s in steps)
    assert theirs["train"]["scalars"]["loss"] == [0, 1]
    assert theirs["val"]["images"]["reconstruction"] == [0, 1]
