"""Serving API: load a workdir and detect anomalies in new volumes.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/eval/
inference.py`.  It reads and writes the same ``config.json`` and
``calibration.json``; the checkpoint is the port's ``torch/model.pt``.

Usage:
    det = AnomalyDetector.from_workdir(workdir, device="cuda")
    result = det.detect(volume)            # (H, W, S) raw volume
    result["anomaly_map"], result["mask"], result["scores"]

When the calibration (or ``options``) has ``numMonteCarloSamples > 1``,
``detect`` runs the MC-dropout reconstruction the threshold was fitted
under and also returns ``epistemic_variance`` and ``combined_variance``.

Under ``utils.trace.recording()`` a request records a ``serve.request``
span around its stages (``serve.zoom``, ``serve.mask``, ``serve.upload``,
``serve.erode``, ``serve.reconstruct``, ``serve.postprocess``,
``serve.download``, ``serve.components``, and ``serve.download`` again for
the mask) and counts its host syncs and labelling rounds.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import Config, Options
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import (
    normalize_volume,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval.evaluate import (
    _eroded_mask,
    _postprocess,
    _reconstruct_volume,
    _zoom_volume,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
    postprocess as P,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.train.registry import (
    get_trainer,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import trace

CALIBRATION_FILE = "calibration.json"

# eval knobs that define the calibrated operating point
_CALIB_OPTION_KEYS = (
    "applyHyperIntensityPrior", "medianFiltering", "erodeBrainmask",
    "erosionIterations", "minLesionSize", "keepOnlyPositiveResiduals",
    "numMonteCarloSamples", "normalizationMethod", "upperpercentile",
)


def save_calibration(workdir: str, threshold: float, best_dice: float,
                     options: Options, dataset: str,
                     epoch: Any = None) -> str:
    """Write ``<workdir>/calibration.json``: the threshold and the eval
    options it was fitted under (same file as the JAX package)."""
    payload = {
        "threshold": float(threshold),
        "bestDiceVAL": float(best_dice),
        "dataset": str(dataset),
        "epoch": epoch if isinstance(epoch, (int, str)) else str(epoch),
        "options": {k: getattr(options, k) for k in _CALIB_OPTION_KEYS},
    }
    path = os.path.join(workdir, CALIBRATION_FILE)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    return path


def load_calibration(workdir: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(workdir, CALIBRATION_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


class AnomalyDetector:
    """A model on a device + threshold, packaged for inference."""

    def __init__(self, trainer, config: Config,
                 options: Optional[Options] = None,
                 threshold: Optional[float] = None):
        self.trainer = trainer
        self.config = config
        self.options = options or Options()
        self.threshold = threshold
        self.calibration: Optional[Dict[str, Any]] = None

    @property
    def device(self) -> torch.device:
        return self.trainer.device

    @classmethod
    def from_workdir(cls, workdir: str, threshold: Optional[float] = None,
                     options: Optional[Options] = None,
                     device: torch.device | str = "cuda"
                     ) -> "AnomalyDetector":
        """Restore from a workdir (``config.json`` + ``torch/model.pt``) onto
        ``device``.  A ``calibration.json`` supplies the threshold and the
        eval options it was fitted under; explicit arguments win."""
        with open(os.path.join(workdir, "config.json")) as f:
            config = Config.from_json(f.read())
        calibration = load_calibration(workdir)
        if calibration is not None:
            if threshold is None:
                threshold = float(calibration["threshold"])
            if options is None:
                options = Options().replace(**{
                    k: v for k, v in calibration.get("options", {}).items()
                    if k in _CALIB_OPTION_KEYS})
        trainer = get_trainer(config.trainer)(
            config, options, workdir=workdir, device=device)
        if trainer.load_checkpoint() is None:
            raise FileNotFoundError(f"no torch checkpoint under {workdir}")
        det = cls(trainer, config, options, threshold)
        det.calibration = calibration
        return det

    def detect(self, volume: np.ndarray,
               brainmask: Optional[np.ndarray] = None,
               threshold: Optional[float] = None) -> Dict[str, Any]:
        """volume: (H, W, S) raw intensities, axial slices on the last axis.

        Returns per-slice anomaly scores and the post-processed anomaly map
        at the model resolution, plus (when a threshold is set) the binary
        mask with small components removed.  Normalisation and resizing run
        on the host; reconstruction and post-processing on the device, with
        the random source ``volume_generator(device, 0)`` (``(0, i)`` for
        MC sample i)."""
        with trace.span("serve.request",
                        request=trace.count("serve.requests")):
            c = self.config
            o = self.options
            vol = normalize_volume(volume, method=o.normalizationMethod,
                                   upper_percentile=o.upperpercentile)
            # (S, H, W)
            x = _zoom_volume(vol, (c.outputHeight, c.outputWidth))
            with trace.span("serve.mask"):
                if brainmask is not None:
                    skm = (_zoom_volume(brainmask.astype(np.float32),
                                        (c.outputHeight, c.outputWidth),
                                        seg=True) > 0.5).astype(np.float32)
                else:
                    skm = (x > 0.05).astype(np.float32)
                prior_q = float(np.quantile(vol, 0.9))

            with trace.span("serve.upload"):
                xd = torch.from_numpy(x).to(self.device)
                skmd = torch.from_numpy(skm).to(self.device)
                trace.count("host_syncs", 2)
            with trace.span("serve.erode"):
                eroded = _eroded_mask(skmd, o)
                del skmd  # freed before the reconstruction
            res = _reconstruct_volume(self.trainer, xd[..., None], o, (0,),
                                      eroded)
            rec = res["reconstruction"][..., 0]
            diff = _postprocess(xd, rec, eroded, prior_q, o)

            with trace.span("serve.download"):
                diff_np = diff.cpu().numpy()
                result: Dict[str, Any] = {
                    "anomaly_map": diff_np,
                    "reconstruction": rec.cpu().numpy(),
                    "scores": diff_np.reshape(diff_np.shape[0],
                                              -1).max(axis=1),
                }
                trace.count("host_syncs", 2)
                if res["epistemic"] is not None:
                    result["epistemic_variance"] = res["epistemic"][
                        ..., 0].cpu().numpy()
                    result["combined_variance"] = res["combined"][
                        ..., 0].cpu().numpy()
                    trace.count("host_syncs", 2)
            t = threshold if threshold is not None else self.threshold
            if t is not None:
                mask, cc_conv = P.filter_small_components(
                    diff > float(t), o.minLesionSize, return_converged=True)
                with trace.span("serve.download"):
                    result["mask"] = mask.cpu().numpy()
                    trace.count("host_syncs")
                result["anomalous_voxels"] = int(result["mask"].sum())
                result["cc_converged"] = bool(cc_conv)
            return result
