"""Evaluation artifact export: curve plots, CSVs, slice PNGs, overlays.

Parity with the reference's artifact set: ROC/PRC pngs + csv
(`trainers/Metrics.py:17-64`), per-slice input/reconstruction/diff/heatmap
PNGs (`utils/Evaluation.py:302-321`), TP/FP/FN overlay images
(`utils/image_utils.py:22-45`), histograms with per-label export
(`utils/utils.py:30-70`).

Copy of `unsupervised_anomaly_detection_brain_mri_tpu/eval/artifacts.py`
for the port: only the import paths differ.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

try:
    import imageio.v2 as imageio
except Exception:  # pragma: no cover
    import imageio  # type: ignore


def _norm_u8(x: np.ndarray) -> np.ndarray:
    x = np.squeeze(np.asarray(x, np.float32))
    lo, hi = x.min(), x.max()
    if hi > lo:
        x = (x - lo) / (hi - lo)
    return (x * 255).astype(np.uint8)


def plot_roc(roc: Dict[str, np.ndarray], auc: float, filename: str) -> None:
    fig = plt.figure()
    plt.plot(roc["fpr"], roc["tpr"], color="darkorange", lw=2,
             label=f"ROC curve (area = {auc:.2f})")
    plt.plot([0, 1], [0, 1], color="navy", lw=2, linestyle="--")
    plt.xlim([0.0, 1.0])
    plt.ylim([0.0, 1.05])
    plt.xlabel("False Positive Rate")
    plt.ylabel("True Positive Rate")
    plt.legend(loc="lower right")
    fig.savefig(filename)
    plt.close(fig)


def plot_prc(prc: Dict[str, np.ndarray], auprc: float, filename: str) -> None:
    fig = plt.figure()
    plt.step(prc["recalls"], prc["precisions"], color="b", alpha=0.2,
             where="post")
    plt.fill_between(prc["recalls"], prc["precisions"], step="post",
                     alpha=0.2, color="b")
    plt.xlabel("Recall")
    plt.ylabel("Precision")
    plt.ylim([0.0, 1.05])
    plt.xlim([0.0, 1.0])
    plt.title(f"Precision-Recall Curve (area = {auprc:.2f}.)")
    fig.savefig(filename)
    with open(filename + ".csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["Precision", "Recall"])
        writer.writeheader()
        for p, r in zip(prc["precisions"], prc["recalls"]):
            writer.writerow({"Precision": float(p), "Recall": float(r)})
    plt.close(fig)


def plot_dice_curve(curve: Dict[str, np.ndarray], best_dice: float,
                    best_threshold: float, filename: str) -> None:
    """DICE-vs-threshold curve (dicePC.png parity,
    `trainers/Metrics.py:110-136` via `utils/Evaluation.py:442-451`)."""
    fig = plt.figure()
    order = np.argsort(curve["thresholds"])
    plt.plot(np.asarray(curve["thresholds"])[order],
             np.asarray(curve["dice"])[order], color="darkorange", lw=2,
             label="DICE vs Threshold Curve")
    plt.ylim([0.0, 1.05])
    plt.xlabel("Thresholds")
    plt.ylabel("DICE Score")
    plt.title("DICE vs Thresholds Curve")
    plt.legend(loc="lower right")
    plt.text(0.99, 0.99,
             f"Best dice score at {best_threshold:.5f} with {best_dice:.4f}",
             horizontalalignment="right", verticalalignment="top",
             transform=plt.gca().transAxes)
    fig.savefig(filename)
    plt.close(fig)


def plot_histogram_with_labels(values: np.ndarray, labels: np.ndarray,
                               bins, value_range, title: str,
                               export_pdf: Optional[str] = None) -> None:
    """Per-class histograms (`utils/utils.py:30-70`)."""
    values = values.ravel()
    labels = labels.ravel() > 0.5
    fig = plt.figure()
    plotted = False
    for name, sel in (("healthy", ~labels), ("lesion", labels)):
        vals = values[sel]
        # guard: an empty class (or one entirely outside the range) makes
        # density normalisation divide by zero -> NaN warnings
        if vals.size == 0 or not np.any(
                (vals >= value_range[0]) & (vals <= value_range[1])):
            continue
        plt.hist(vals, bins=50 if bins == "auto" else bins,
                 range=value_range, alpha=0.5, label=name, density=True)
        plotted = True
    if plotted:
        plt.legend()
    plt.title(title)
    if export_pdf:
        fig.savefig(export_pdf)
        base = os.path.splitext(export_pdf)[0]
        for name, sel in (("healthy", ~labels), ("lesion", labels)):
            hist, edges = np.histogram(
                values[sel], bins=50, range=value_range)
            np.save(f"{base}_{name}.npy", {"hist": hist, "edges": edges})
            with open(f"{base}_{name}.csv", "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["bin_left", "count"])
                for e, h in zip(edges[:-1], hist):
                    w.writerow([float(e), int(h)])
    plt.close(fig)


def overlay_prediction_groundtruth(x: np.ndarray, pred: np.ndarray,
                                   gt: np.ndarray) -> np.ndarray:
    """TP green / FP orange / FN red overlay
    (`utils/image_utils.py:22-45`)."""
    img = np.stack([_norm_u8(x)] * 3, axis=-1).astype(np.float32)
    pred = np.squeeze(pred) > 0.5
    gt = np.squeeze(gt) > 0.5
    tp = pred & gt
    fp = pred & ~gt
    fn = ~pred & gt
    img[tp] = [0, 255, 0]
    img[fp] = [255, 165, 0]
    img[fn] = [255, 0, 0]
    return img.astype(np.uint8)


def squash_intensities(img: np.ndarray) -> np.ndarray:
    """Logistic squash of residual intensities for heatmaps
    (`utils/Evaluation.py:68-74`): maps [0, ~0.2] -> [0, 1)."""
    k, offset = 100.0, 0.5
    return 2.0 * ((1.0 / (1.0 + np.exp(-k * np.asarray(img, np.float32))))
                  - offset)


def add_colorbar(img: np.ndarray) -> np.ndarray:
    """Paint a vertical intensity ramp into the last column
    (`utils/Evaluation.py:77-79`) so the jet heatmap carries its scale."""
    img = np.array(img, np.float32)
    img[:, -1] = np.arange(img.shape[0], dtype=np.float32) / img.shape[0]
    return img


def residual_heatmap(diff: np.ndarray) -> np.ndarray:
    """Reference heatmap recipe (`utils/Evaluation.py:318-321`): squash ->
    colorbar -> jet, WITHOUT per-slice min-max renormalisation, so
    intensities are comparable across slices and patients."""
    squashed = add_colorbar(squash_intensities(np.squeeze(diff)))
    heat = plt.cm.jet(np.clip(squashed, 0.0, 1.0))[..., :3]
    return (heat * 255).astype(np.uint8)


def export_slice_images(sample_dir: str, x: np.ndarray, recs: np.ndarray,
                        diffs: np.ndarray, labelmaps: np.ndarray,
                        thresholded: np.ndarray,
                        epistemic: Optional[np.ndarray] = None,
                        raw_diffs: Optional[np.ndarray] = None,
                        log_vars: Optional[np.ndarray] = None,
                        names: Optional[list] = None) -> None:
    """Per-slice PNG dumps (`utils/Evaluation.py:302-321,501-507`).

    ``diffs`` is the POST-median residual (the reference's
    ``_diff_filtered``/``_heatmap`` source, :311-321); ``raw_diffs`` is the
    pre-median residual behind ``_diff.png`` (:305) — when absent, the
    filtered stack stands in for both.  ``names`` carries the reference's
    ``{patient}_{absolute slice}`` prefixes (:302, :501-507); without it
    the global slice index is used.
    """
    os.makedirs(sample_dir, exist_ok=True)
    for i in range(x.shape[0]):
        pre = names[i] if names is not None else str(i)
        if epistemic is not None:
            heat = plt.cm.jet(_norm_u8(epistemic[i]) / 255.0)[..., :3]
            imageio.imwrite(
                os.path.join(sample_dir, f"{pre}_rec_variance_combined.png"),
                (heat * 255).astype(np.uint8))
        if log_vars is not None:
            imageio.imwrite(os.path.join(sample_dir, f"{pre}_logvar.png"),
                            _norm_u8(log_vars[i]))
        imageio.imwrite(os.path.join(sample_dir, f"{pre}.png"),
                        _norm_u8(x[i]))
        imageio.imwrite(os.path.join(sample_dir, f"{pre}_rec.png"),
                        _norm_u8(recs[i]))
        imageio.imwrite(os.path.join(sample_dir, f"{pre}_gt.png"),
                        _norm_u8(labelmaps[i]))
        imageio.imwrite(
            os.path.join(sample_dir, f"{pre}_diff.png"),
            _norm_u8(raw_diffs[i] if raw_diffs is not None else diffs[i]))
        imageio.imwrite(os.path.join(sample_dir, f"{pre}_diff_filtered.png"),
                        _norm_u8(diffs[i]))
        imageio.imwrite(os.path.join(sample_dir, f"{pre}_heatmap.png"),
                        residual_heatmap(diffs[i]))
        imageio.imwrite(
            os.path.join(sample_dir, f"{pre}_vis.png"),
            overlay_prediction_groundtruth(x[i], thresholded[i],
                                           labelmaps[i]))
