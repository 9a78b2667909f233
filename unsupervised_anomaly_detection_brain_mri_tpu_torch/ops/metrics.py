"""Segmentation and detection metrics on tensors.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/ops/
metrics.py`: the same semantics, a GPU formulation.  Dice, confusion
counts, TPR/FPR/precision/recall/VD; exact ROC-AUC with sklearn's tie
collapsing; sklearn ``average_precision_score``; the best-Dice threshold
over every distinct cut point; the precision-70 operating threshold of
scikit-learn 0.23's truncated precision-recall curve.

The sweep sorts the scores once (descending; ``torch.sort`` need not be
stable, so only tie-group aggregates are read), takes cumulative TP/FP
counts in int64 (a float32 cumsum stops counting at 2^24 voxels), and
keeps the last position of each distinct score: the "group ends" where
sklearn's curves have their points.  The TPU formulation recovered each
group end's predecessor with a masked cummax to avoid random gathers; here
the group ends are gathered with ``nonzero``.  The Dice and precision
values that an argmax or a ``<= 0.7`` test reads are float32 ratios of the
exact counts, as in the JAX package, so both pick the same cut point.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# pointwise / confusion metrics


def dice(P: Tensor, G: Tensor) -> Tensor:
    """(2*sum(P*G)) / (sum(P)+sum(G)), no epsilon."""
    P = P.to(torch.float32).reshape(-1)
    G = G.to(torch.float32).reshape(-1)
    return (2.0 * torch.sum(P * G)) / (torch.sum(P) + torch.sum(G))


def confusion_matrix(P: Tensor, G: Tensor
                     ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(tp, fp, tn, fn) counts."""
    P = P.to(torch.bool).reshape(-1)
    G = G.to(torch.bool).reshape(-1)
    tp = torch.sum(P & G)
    fp = torch.sum(P & ~G)
    fn = torch.sum(~P & G)
    tn = torch.sum(~P & ~G)
    return tp, fp, tn, fn


def tpr(P: Tensor, G: Tensor) -> Tensor:
    tp, fp, tn, fn = confusion_matrix(P, G)
    return tp / (tp + fn)


def fpr(P: Tensor, G: Tensor) -> Tensor:
    tp, fp, tn, fn = confusion_matrix(P, G)
    return fp / (fp + tn)


def precision(P: Tensor, G: Tensor) -> Tensor:
    tp, fp, tn, fn = confusion_matrix(P, G)
    return tp / (tp + fp)


def recall(P: Tensor, G: Tensor) -> Tensor:
    return tpr(P, G)


def vd(P: Tensor, G: Tensor) -> Tensor:
    """Volume difference: sum(|xor(P&G, G)|)/sum(G)."""
    P = P.to(torch.bool).reshape(-1)
    G = G.to(torch.bool).reshape(-1)
    return (torch.sum(torch.logical_xor(P & G, G).to(torch.float32))
            / torch.sum(G.to(torch.float32)))


# ---------------------------------------------------------------------------
# the sorted sweep


def _sweep(scores: Tensor, labels: Tensor):
    """The scores sorted descending (``s``), the cumulative int64 TP/FP
    counts at every position (``tps``/``fps``), and ``ends``, the last
    position of each distinct score (group ends)."""
    s = scores.reshape(-1).to(torch.float32)
    li = (labels.reshape(-1) > 0).to(torch.int64)
    s, order = torch.sort(s, descending=True)
    li = li[order]
    tps = torch.cumsum(li, 0)
    fps = torch.cumsum(1 - li, 0)
    n = s.shape[0]
    distinct = torch.ones(n, dtype=torch.bool, device=s.device)
    distinct[:-1] = s[:-1] != s[1:]
    ends = torch.nonzero(distinct).squeeze(1)
    return s, tps, fps, ends


def _prev(v: Tensor) -> Tensor:
    """Each group end's predecessor group-end value (0 for the first)."""
    return torch.cat([torch.zeros_like(v[:1]), v[:-1]])


def _roc_auc(tps_e: Tensor, fps_e: Tensor) -> Tensor:
    # trapezoids from exact integer differences and sums, one float64
    # rounding at the end
    seg = (fps_e - _prev(fps_e)) * (tps_e + _prev(tps_e))
    denom = tps_e[-1].to(torch.float64) * fps_e[-1].to(torch.float64)
    return seg.sum().to(torch.float64) * 0.5 / denom


def _average_precision(tps_e: Tensor, fps_e: Tensor) -> Tensor:
    prec = tps_e.to(torch.float64) / torch.clamp_min(tps_e + fps_e, 1)
    seg = (tps_e - _prev(tps_e)).to(torch.float64) * prec
    return seg.sum() / tps_e[-1].to(torch.float64)


def _dice_values(tps_e: Tensor, fps_e: Tensor, P: Tensor) -> Tensor:
    """float32 Dice of each cut point, computed as the JAX package does."""
    return ((2 * tps_e).to(torch.float32)
            / (tps_e + fps_e + P).to(torch.float32))


def _best_dice(s: Tensor, tps_e: Tensor, fps_e: Tensor, ends: Tensor
               ) -> Tuple[Tensor, Tensor]:
    """(best Dice, threshold): the first maximal cut point; the threshold
    is the next distinct score (0 beyond the last group), which realises
    that cut under the strict ``scores > t`` convention."""
    dice_v = _dice_values(tps_e, fps_e, tps_e[-1])
    j = torch.argmax(dice_v)
    nxt = torch.cat([s[ends[1:]], torch.zeros_like(s[:1])])[j]
    return dice_v[j], nxt


def _precision_threshold(s: Tensor, tps_e: Tensor, fps_e: Tensor,
                         ends: Tensor, target: float = 0.7) -> Tensor:
    """scikit-learn 0.23's ``thresholds[argmax(precisions <= target)]``:
    its curve holds the group ends up to the first one with full recall;
    the answer is the lowest such threshold with precision <= target, or
    the full-recall threshold when none has."""
    prec = (tps_e.to(torch.float32)
            / torch.clamp_min(tps_e + fps_e, 1).to(torch.float32))
    idx = torch.arange(tps_e.shape[0], device=s.device)
    last = torch.argmax((tps_e >= tps_e[-1]).to(torch.int32))
    ok = (idx <= last) & (prec <= target)
    j = torch.where(ok.any(), torch.max(torch.where(ok, idx, -1)), last)
    return s[ends[j]]


def precision70_threshold(scores: Tensor, labels: Tensor,
                          target: float = 0.7) -> Tensor:
    """Threshold at the precision <= ``target`` operating point."""
    s, tps, fps, ends = _sweep(scores, labels)
    return _precision_threshold(s, tps[ends], fps[ends], ends, target)


def roc_auc(scores: Tensor, labels: Tensor) -> Tensor:
    """Exact AUROC with sklearn tie handling (float64)."""
    s, tps, fps, ends = _sweep(scores, labels)
    return _roc_auc(tps[ends], fps[ends])


def average_precision(scores: Tensor, labels: Tensor) -> Tensor:
    """sklearn ``average_precision_score``: sum over distinct thresholds of
    (R_n - R_{n-1}) * P_n (float64)."""
    s, tps, fps, ends = _sweep(scores, labels)
    return _average_precision(tps[ends], fps[ends])


def best_dice_threshold(scores: Tensor, labels: Tensor
                        ) -> Tuple[Tensor, Tensor]:
    """Global-optimum (dice, threshold) over all cut points."""
    s, tps, fps, ends = _sweep(scores, labels)
    return _best_dice(s, tps[ends], fps[ends], ends)


def _sample_positions(n: int, num_points: int, device) -> Tensor:
    return torch.from_numpy(np.linspace(0, n - 1, num_points).astype(
        np.int64)).to(device)


def _curve_samples(scores: Tensor, labels: Tensor, num_points: int):
    """The sorted sweep sampled at ``num_points`` even positions of the
    sorted order: (thresholds, TP, FP, P, N), the counts in float64."""
    s, tps, fps, _ = _sweep(scores, labels)
    pos = _sample_positions(s.shape[0], num_points, s.device)
    return (s[pos], tps[pos].to(torch.float64), fps[pos].to(torch.float64),
            tps[-1].to(torch.float64), fps[-1].to(torch.float64))


def roc_curve_points(scores: Tensor, labels: Tensor, num_points: int = 256
                     ) -> Dict[str, Tensor]:
    """(fpr, tpr, thresholds) sampled along the sorted sweep for curve
    artifacts (rocPC.npy parity; the exact AUC comes from roc_auc)."""
    ts, tp, fp, P, N = _curve_samples(scores, labels, num_points)
    return {"fpr": fp / N, "tpr": tp / P, "thresholds": ts}


def prc_curve_points(scores: Tensor, labels: Tensor, num_points: int = 256
                     ) -> Dict[str, Tensor]:
    """(precisions, recalls, thresholds) sampled along the sorted sweep."""
    ts, tp, fp, P, _ = _curve_samples(scores, labels, num_points)
    return {"precisions": tp / torch.clamp_min(tp + fp, 1.0),
            "recalls": tp / P, "thresholds": ts}


def dice_at_threshold(scores: Tensor, labels: Tensor, t) -> Tensor:
    """Dice of ``scores > t`` against ``labels``."""
    return dice((scores > t).to(torch.float32), labels)


def anomaly_curve_summary(scores: Tensor, labels: Tensor,
                          num_points: int = 256) -> Dict[str, object]:
    """AUROC, AP, the best-Dice threshold, the precision-70 threshold and
    ROC/PRC/Dice curve samples at ``num_points`` even positions of the
    sorted order, from one sort."""
    s, tps, fps, ends = _sweep(scores, labels)
    tps_e, fps_e = tps[ends], fps[ends]
    P = tps[-1].to(torch.float64)
    best, nxt = _best_dice(s, tps_e, fps_e, ends)
    pos = _sample_positions(s.shape[0], num_points, s.device)
    tp_s, fp_s = tps[pos].to(torch.float64), fps[pos].to(torch.float64)
    return {
        "auc": _roc_auc(tps_e, fps_e),
        "ap": _average_precision(tps_e, fps_e),
        "best_dice": best,
        "best_threshold": nxt,
        "precision70_threshold": _precision_threshold(s, tps_e, fps_e,
                                                      ends),
        "roc": {"fpr": fp_s / fps[-1].to(torch.float64), "tpr": tp_s / P,
                "thresholds": s[pos]},
        "prc": {"precisions": tp_s / torch.clamp_min(tp_s + fp_s, 1.0),
                "recalls": tp_s / P, "thresholds": s[pos]},
        "dice_curve": {"dice": 2.0 * tp_s / (tp_s + fp_s + P),
                       "thresholds": s[pos]},
    }


def segmented_confusion_stats(pred: Tensor, gt: Tensor, owners: Tensor,
                              n_patients: int) -> Dict[str, Tensor]:
    """Per-patient TP / |P| / |G| vectors and global TP/FP/TN/FN, in int64.

    pred, gt: (S, ...) binary volumes; owners: (S,) patient index of each
    slice."""
    S = pred.shape[0]
    p = pred.reshape(S, -1) > 0.5
    g = gt.reshape(S, -1) > 0.5
    tp_s = torch.sum(p & g, dim=1)
    p_s = torch.sum(p, dim=1)
    g_s = torch.sum(g, dim=1)
    owners = owners.to(device=pred.device, dtype=torch.int64)

    def seg(v: Tensor) -> Tensor:
        return torch.zeros(n_patients, dtype=torch.int64,
                           device=v.device).index_add_(0, owners, v)

    TP, Pn, Gn = tp_s.sum(), p_s.sum(), g_s.sum()
    return {
        "per_tp": seg(tp_s), "per_p": seg(p_s), "per_g": seg(g_s),
        "TP": TP, "FP": Pn - TP, "FN": Gn - TP,
        "TN": p.numel() - Pn - Gn + TP,
    }


def combined_predictive_uncertainty(p: Tensor, sigmas: Tensor,
                                    axis: int = -1,
                                    log_var: bool = False) -> Tensor:
    """Kendall & Gal combined aleatoric + epistemic variance."""
    if log_var:
        sigmas = torch.exp(sigmas)
    return (torch.mean(torch.square(p), dim=axis)
            - torch.square(torch.mean(p, dim=axis))
            + torch.mean(sigmas, dim=axis))
