"""Volume-wise evaluation: reconstruction, residual post-processing, the
metric sweep, threshold selection and threshold transfer.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/eval/
evaluate.py`.  The residual pipeline keeps the JAX package's order:
positive residual -> multiply by the eroded brainmask -> hyperintensity
prior -> 5^3 median.  The median goes through
``ops.median.median_filter_3d_auto``, so every volume evaluated on the card
launches the CUDA kernel once.  Residuals accumulate on the trainer's
device; the curve sweep, connected components, confusion counts and
detection counts run there; host copies are made where artifacts need them.

Trainers that restore a volume stack (``VAE_You``) reconstruct
``restorationVolumeBatch`` volumes per restoration.  With
``numMonteCarloSamples > 1`` every volume is reconstructed that many times
with dropout on; the samples are masked by the eroded brainmask, their mean
is the reconstruction, and the epistemic and combined variances enter the
eval dict (``epistemic_variance``, ``combined_variance``) and their
histogram.  The median still runs once per volume.

Random sources (the seeding rule): volume p of a split (its index in the
split's enumeration) is reconstructed with a generator on the trainer's
device seeded from the tuple ``(config.seed + 7, p)``, and its MC sample i
with one seeded from ``(config.seed + 7, p, i)``; ``volume_generator``
turns a tuple into a seed through numpy's ``SeedSequence``.  Serving uses
``(0,)`` and ``(0, i)``.  The JAX package folds the same indices into
``key(seed + 7)``; the two streams differ, so MC results agree between the
packages in distribution, and exactly only with given noise and no
dropout.

Under a data-parallel mesh every rank evaluates every volume: the
trainer's ``reconstruct_device`` splits each batch over the ranks and hands
every rank the whole reconstruction, and each rank post-processes it (the
median once per volume on every rank), so the metrics agree on all ranks;
only the trainer's writer (rank 0) writes artifacts.

Artifacts are the JAX package's: ``evalPC.npy``/``.txt``/``.json``,
``rocPC.npy``, ``prcPC.npy`` and the histogram, curve and slice pictures of
``eval/artifacts.py`` (the port's copy of the JAX package's module).  The pictures need matplotlib and
imageio; without them each one is replaced by a printed line naming the
missing package, and every numeric artifact is still written.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from scipy import ndimage as ndi

from unsupervised_anomaly_detection_brain_mri_tpu_torch.config import Config, Options
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils.misc import (
    json_sanitize,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import write_nifti
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
    metrics as M,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops import (
    postprocess as P,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.ops.median import (
    median_filter_3d_auto,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils import trace

def _artifacts() -> Tuple[Any, Optional[str]]:
    """(module, None), or (None, name of the missing package): the plots
    of ``eval/artifacts.py`` need matplotlib and imageio."""
    try:
        from unsupervised_anomaly_detection_brain_mri_tpu_torch.eval import (
            artifacts,
        )
    except ModuleNotFoundError as e:
        return None, e.name
    return artifacts, None


def _plot(what: str, name: str, *args: Any, **kwargs: Any) -> None:
    """``artifacts.<name>(...)``, or one line saying why ``what`` is
    missing."""
    module, missing = _artifacts()
    if module is None:
        print(f"[artifacts] {missing} is not installed: {what} not written")
        return
    getattr(module, name)(*args, **kwargs)


def _writes(trainer) -> bool:
    """Whether this process writes artifacts: the trainer's writer (rank 0)
    under a mesh; a duck-typed trainer without ``is_writer`` writes."""
    return getattr(trainer, "is_writer", True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _zoom_volume(vol: np.ndarray, target: Tuple[int, int],
                 seg: bool = False) -> np.ndarray:
    """Per-slice scipy zoom.  vol: (H, W, S) -> (S, target_h, target_w);
    images use the default spline order, segmentations boundary 'nearest'
    (binarised downstream)."""
    with trace.span("serve.zoom"):
        H, W, S = vol.shape
        if (H, W) == tuple(target):
            return np.transpose(vol, (2, 0, 1)).astype(np.float32)
        zoom = (target[0] / H, target[1] / W)
        out = np.zeros((S, target[0], target[1]), np.float32)
        for s in range(S):
            if seg:
                out[s] = ndi.zoom(vol[:, :, s], zoom, mode="nearest")
            else:
                out[s] = ndi.zoom(vol[:, :, s], zoom)
        return out


def volume_generator(device: torch.device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integer tuple ``key``
    (through numpy's ``SeedSequence``): ``(seed + 7, p)`` for volume p of
    an evaluation, ``(seed + 7, p, i)`` for its MC sample i."""
    seed = int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _mc_combine(recs: List[torch.Tensor], mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, epistemic variance, combined variance) of MC samples already
    masked by ``mask``.  No ported model has an aleatoric ``log_var`` head,
    so the combined variance is the epistemic one, masked."""
    stacked = torch.stack(recs)
    epistemic = M.combined_predictive_uncertainty(
        stacked, torch.zeros_like(stacked), axis=0)
    return stacked.mean(dim=0), epistemic, epistemic * mask


def _reconstruct_stack(vols: torch.Tensor, counts: List[int],
                       options: Options, keys: List[Tuple[int, ...]],
                       erodeds: List[Optional[torch.Tensor]],
                       reconstruct: Callable[..., torch.Tensor]
                       ) -> List[Dict[str, Any]]:
    """Reconstruct K volumes stacked as (K, S, H, W, 1), volume k's first
    ``counts[k]`` slices real, with MC dropout when
    ``numMonteCarloSamples > 1``.

    ``reconstruct(vols, dropout, generators)`` returns the (K, S, H, W, 1)
    reconstruction, volume k drawing from ``generators[k]``: that is
    ``volume_generator(device, *keys[k])``, and ``(*keys[k], i)`` for MC
    sample i.  Every MC sample is masked by the eroded brainmask
    (``erodeds``, (S_k, H, W) on the device, needed for MC) before the
    samples are combined: the reconstruction is their mean and the
    variances come from ``combined_predictive_uncertainty``.  ``l1`` (sum
    |x - rec|) and ``l2`` (sum sqrt((x - rec)^2)) per slice are those of
    the last, unmasked sample.  Padding is cropped; everything returned
    stays on the device."""
    device = vols.device
    mc = int(options.numMonteCarloSamples or 0)
    epistemic = combined = None
    if mc > 1:
        mask = torch.zeros_like(vols)
        for k, er in enumerate(erodeds):
            mask[k, : counts[k]] = er[..., None].to(torch.float32)
        recs = []
        for i in range(mc):
            raw_last = reconstruct(vols, True, [
                volume_generator(device, *key, i) for key in keys])
            recs.append(raw_last * mask)
        rec, epistemic, combined = _mc_combine(recs, mask)
    else:
        rec = raw_last = reconstruct(vols, False, [
            volume_generator(device, *key) for key in keys])
    err = vols - raw_last
    l1 = torch.sum(torch.abs(err), dim=(2, 3, 4))
    l2 = torch.sum(torch.sqrt(err ** 2), dim=(2, 3, 4))
    return [{"reconstruction": rec[k, :n],
             "epistemic": None if epistemic is None else epistemic[k, :n],
             "combined": None if combined is None else combined[k, :n],
             "l1": l1[k, :n], "l2": l2[k, :n]}
            for k, n in enumerate(counts)]


def _reconstruct_volume(trainer, x: torch.Tensor, options: Options,
                        key: Tuple[int, ...] = (0,),
                        eroded: Optional[torch.Tensor] = None
                        ) -> Dict[str, Any]:
    """``_reconstruct_stack`` of one volume x, (S, H, W, 1) on the
    trainer's device, as one batch of its slices through
    ``trainer.reconstruct_device``."""

    def reconstruct(vols, dropout, generators):
        return trainer.reconstruct_device(
            vols[0], dropout=dropout,
            generator=generators[0])["reconstruction"][None]

    with trace.span("serve.reconstruct"):
        return _reconstruct_stack(x[None], [int(x.shape[0])], options,
                                  [key], [eroded], reconstruct)[0]


def _reconstruct_volume_group(trainer, xs: List[torch.Tensor],
                              options: Options, keys: List[Tuple[int, ...]],
                              erodeds: List[Optional[torch.Tensor]]
                              ) -> List[Dict[str, Any]]:
    """``_reconstruct_stack`` of K volumes in one restoration per MC
    sample, for the trainers that restore a volume stack
    (``batched_volume_restoration``): the volumes are zero-padded to one
    slice count and stacked; each keeps its own generator and its own
    draws, and the restoration objective is per sample, so each result
    equals the volume's own ``_reconstruct_volume``."""
    counts = [int(x.shape[0]) for x in xs]
    vols = torch.zeros((len(xs), max(counts)) + tuple(xs[0].shape[1:]),
                       device=xs[0].device)
    for k, x in enumerate(xs):
        vols[k, : counts[k]] = x

    def reconstruct(vols, dropout, generators):
        return trainer.reconstruct_volumes_device(
            vols, dropout=dropout, counts=counts,
            generators=generators)["reconstruction"]

    return _reconstruct_stack(vols, counts, options, keys, erodeds,
                              reconstruct)


def _eroded_mask(skullmap: torch.Tensor, options: Options) -> torch.Tensor:
    """Brainmask after ``erosionIterations`` cross erosions (or as given
    when ``erodeBrainmask`` is off), as bool."""
    if options.erodeBrainmask:
        return P.binary_erosion_2d(skullmap, int(options.erosionIterations))
    return skullmap.to(torch.bool)


def _postprocess(x: torch.Tensor, rec: torch.Tensor, eroded: torch.Tensor,
                 prior_q: float, options: Options, want_raw: bool = False):
    """Residual -> eroded-brainmask multiply -> prior -> median, on the
    tensors' device.  x, rec, eroded: (S, H, W).  With ``want_raw`` also
    returns the residual before the median (for the ``_diff.png``
    pictures)."""
    with trace.span("serve.postprocess"):
        diff = P.positive_residual(x, rec,
                                   bool(options.keepOnlyPositiveResiduals))
        diff = diff * eroded.to(diff.dtype)
        if options.applyHyperIntensityPrior:
            diff = P.hyperintensity_prior_mask(diff, x, prior_q)
        raw = diff
        if options.medianFiltering:
            diff = median_filter_3d_auto(diff.contiguous(), 5)
        return (diff, raw) if want_raw else diff


def export_residual_volume(path: str, diff_sub: np.ndarray,
                           geometry: Dict[str, Any],
                           threshold: Optional[float] = None) -> np.ndarray:
    """Write a model-resolution residual stack (S, h, w) back into its
    source scan's geometry: de-zoom to the native slice resolution, place
    it at ``geometry['slice_range']`` along the iteration axis of a zeroed
    full-extent volume, and write it with the source pixdim/affine.  With
    ``threshold``, the binary twin ``<stem>.binary.nii.gz`` (thresholded at
    native resolution) is written too.  Returns the native float volume."""
    shape = tuple(geometry["shape"])
    axis = int(geometry["axis_index"])
    s0, _ = geometry["slice_range"]
    dims = list(shape)
    dims.append(dims.pop(axis))
    eval_shape = tuple(dims)
    h, w = eval_shape[:2]
    S, th, tw = diff_sub.shape
    if (th, tw) != (h, w):
        diff_sub = ndi.zoom(diff_sub, (1.0, h / th, w / tw))
        if diff_sub.shape != (S, h, w):
            raise ValueError(f"de-zoomed residual has shape {diff_sub.shape}, "
                             f"expected {(S, h, w)}")
    full = np.zeros(eval_shape, np.float32)
    full[:, :, s0:s0 + S] = np.transpose(diff_sub, (1, 2, 0))
    native = np.moveaxis(full, 2, axis)
    pixdim = tuple(geometry.get("pixdim", (1.0, 1.0, 1.0)))
    write_nifti(path, native, pixdim=pixdim, affine=geometry.get("affine"))
    if threshold is not None:
        base = path[:-7] if path.endswith(".nii.gz") else os.path.splitext(
            path)[0]
        write_nifti(base + ".binary.nii.gz",
                    (native > threshold).astype(np.float32),
                    pixdim=pixdim, affine=geometry.get("affine"))
    return native


def _evaluate(dataset, trainer, sample_dir: str, options: Options,
              config: Config, split: str = "TEST") -> Tuple[Dict, List]:
    """Per-patient reconstruction and residual post-processing of a split.

    Volumes stream: load and resize on the host, then reconstruct and
    post-process on the trainer's device, one volume at a time, or
    ``restorationVolumeBatch`` volumes at a time for the trainers that
    restore a volume stack.  Residuals stay on the device; inputs, labels,
    reconstructions and MC variance maps are kept on the host."""
    if _writes(trainer):
        os.makedirs(sample_dir, exist_ok=True)
    patients = dataset.patients_of(split)
    print(f"Testing {len(patients)} patients...")
    device = torch.device(trainer.device)
    target = (config.outputHeight, config.outputWidth)
    slice_span = (getattr(dataset.options, "sliceEnd", 0)
                  - getattr(dataset.options, "sliceStart", 0))
    want_raw = bool(options.exportPNGs)
    mc = int(options.numMonteCarloSamples or 0)
    group_size = max(1, int(options.restorationVolumeBatch))
    batched = (group_size > 1 and len(patients) > 1
               and trainer.batched_volume_restoration())
    if not batched:
        group_size = 1

    xs, recs, diffs, labelmaps, geoms = [], [], [], [], []
    l1s, l2s, times, raw_diffs, slice_names = [], [], [], [], []
    epistemics, combineds = [], []
    skipped = set()

    def prepare(p, patient):
        vol, gt, _, skullmap = dataset.load_volume_and_groundtruth(patient)
        # shape sanity: skip badly-coregistered volumes
        if slice_span > 0 and min(vol.shape) < slice_span:
            print(f"Skipping patient {patient.get('name', p)}: shape "
                  f"{vol.shape} smaller than slice range {slice_span}")
            skipped.add(p)
            return None
        # falsy sliceStart/sliceEnd mean the full volume depth
        s0 = getattr(dataset.options, "sliceStart", 0) or 0
        se = getattr(dataset.options, "sliceEnd", 0)
        s1 = min(se, vol.shape[2]) if se else vol.shape[2]
        x = _zoom_volume(vol[:, :, s0:s1], target)  # (S, H, W)
        seg = (_zoom_volume(gt[:, :, s0:s1], target, seg=True)
               > 0.5).astype(np.float32)
        skm = (_zoom_volume(skullmap[:, :, s0:s1], target, seg=True)
               > 0.5).astype(np.float32)
        # native geometry for residual re-export; datasets without file
        # provenance (e.g. synthetic) fall back to the axial-last frame
        geo = dict(getattr(dataset, "last_geometry", None)
                   or {"shape": vol.shape, "axis_index": 2,
                       "pixdim": (1.0, 1.0, 1.0), "affine": None})
        geo["slice_range"] = (s0, s1)
        return {"p": p, "x": x, "seg": seg, "geo": geo, "s0": s0, "s1": s1,
                "prior_q": float(np.quantile(vol, 0.9)),
                "xd": torch.from_numpy(x).to(device),
                "eroded": _eroded_mask(torch.from_numpy(skm).to(device),
                                       options)}

    def reconstruct(group):
        t0 = time.time()
        keys = [(config.seed + 7, it["p"]) for it in group]
        if batched and len(group) > 1:
            res = _reconstruct_volume_group(
                trainer, [it["xd"][..., None] for it in group], options,
                keys, [it["eroded"] for it in group])
        else:
            res = [_reconstruct_volume(trainer, it["xd"][..., None], options,
                                       key, it["eroded"])
                   for it, key in zip(group, keys)]
        _sync(device)
        per_slice = (time.time() - t0) / max(
            sum(len(it["x"]) for it in group), 1)
        times.extend([per_slice] * len(group))
        return res

    def accumulate(it, res):
        rec = res["reconstruction"][..., 0]
        out = _postprocess(it["xd"], rec, it["eroded"], it["prior_q"],
                           options, want_raw=want_raw)
        diff, raw = out if want_raw else (out, None)
        if want_raw:
            raw_diffs.append(raw.cpu().numpy())
            # names use the patient's index in the full split enumeration
            slice_names.extend(f"{it['p']}_{s}"
                               for s in range(it["s0"], it["s1"]))
        xs.append(it["x"])
        recs.append(rec.cpu().numpy())
        diffs.append(diff)
        labelmaps.append(it["seg"])
        geoms.append(it["geo"])
        l1s.append(res["l1"])
        l2s.append(res["l2"])
        if res["epistemic"] is not None:
            epistemics.append(res["epistemic"][..., 0].cpu().numpy())
            combineds.append(res["combined"][..., 0].cpu().numpy())

    pending: List[Dict[str, Any]] = []
    for p, patient in enumerate(patients):
        it = prepare(p, patient)
        if it is not None:
            pending.append(it)
        if pending and (len(pending) >= group_size
                        or p == len(patients) - 1):
            for it, res in zip(pending, reconstruct(pending)):
                accumulate(it, res)
            pending = []

    l1_np = (torch.cat(l1s).cpu().numpy() if l1s
             else np.zeros((0,), np.float32))
    l2_np = (torch.cat(l2s).cpu().numpy() if l2s
             else np.zeros((0,), np.float32))
    eval_dict = {
        "x": np.concatenate(xs) if xs else np.zeros((0,) + target),
        "reconstructions": np.concatenate(recs) if recs else None,
        "diffs": torch.cat(diffs) if diffs else None,
        "labelmaps": np.concatenate(labelmaps) if labelmaps else None,
        "slices_per_patient": [len(x) for x in xs],
        "geometries": geoms,
        "l1reconstructionErrors": l1_np.tolist(),
        "l2reconstructionErrors": l2_np.tolist(),
        "l1reconstructionErrorMean": float(l1_np.mean()) if l1s else 0.0,
        "l1reconstructionErrorVariance": float(l1_np.var()) if l1s else 0.0,
        "l2reconstructionErrorMean": float(l2_np.mean()) if l2s else 0.0,
        "l2reconstructionErrorVariance": float(l2_np.var()) if l2s else 0.0,
        "reconstructionTimes": float(np.mean(times)) if times else 0.0,
        "TPCC": 0, "FPCC": 0, "FNCC": 0,
    }
    if epistemics:
        eval_dict["epistemic_variance"] = np.concatenate(epistemics)
        eval_dict["combined_variance"] = np.concatenate(combineds)
    if raw_diffs:
        eval_dict["raw_diffs"] = np.concatenate(raw_diffs)
        eval_dict["slice_names"] = slice_names
    kept = [pt for p, pt in enumerate(patients) if p not in skipped]
    return eval_dict, kept


def _finite_mean_std(values: List[float]) -> Tuple[float, float]:
    """Mean and std over the finite entries (0/0 NaNs excluded); (0, 0)
    when there are none."""
    finite = [v for v in values if np.isfinite(v)]
    if not finite:
        return 0.0, 0.0
    return float(np.mean(finite)), float(np.std(finite))


def evaluate(dataset, trainer, options: Options, config: Config,
             epoch: Any = "last", description: Optional[str] = None
             ) -> Dict[str, Any]:
    """Full TEST evaluation.  Returns the eval dict and writes evalPC.npy /
    evalPC.txt / evalPC.json and the curve artifacts under the eval dir."""
    ts = time.strftime("%Y%m%d-%H%M%S")
    eval_dir = os.path.join(
        options.paths.sample_dir, config.model,
        config.model_dir(str(getattr(dataset, "name", "ds"))),
        f"eval-{epoch}-{ts}" + (f"-{description}" if description else ""))
    sample_dir = os.path.join(eval_dir, "samples_test_PC")
    writes = _writes(trainer)
    if writes:
        os.makedirs(sample_dir, exist_ok=True)

    eval_pc, patients = _evaluate(dataset, trainer, sample_dir, options,
                                  config, split="TEST")
    if eval_pc["diffs"] is None:
        raise ValueError(
            "evaluate(): no evaluable patients — every volume was skipped "
            "by the shape-sanity check (volume min dim < sliceEnd - "
            "sliceStart). Check the --slices/-s/-e range against the "
            "volume shapes.")
    diffs = eval_pc["diffs"]  # on the device
    labels = torch.from_numpy(eval_pc["labelmaps"]).to(diffs.device) > 0.5

    # one bulk device->host copy of the residuals, for the histograms and
    # the host-side exports
    diffs_np = diffs.cpu().numpy()
    eval_pc["diffs"] = diffs_np
    histogram_range = (0.01, 0.075)
    eval_pc["diffHistogram"], _ = np.histogram(diffs_np, bins=50,
                                               range=histogram_range)
    if writes:
        _plot("residual histogram", "plot_histogram_with_labels",
              diffs_np, eval_pc["labelmaps"], "auto", histogram_range,
              "Histogram of difference images in the lesion testing dataset",
              export_pdf=os.path.join(
                  eval_dir, "testing_lesions_diffimages_histogram.pdf"))
    if "epistemic_variance" in eval_pc:
        ev = eval_pc["epistemic_variance"]
        pos = ev[ev >= 0]
        if pos.size:
            hist_range = (1e-5, max(float(np.percentile(pos, 99.8)), 2e-5))
            eval_pc["uncertaintyHistogram"], _ = np.histogram(
                ev, bins=50, range=hist_range)
        if pos.size and writes:
            _plot("epistemic-variance histogram",
                  "plot_histogram_with_labels", ev, eval_pc["labelmaps"], 50,
                  hist_range, "Histogram of epistemic variances",
                  export_pdf=os.path.join(
                      eval_dir,
                      "testing_lesions_epistemic_variances_histogram.pdf"))

    # ROC / PRC / best Dice: one sorted sweep
    t0 = time.time()
    summary = M.anomaly_curve_summary(diffs.reshape(-1), labels.reshape(-1))
    eval_pc["bestDiceScore"] = float(summary["best_dice"])
    eval_pc["bestThreshold"] = float(summary["best_threshold"])
    curves = {name: {k: v.cpu().numpy() for k, v in summary[name].items()}
              for name in ("roc", "prc", "dice_curve")}
    if options.computeROC:
        eval_pc["diff_AUC"] = float(summary["auc"])
        if writes:
            np.save(os.path.join(eval_dir, "rocPC.npy"), curves["roc"],
                    allow_pickle=True)
            _plot("ROC plot", "plot_roc", curves["roc"], eval_pc["diff_AUC"],
                  os.path.join(eval_dir, "rocPC.png"))
    if options.computePRC:
        eval_pc["diff_AUPRC"] = float(summary["ap"])
        if writes:
            np.save(os.path.join(eval_dir, "prcPC.npy"), curves["prc"],
                    allow_pickle=True)
            _plot("PRC plot", "plot_prc", curves["prc"],
                  eval_pc["diff_AUPRC"], os.path.join(eval_dir, "prcPC.png"))
    if writes:
        _plot("Dice curve plot", "plot_dice_curve", curves["dice_curve"],
              eval_pc["bestDiceScore"], eval_pc["bestThreshold"],
              os.path.join(eval_dir, "dicePC.png"))
    print(f"Curves done in {time.time() - t0:.2f}s "
          f"(AUC={eval_pc.get('diff_AUC', float('nan')):.4f} "
          f"AUPRC={eval_pc.get('diff_AUPRC', float('nan')):.4f} "
          f"bestDice={eval_pc['bestDiceScore']:.4f} @ "
          f"{eval_pc['bestThreshold']:.5f})")

    # threshold selection, then CC filtering of the whole concatenated
    # cohort (a component may span two patients there, as in the JAX
    # package)
    threshold = (eval_pc["bestThreshold"] if options.threshold is None
                 else float(options.threshold))
    eval_pc["thresholdType"] = (
        "bestdice" if options.threshold is None else options.threshold)
    thresholded, cc_conv = P.filter_small_components(
        diffs > threshold, options.minLesionSize, return_converged=True)

    # precision-70 operating point for the detection counts.  With a
    # numeric threshold the counts reuse the fixed-threshold volume,
    # unfiltered (the reference reassigns it before the CC filter)
    if options.threshold is not None:
        thresholded_p70 = (diffs > threshold).to(torch.float32)
    elif options.computePRC:
        t70 = float(summary["precision70_threshold"])
        eval_pc["precision70Threshold"] = t70
        thresholded_p70, conv70 = P.filter_small_components(
            diffs > t70, options.minLesionSize, return_converged=True)
        cc_conv = cc_conv and conv70
    else:
        thresholded_p70 = thresholded

    # global and per-patient confusion counts, then lesion detection over
    # every patient's 20-slice chunks at once
    spp = eval_pc["slices_per_patient"]
    n_pat = len(spp)
    owners = torch.from_numpy(np.repeat(
        np.arange(max(n_pat, 1), dtype=np.int64), spp))
    stats = {k: v.cpu().numpy().astype(np.float64) for k, v in
             M.segmented_confusion_stats(thresholded, labels, owners,
                                         max(n_pat, 1)).items()}
    with np.errstate(divide="ignore", invalid="ignore"):
        per_dice = (2.0 * stats["per_tp"]
                    / (stats["per_p"] + stats["per_g"]))[:n_pat].tolist()
        per_prec = (stats["per_tp"] / stats["per_p"])[:n_pat].tolist()
        per_rec = (stats["per_tp"] / stats["per_g"])[:n_pat].tolist()
    pred_chunks, gt_chunks = [], []
    start = 0
    for n_slices in spp:
        sl = slice(start, start + n_slices)
        pred_chunks.append(P.volume_to_chunks(thresholded_p70[sl]))
        gt_chunks.append(P.volume_to_chunks(labels[sl]))
        start += n_slices
    tpcc = fpcc = fncc = 0
    if pred_chunks:
        t, f, n, conv_d = P.detection_counts_batch(torch.cat(pred_chunks),
                                                   torch.cat(gt_chunks))
        cc_conv = cc_conv and bool(conv_d.all())
        tpcc, fpcc, fncc = (int(v) for v in torch.stack(
            [t.sum(), f.sum(), n.sum()]).tolist())
    eval_pc["ccConverged"] = bool(cc_conv)
    if not eval_pc["ccConverged"]:
        warnings.warn(
            "connected-component labeling hit its iteration cap before "
            "the fixpoint; CC-filtered masks and detection counts may "
            "treat one snake-shaped component as several", RuntimeWarning)
    # NaN entries (an empty prediction, or a patient without lesions in the
    # slice range) are excluded from every aggregate
    dice_mean, dice_std = _finite_mean_std(per_dice)
    prec_mean, prec_std = _finite_mean_std(per_prec)
    rec_mean, rec_std = _finite_mean_std(per_rec)
    eval_pc.update(
        DiceScorePerPatient=per_dice,
        DiceScorePerPatientMean=dice_mean, DiceScorePerPatientStd=dice_std,
        PrecisionPerPatient=per_prec,
        PrecisionPerPatientMean=prec_mean, PrecisionPerPatientStd=prec_std,
        RecallPerPatient=per_rec,
        RecallPerPatientMean=rec_mean, RecallPerPatientStd=rec_std,
        TPCC=tpcc, FPCC=fpcc, FNCC=fncc,
    )
    tp, fp = int(stats["TP"]), int(stats["FP"])
    tn, fn = int(stats["TN"]), int(stats["FN"])
    eval_pc.update(TP=tp, FP=fp, TN=tn, FN=fn)
    with np.errstate(divide="ignore", invalid="ignore"):
        eval_pc["DiceScore"] = float(
            np.float64(2 * tp) / (2 * tp + fp + fn))
        eval_pc["TPR"] = float(np.float64(tp) / (tp + fn))
        eval_pc["FPR"] = float(np.float64(fp) / (fp + tn))
        eval_pc["VD"] = float(np.float64(fn) / (tp + fn))
    eval_pc["TPRCC"] = tpcc / (tpcc + fncc) if (tpcc + fncc) > 0 else 0.0
    eval_pc["PrecisionCC"] = tpcc / (tpcc + fpcc) if (tpcc + fpcc) > 0 else 0.0

    if options.exportPNGs and writes:
        # the variance pictures show the combined predictive variance
        _plot("slice PNGs", "export_slice_images",
              sample_dir, eval_pc["x"], eval_pc["reconstructions"],
              diffs_np, eval_pc["labelmaps"], thresholded.cpu().numpy(),
              epistemic=eval_pc.get("combined_variance"),
              raw_diffs=eval_pc.get("raw_diffs"),
              names=eval_pc.get("slice_names"))

    if options.exportVolumes and writes:
        # residual volumes (+ binary at the operating point) in the source
        # scan's geometry
        start = 0
        for n_slices, patient, geo in zip(spp, patients,
                                          eval_pc["geometries"]):
            name = patient.get("name", f"patient{start}")
            export_residual_volume(
                os.path.join(sample_dir, f"{name}.nii.gz"),
                diffs_np[start:start + n_slices], geo,
                threshold=float(threshold))
            start += n_slices

    export = {k: v for k, v in eval_pc.items()
              if k not in ("x", "diffs", "labelmaps", "reconstructions",
                           "geometries", "l1reconstructionErrors",
                           "l2reconstructionErrors", "epistemic_variance",
                           "combined_variance", "raw_diffs", "slice_names",
                           "diffHistogram")}
    if writes:
        np.save(os.path.join(eval_dir, "evalPC.npy"), export)  # type: ignore
        with open(os.path.join(eval_dir, "evalPC.txt"), "w") as f:
            f.write(str(export))
        with open(os.path.join(eval_dir, "evalPC.json"), "w") as f:
            json.dump(json_sanitize(
                {k: v for k, v in export.items()
                 if isinstance(v, (int, float, str, list))}), f, indent=2)
    eval_pc["eval_dir"] = eval_dir
    return eval_pc


def determine_threshold_on_labeled_patients(
    datasets, trainer, options: Options, config: Config,
    epoch: Any = "last", description: Optional[str] = None
) -> Tuple[float, float]:
    """Fit (bestDice, bestThreshold) on the VAL splits of ``datasets``."""
    if not isinstance(datasets, list):
        datasets = [datasets]
    all_diffs, all_labels = [], []
    ts = time.strftime("%Y%m%d-%H%M%S")
    eval_dir = os.path.join(
        options.paths.sample_dir, config.model,
        config.model_dir("val"), f"eval-{epoch}-{ts}")
    sample_dir = os.path.join(eval_dir, "samples_val_PC")
    for ds_idx, ds in enumerate(datasets):
        # one artifact dir per dataset: slice names restart per call
        ds_sample_dir = (sample_dir if len(datasets) == 1 else os.path.join(
            sample_dir, f"ds{ds_idx}_{type(ds).__name__}"))
        ed, _ = _evaluate(ds, trainer, ds_sample_dir, options, config,
                          split="VAL")
        if ed["diffs"] is not None and len(ed["diffs"]):
            all_diffs.append(ed["diffs"])
            all_labels.append(ed["labelmaps"])
            if options.exportPNGs and _writes(trainer):
                d_np = ed["diffs"].cpu().numpy()
                _plot("slice PNGs", "export_slice_images",
                      ds_sample_dir, ed["x"], ed["reconstructions"], d_np,
                      ed["labelmaps"], np.zeros_like(d_np),
                      epistemic=ed.get("combined_variance"),
                      raw_diffs=ed.get("raw_diffs"),
                      names=ed.get("slice_names"))
    if not all_diffs:
        raise ValueError(
            "threshold fitting found no evaluable VAL volumes in any "
            "dataset — every VAL split is empty or every volume was "
            "skipped by the shape-sanity check (slice range "
            f"[{options.sliceStart}, {options.sliceEnd}) vs volume "
            "extents); check the dataset partitions and slice options")
    diffs = torch.cat(all_diffs)
    labels = torch.from_numpy(np.concatenate(all_labels)).to(
        diffs.device) > 0.5
    best_dice, best_thresh = M.best_dice_threshold(diffs.reshape(-1),
                                                   labels.reshape(-1))
    return float(best_dice), float(best_thresh)
