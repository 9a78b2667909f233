"""BrainWeb dataset downloader (host-side tooling).

Copy of `unsupervised_anomaly_detection_brain_mri_tpu/data/download.py`:
the same form POSTs to brainweb.bic.mni.mcgill.ca (T2 phantoms, normal and
mild/moderate/severe MS lesions, over 4 noise x 3 intensity-non-uniformity
levels, and the crisp tissue-label groundtruths), the same folder layout
(``normal/``, ``lesions/{mild,moderate,severe}/``, ``groundtruth/``) and
file names, raw MINC payloads gzipped.  One change: ``opener`` defaults to
None and is resolved to ``urllib.request.urlopen`` when the function is
called, so a caller can hand in another opener (a local server, a test's
fake) without patching this module.

    python -m unsupervised_anomaly_detection_brain_mri_tpu_torch.data.download DIR
"""

from __future__ import annotations

import gzip
import os
import urllib.parse
import urllib.request
from typing import Dict, Iterable, Optional

BRAINWEB_URL = "http://brainweb.bic.mni.mcgill.ca/cgi/brainweb1"

NOISE_LEVELS = ("pn0", "pn1", "pn3", "pn5")
INU_LEVELS = ("rf0", "rf20", "rf40")

PHANTOMS = {
    "normal": "normal",
    "msles1": "mild",
    "msles2": "moderate",
    "msles3": "severe",
}
GROUNDTRUTHS = {
    "normal": ("phantom_1.0mm_normal_crisp", "normal.mnc.gz"),
    "msles1": ("phantom_1.0mm_msles1_crisp", "mild_lesions.mnc.gz"),
    "msles2": ("phantom_1.0mm_msles2_crisp", "moderate_lesions.mnc.gz"),
    "msles3": ("phantom_1.0mm_msles3_crisp", "severe_lesions.mnc.gz"),
}


def _fetch(params: Dict[str, str], out_path: str, opener=None) -> None:
    opener = opener or urllib.request.urlopen
    data = urllib.parse.urlencode(params).encode()
    req = urllib.request.Request(BRAINWEB_URL, data=data)
    with opener(req) as resp:
        payload = resp.read()
    # server returns raw MINC when do_download_alias ends in download; make
    # sure we store gzipped like the loader expects
    if not payload[:2] == b"\x1f\x8b":
        payload = gzip.compress(payload)
    with open(out_path, "wb") as f:
        f.write(payload)


def download_brainweb_dataset(
    target_dir: str,
    phantoms: Optional[Iterable[str]] = None,
    noise_levels: Iterable[str] = NOISE_LEVELS,
    inu_levels: Iterable[str] = INU_LEVELS,
    modality: str = "t2",
    opener=None,
) -> None:
    """Download phantoms + groundtruths into the BRAINWEB folder layout.
    ``opener`` (default ``urllib.request.urlopen``, looked up at call time)
    takes a ``urllib.request.Request`` and returns a context manager whose
    ``read()`` gives the payload."""
    phantoms = list(phantoms or PHANTOMS.keys())
    for phantom in phantoms:
        folder = ("normal" if phantom == "normal"
                  else os.path.join("lesions", PHANTOMS[phantom]))
        out_dir = os.path.join(target_dir, folder)
        os.makedirs(out_dir, exist_ok=True)
        for noise in noise_levels:
            for inu in inu_levels:
                alias = f"{modality}_icbm_{phantom}_1mm_{noise}_{inu}"
                out = os.path.join(out_dir, f"{modality}_{phantom}_"
                                            f"{noise}_{inu}.mnc.gz")
                if os.path.exists(out):
                    continue
                _fetch({
                    "do_download_alias": alias,
                    "format_value": "minc",
                    "zip_value": "gnuzip",
                    "download_for_real": "[Start download!]",
                }, out, opener)

    gt_dir = os.path.join(target_dir, "groundtruth")
    os.makedirs(gt_dir, exist_ok=True)
    for phantom in phantoms:
        alias, fname = GROUNDTRUTHS[phantom]
        out = os.path.join(gt_dir, fname)
        if os.path.exists(out):
            continue
        _fetch({
            "do_download_alias": alias,
            "format_value": "minc",
            "zip_value": "gnuzip",
            "download_for_real": "[Start download!]",
        }, out, opener)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Download BrainWeb phantoms")
    ap.add_argument("target_dir")
    ap.add_argument("--modality", default="t2")
    args = ap.parse_args()
    download_brainweb_dataset(args.target_dir, modality=args.modality)
