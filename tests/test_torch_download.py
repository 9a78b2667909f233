"""The port's BrainWeb downloader (``data/download.py``) against the JAX
package's: byte-equal form POSTs and request counts for the same
arguments, the same files, raw payloads gzipped and gzipped ones kept, and
the default opener looked up when the function is called; and ``run_all
--download`` through an injected opener, then a preset trained on the
download."""

import gzip
import inspect
import io
import json
import os
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

import _torch_realdata as R
from unsupervised_anomaly_detection_brain_mri_tpu.data import (
    download as jax_download,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch import run_all
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import download

CONSTANTS = ("BRAINWEB_URL", "NOISE_LEVELS", "INU_LEVELS", "PHANTOMS",
             "GROUNDTRUTHS")


class Recorder:
    """A fake opener: records (url, method, headers, body) and answers with
    a raw payload for volumes and a gzipped one for groundtruths."""

    def __init__(self):
        self.requests = []

    def __call__(self, req):
        self.requests.append((req.full_url, req.get_method(),
                              sorted(req.header_items()), req.data))
        alias = urllib.parse.parse_qs(req.data.decode())[
            "do_download_alias"][0]
        body = f"minc:{alias}".encode()
        if alias.startswith("phantom_"):
            body = gzip.compress(body, mtime=0)
        return io.BytesIO(body)


def _tree(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_constants_equal_jax():
    for name in CONSTANTS:
        assert getattr(download, name) == getattr(jax_download, name), name


@pytest.mark.parametrize("kwargs", [
    {},  # all 4 phantoms x 4 noise x 3 INU levels, and 4 groundtruths
    {"phantoms": ["normal", "msles3"], "noise_levels": ("pn0", "pn3"),
     "inu_levels": ("rf0", "rf20")},
    {"phantoms": ["msles1", "msles2"], "modality": "t1"},
], ids=["all", "normal_severe_2x2", "mild_moderate_t1"])
def test_requests_and_files_equal_jax(tmp_path, kwargs):
    ours, theirs = Recorder(), Recorder()
    download.download_brainweb_dataset(str(tmp_path / "port"), opener=ours,
                                       **kwargs)
    jax_download.download_brainweb_dataset(str(tmp_path / "jax"),
                                           opener=theirs, **kwargs)
    assert ours.requests == theirs.requests
    phantoms = kwargs.get("phantoms", list(download.PHANTOMS))
    n_levels = (len(kwargs.get("noise_levels", download.NOISE_LEVELS))
                * len(kwargs.get("inu_levels", download.INU_LEVELS)))
    assert len(ours.requests) == len(phantoms) * (n_levels + 1)
    assert all(r[0] == download.BRAINWEB_URL and r[1] == "POST"
               for r in ours.requests)
    port_files, jax_files = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert port_files.keys() == jax_files.keys()
    # gzip stamps the time into raw payloads it compresses: compare content
    for name, blob in port_files.items():
        assert blob[:2] == b"\x1f\x8b", name
        assert gzip.decompress(blob) == gzip.decompress(jax_files[name])
    modality = kwargs.get("modality", "t2")
    if "msles3" in phantoms:
        assert f"lesions/severe/{modality}_msles3_pn0_rf0.mnc.gz" in port_files
        assert "groundtruth/severe_lesions.mnc.gz" in port_files


def test_raw_payload_gzipped_and_gzipped_kept(tmp_path):
    rec = Recorder()
    download.download_brainweb_dataset(
        str(tmp_path), phantoms=["normal"], noise_levels=("pn1",),
        inu_levels=("rf40",), opener=rec)
    vol = (tmp_path / "normal" / "t2_normal_pn1_rf40.mnc.gz").read_bytes()
    assert gzip.decompress(vol) == b"minc:t2_icbm_normal_1mm_pn1_rf40"
    gt = (tmp_path / "groundtruth" / "normal.mnc.gz").read_bytes()
    # the groundtruth came gzipped: written as it came, not twice
    assert gt == gzip.compress(b"minc:phantom_1.0mm_normal_crisp", mtime=0)


def test_existing_files_are_not_fetched_again(tmp_path):
    kw = dict(phantoms=["msles2"], noise_levels=("pn5",), inu_levels=("rf0",))
    first, second = Recorder(), Recorder()
    download.download_brainweb_dataset(str(tmp_path), opener=first, **kw)
    download.download_brainweb_dataset(str(tmp_path), opener=second, **kw)
    assert len(first.requests) == 2 and second.requests == []


def test_default_opener_resolved_at_call_time(tmp_path, monkeypatch):
    """The default is None in the signature and ``urllib.request.urlopen``
    as it is when the function runs, so patching urllib (or passing an
    opener) reaches the download without patching this module."""
    for fn in (download.download_brainweb_dataset, download._fetch):
        assert inspect.signature(fn).parameters["opener"].default is None
    rec = Recorder()
    monkeypatch.setattr(urllib.request, "urlopen", rec)
    download.download_brainweb_dataset(
        str(tmp_path), phantoms=["normal"], noise_levels=("pn0",),
        inu_levels=("rf0",))
    assert len(rec.requests) == 2
    assert (tmp_path / "normal" / "t2_normal_pn0_rf0.mnc.gz").is_file()


def test_run_all_download_then_trains(tmp_path):
    """``run_all --download -c paths.json`` downloads BrainWeb (all 4
    phantoms at 4 x 3 levels and 4 groundtruths, through the injected
    opener) into the file's ``BRAINWEBDIR``, then trains ``--presets AE``
    on it and evaluates BRAINWEB (``-d``); exit 0."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    target = tmp_path / "brainweb"
    paths = tmp_path / "paths.json"
    paths.write_text(json.dumps({
        "BRAINWEBDIR": str(target), "SAMPLEDIR": str(tmp_path / "samples"),
        "CHECKPOINTDIR": str(tmp_path / "checkpoints")}))
    server = R.FakeBrainWeb((40, 40, 40))
    board = tmp_path / "board.json"
    rc = run_all.main(["--download", "--presets", "AE", "--scoreboard",
                       str(board), "-c", str(paths), "-d", "Brainweb",
                       "--device", "cpu", "-w", "32", "-g", "32", "-z", "16",
                       "-b", "8", "-E", "1", "-s", "0", "-e", "40",
                       "--precision", "float32"], opener=server)
    torch.set_num_threads(threads)
    assert rc == 0
    assert len(server.requests) == 4 * 4 * 3 + 4
    assert len(os.listdir(target / "normal")) == 12
    assert len(os.listdir(target / "lesions" / "severe")) == 12
    rows = json.loads(board.read_text())["AE"]
    assert [r["description"] for r in rows] == [
        "Brainweb_upperbound_bestdice_wPrior"]
    assert np.isfinite(rows[0]["AUROC"])
