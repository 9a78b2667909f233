"""The port's ``validate-data`` against the JAX package's subcommand, on the
trees of ``tests/test_validate_data.py``: a valid BrainWeb tree, a missing
directory, an empty one, an MSISBI2015 tree with and without a lesion
mask, and an unknown dataset kind.  Both give the same report (as a dict
and as text) and, through each CLI, the same exit code and output."""

import os

import numpy as np
import pytest

from test_data import _make_brainweb_tree, _make_msisbi_tree
from unsupervised_anomaly_detection_brain_mri_tpu.cli import main as jax_main
from unsupervised_anomaly_detection_brain_mri_tpu.data import (
    validate as jax_validate,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import main
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import validate


def _trees(root):
    """name -> (dataset kind, directory, validate_dataset_dir kwargs)."""
    rng = np.random.default_rng(0)
    bw = os.path.join(root, "bw")
    os.makedirs(bw)
    _make_brainweb_tree(bw, rng)
    isbi = os.path.join(root, "isbi")
    os.makedirs(isbi)
    _make_msisbi_tree(isbi, rng)
    empty = os.path.join(root, "empty")
    os.makedirs(empty)
    return {
        "valid": ("BRAINWEB", bw, dict(deep=True)),
        "missing": ("BRAINWEB", os.path.join(root, "nope"), {}),
        "empty": ("MSLUB", empty, {}),
        "isbi_flair": ("MSISBI2015", isbi, dict(protocols=("FLAIR",))),
        "isbi_all": ("MSISBI2015", isbi, {}),
    }


def _same_report(kind, directory, kwargs):
    ours = validate.validate_dataset_dir(kind, directory, **kwargs)
    theirs = jax_validate.validate_dataset_dir(kind, directory, **kwargs)
    assert ours == theirs
    assert validate.format_report(ours) == jax_validate.format_report(theirs)
    return ours


def test_reports_equal_jax_on_every_tree(tmp_path):
    trees = _trees(str(tmp_path))
    ok = {name: _same_report(*spec)["ok"] for name, spec in trees.items()}
    assert ok == {"valid": True, "missing": False, "empty": False,
                  "isbi_flair": True, "isbi_all": False}
    isbi = trees["isbi_flair"][1]
    os.remove(os.path.join(isbi, "training01", "masks",
                           "training01_01_mask1.nii"))
    report = _same_report(*trees["isbi_flair"])
    assert not report["ok"]
    assert "MISSING groundtruth" in validate.format_report(report)


def test_unknown_kind_raises_as_in_jax(tmp_path):
    for fn in (validate.validate_dataset_dir,
               jax_validate.validate_dataset_dir):
        with pytest.raises(ValueError, match="unknown dataset"):
            fn("NOPE", str(tmp_path))


def _cli(fn, argv, capsys):
    try:
        rc = fn(argv)
    except SystemExit as e:  # argparse errors
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_exit_codes_and_output_equal_jax(tmp_path, capsys):
    trees = _trees(str(tmp_path))
    isbi = trees["isbi_flair"][1]
    cases = [
        ["-d", "BRAINWEB", "--dir", trees["valid"][1], "--deep"],
        ["-d", "BRAINWEB", "--dir", trees["missing"][1]],
        ["-d", "MSLUB", "--dir", trees["empty"][1]],
        ["-d", "MSISBI2015", "--dir", isbi, "--protocol", "FLAIR"],
        ["-d", "MSISBI2015", "--dir", isbi],
        ["-d", "NOPE", "--dir", isbi],
        ["--dir", isbi],
    ]
    codes = []
    for argv in cases:
        ours = _cli(main, ["validate-data", *argv], capsys)
        theirs = _cli(jax_main, ["validate-data", *argv], capsys)
        assert ours == theirs, argv
        codes.append(ours[0])
    assert codes == [0, 1, 1, 0, 1, 2, 2]
    os.remove(os.path.join(isbi, "training02", "preprocessed",
                           "training02_01_skullmap.nii.gz"))
    ours = _cli(main, ["validate-data", *cases[3]], capsys)
    assert ours == _cli(jax_main, ["validate-data", *cases[3]], capsys)
    assert ours[0] == 1 and "training02_01" in ours[1]
