"""The CPU sweep, part 2 of 3: each preset through the port's ``run_all``
at the quality tables' recipe with ``--device cpu``, checked against the
port's CPU table, the JAX CPU table and the JAX seed spread
(``tests/_torch_sweep.py``)."""

import pytest

from _torch_sweep import check_preset, one_torch_thread  # noqa: F401

PRESETS = ("GMVAE_spatial", "GMVAE", "GMVAE_You", "ceVAE",
           "constrainedAE", "fAnoGAN", "AnoVAEGAN")


@pytest.mark.parametrize("name", PRESETS)
def test_preset_within_the_tables(name, tmp_path):
    check_preset(name, tmp_path)
