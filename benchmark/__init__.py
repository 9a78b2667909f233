"""The benchmark of the PyTorch and CUDA port
(``unsupervised_anomaly_detection_brain_mri_tpu_torch``) on an NVIDIA GPU.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 benchmark/run.py --workload AE.train --seed 7 --seconds 51 --trace 0

Everything that measures, and the plain reference that decides
``correct``, lives here: the harness finds a cell's configuration
(``configs/<name>.json``), traffic mix (``traffic/<mix>.json``, run by
``kinds/<kind>.py``) and metrics (``metrics/<name>.py``) by the names in
``BENCHMARK.json``, so a new cell is new files and new entries.
"""
