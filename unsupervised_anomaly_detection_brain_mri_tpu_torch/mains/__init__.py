"""Preset entry points of the port, one module per experiment preset of
``config.EXPERIMENT_PRESETS`` (the counterparts of the JAX package's
``mains/main_<preset>.py``).  Each forwards ``--preset <name>`` and its own
arguments to the port's CLI:

    python -m unsupervised_anomaly_detection_brain_mri_tpu_torch.mains.main_AE \\
        -c config.default.json --device cuda
"""
