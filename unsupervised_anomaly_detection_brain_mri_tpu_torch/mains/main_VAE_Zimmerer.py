"""Experiment preset 'VAE_Zimmerer' on the port: forwards ``--preset VAE_Zimmerer`` and
the command line's arguments to the port's CLI (``cli.main``).

    python -m unsupervised_anomaly_detection_brain_mri_tpu_torch.mains.main_VAE_Zimmerer [flags]
"""

import sys

from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main(["--preset", "VAE_Zimmerer"] + sys.argv[1:]))
