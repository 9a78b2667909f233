"""Experiment preset 'AE' on the port: forwards ``--preset AE`` and
the command line's arguments to the port's CLI (``cli.main``).

    python -m unsupervised_anomaly_detection_brain_mri_tpu_torch.mains.main_AE [flags]
"""

import sys

from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main(["--preset", "AE"] + sys.argv[1:]))
