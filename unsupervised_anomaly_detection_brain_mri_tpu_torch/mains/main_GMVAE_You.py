"""Experiment preset 'GMVAE_You' on the port: forwards ``--preset GMVAE_You`` and
the command line's arguments to the port's CLI (``cli.main``).

    python -m unsupervised_anomaly_detection_brain_mri_tpu_torch.mains.main_GMVAE_You [flags]
"""

import sys

from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main(["--preset", "GMVAE_You"] + sys.argv[1:]))
