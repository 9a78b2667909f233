"""Experiment preset 'ceVAE_Zimmerer' on the port: forwards ``--preset ceVAE_Zimmerer`` and
the command line's arguments to the port's CLI (``cli.main``).

    python -m unsupervised_anomaly_detection_brain_mri_tpu_torch.mains.main_ceVAE_Zimmerer [flags]
"""

import sys

from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main(["--preset", "ceVAE_Zimmerer"] + sys.argv[1:]))
