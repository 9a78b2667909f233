"""``python -m unsupervised_anomaly_detection_brain_mri_tpu_torch infer ...``"""

import sys

from unsupervised_anomaly_detection_brain_mri_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
