"""Host-side helpers of the port."""

from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils.logger import (  # noqa: F401
    Logger,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.utils.misc import (  # noqa: F401
    apply_colormap,
    normalize,
    timestamp,
)
