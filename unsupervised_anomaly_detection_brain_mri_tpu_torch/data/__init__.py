"""Host-side data layer, shared with the JAX package.

These modules of `unsupervised_anomaly_detection_brain_mri_tpu/data/` use
only numpy and scipy (no JAX), so the port imports them rather than copying
them: volume I/O, normalisation and the procedural phantom.
"""

from unsupervised_anomaly_detection_brain_mri_tpu.data.formats import (  # noqa: F401
    write_nifti,
)
from unsupervised_anomaly_detection_brain_mri_tpu.data.preprocess import (  # noqa: F401
    normalize_volume,
)
from unsupervised_anomaly_detection_brain_mri_tpu.data.synthetic import (  # noqa: F401
    make_phantom,
)
from unsupervised_anomaly_detection_brain_mri_tpu.data.volume import (  # noqa: F401
    open_volume,
)
