"""Host-side data layer: volume I/O, normalisation, the procedural phantom
and the dataset loaders.

Copies of the modules of `unsupervised_anomaly_detection_brain_mri_tpu/
data/` that the port reaches (numpy and scipy only), with the port's import
paths; the native helper library is built from the port's own
``csrc_host/uadmri_native.cpp``.  Names, behaviour and on-disk formats
(``.npz``/``.uadc`` caches, NIfTI) are the JAX package's.
"""

from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.formats import (  # noqa: F401
    write_nifti,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.preprocess import (  # noqa: F401
    normalize_volume,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.synthetic import (  # noqa: F401
    make_phantom,
)
from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.volume import (  # noqa: F401
    open_volume,
)
