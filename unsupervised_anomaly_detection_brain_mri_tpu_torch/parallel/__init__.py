"""Parallel layer of the port: the (data, model) mesh (one process per
device in a ``torch.distributed`` group), its collectives, the
halo-exchange median and tensor parallelism (``sharding.py``).

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/parallel/`.
"""

from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshContext,
    make_mesh,
)
