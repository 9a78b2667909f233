"""Data-parallel layer of the port: the mesh (one process per device in a
``torch.distributed`` group), its collectives and the halo-exchange
median.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/parallel/`.
Tensor parallelism (the JAX package's ``sharding.py``) is not ported yet.
"""

from unsupervised_anomaly_detection_brain_mri_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshContext,
    make_mesh,
)
