"""Attention and multi-device execution for the port: the plain path, the
flash-attention kernels, the meshes, ring attention over the ``sp`` axis,
the mesh executor and the multi-process runtime.

The names the JAX package's ``parallel`` exports come from here:
``MeshExecutor`` (``parallel/dist.py``), ``data_mesh``, ``device_count`` and
``training_mesh`` (``parallel/mesh.py``), the multi-process functions
(``parallel/multihost.py``), and the device pool's ``pool_devices`` and
``pool_enabled`` (``ops/device_pool.py``).
"""

from ..ops.device_pool import enabled as pool_enabled, pool_devices
from .dist import MeshExecutor
from .mesh import data_mesh, device_count, training_mesh
from .multihost import (
    frame_from_process_local,
    initialize,
    process_count,
    process_index,
)

__all__ = [
    "MeshExecutor",
    "data_mesh",
    "device_count",
    "training_mesh",
    "initialize",
    "frame_from_process_local",
    "process_count",
    "process_index",
    "pool_devices",
    "pool_enabled",
]
