"""Multi-device layer: mesh construction, device-sharded indexes, and the
shard control plane.

Torch port of ``wdbx_tpu/parallel``. A mesh is one process's ordered list
of torch devices (a device may hold several positions); each shard runs
its own kernel launch on its position and one merge joins them, where
the JAX package runs one ``shard_map`` with an ``all_gather``.
``torch.distributed`` only joins hosts (``ShardEngine.initialize``).
"""

from wdbx_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh2
from wdbx_tpu_torch.parallel.shard_engine import ShardEngine
from wdbx_tpu_torch.parallel.sharded_clustered import ShardedClusteredIndex
from wdbx_tpu_torch.parallel.sharded_flat import ShardedFlatIndex
from wdbx_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

__all__ = [
    "Mesh", "make_mesh", "make_mesh2", "ShardedFlatIndex", "ShardedIVFIndex",
    "ShardedClusteredIndex", "ShardEngine",
]
