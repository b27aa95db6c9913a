"""Multi-device layer: mesh construction, device-sharded indexes, and the
shard control plane.

Torch port of ``wdbx_tpu/parallel``. A mesh is an ordered list of torch
devices (a device may hold several positions); each shard runs its own
kernel launch on its position and one merge joins them, where the JAX
package runs one ``shard_map`` with an ``all_gather``. Once
``ShardEngine.initialize`` has joined a ``torch.distributed`` group, the
default mesh spans its ranks: each rank launches its own shards, and the
ranks' merged top-ks cross through ``collective``.
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
