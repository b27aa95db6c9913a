"""Device-resident vector indexes (torch tensors on the CUDA device).

The flat, clustered and dense IVF engines, and (from
``wdbx_tpu_torch.parallel``) the sharded flat, sharded IVF and sharded
clustered engines."""

from wdbx_tpu_torch.index.base import VectorIndex, create_index
from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex
from wdbx_tpu_torch.index.flat import FlatIndex
from wdbx_tpu_torch.index.ivf import IVFIndex

__all__ = ["VectorIndex", "FlatIndex", "IVFIndex", "ClusteredIVFIndex",
           "ShardedFlatIndex", "ShardedIVFIndex", "ShardedClusteredIndex",
           "create_index"]


def __getattr__(name):  # lazy: the parallel package imports this one
    if name in ("ShardedFlatIndex", "ShardedIVFIndex",
                "ShardedClusteredIndex"):
        import wdbx_tpu_torch.parallel as parallel

        return getattr(parallel, name)
    raise AttributeError(
        f"module 'wdbx_tpu_torch.index' has no attribute {name!r}")
