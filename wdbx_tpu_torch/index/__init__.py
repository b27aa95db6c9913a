"""Device-resident vector indexes (torch tensors on the CUDA device).

The flat, clustered and dense IVF engines are ported; ``create_index``
raises ``NotImplementedError`` for the sharded engines."""

from wdbx_tpu_torch.index.base import VectorIndex, create_index
from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex
from wdbx_tpu_torch.index.flat import FlatIndex
from wdbx_tpu_torch.index.ivf import IVFIndex

__all__ = ["VectorIndex", "FlatIndex", "IVFIndex", "ClusteredIVFIndex",
           "create_index"]
