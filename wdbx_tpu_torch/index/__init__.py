"""Device-resident vector indexes (torch tensors on the CUDA device).

Only the flat engine is ported so far; ``create_index`` raises
``NotImplementedError`` for the clustered, IVF and sharded engines."""

from wdbx_tpu_torch.index.base import VectorIndex, create_index
from wdbx_tpu_torch.index.flat import FlatIndex

__all__ = ["VectorIndex", "FlatIndex", "create_index"]
