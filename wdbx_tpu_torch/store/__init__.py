from wdbx_tpu_torch.store.filters import build_slot_mask, matches_filter
from wdbx_tpu_torch.store.vector_store import VectorStore

__all__ = ["VectorStore", "matches_filter", "build_slot_mask"]
