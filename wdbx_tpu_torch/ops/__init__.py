"""Device compute primitives (torch) for the vector engine."""

from wdbx_tpu_torch.ops.normalize import l2_normalize
from wdbx_tpu_torch.ops.exact_search import exact_search, score_block
from wdbx_tpu_torch.ops.topk import topk_merge
from wdbx_tpu_torch.ops.kmeans import kmeans

__all__ = ["l2_normalize", "exact_search", "score_block", "topk_merge", "kmeans"]
