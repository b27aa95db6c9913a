"""Top-k merge across shards / blocks (torch port of
``wdbx_tpu/ops/topk.py``)."""

from __future__ import annotations

import torch


def topk_merge(
    scores: torch.Tensor, ids: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge ``(B, C)`` candidate scores and aligned ids into ``(B, k)``.

    ``-inf`` scores mark absent candidates. When ``C < k`` the output is
    padded with ``-inf`` scores and ``-1`` ids. Ids come back int64.
    """
    c = scores.shape[-1]
    k_eff = min(k, c)
    top_scores, pos = torch.topk(scores, k_eff, dim=-1)
    top_ids = torch.gather(ids.to(torch.int64), -1, pos)
    if k_eff < k:
        pad = k - k_eff
        top_scores = torch.nn.functional.pad(
            top_scores, (0, pad), value=float("-inf")
        )
        top_ids = torch.nn.functional.pad(top_ids, (0, pad), value=-1)
    return top_scores, top_ids
