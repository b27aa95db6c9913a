"""L2 normalization (torch port of ``wdbx_tpu/ops/normalize.py``)."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize the last axis to unit L2 norm, in float32.

    Zero vectors are returned unchanged: the squared norm is clamped at
    ``eps**2`` before the reciprocal square root.
    """
    x = x.to(torch.float32)
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp_min(sq, eps * eps))
