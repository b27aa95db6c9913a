"""Exact (brute-force) similarity search: one matmul + ``torch.topk``.

Torch port of ``wdbx_tpu/ops/exact_search.py``. It is the recall oracle
and the engine's path off the CUDA device. ``method="approx"`` (JAX's
``lax.approx_max_k``) is served by the exact ``torch.topk``: a
deliberate difference, since the approximation was a TPU speed trick.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from wdbx_tpu_torch.ops.normalize import l2_normalize


def exact_search(
    db: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    valid: torch.Tensor | None = None,
    precision: str = "highest",
    scales: torch.Tensor | None = None,
    method: str = "exact",
    normalize: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner-product search of ``queries`` (B, d) against ``db``
    (N, d), a float32, bfloat16 or int8 slab (int8 needs per-row
    ``scales``). Invalid rows (``valid`` False) score ``-inf``.

    Returns ``(scores, indices)`` of shape ``(B, k)``: float32 scores
    and int64 row indices; ranks past the row count are ``-inf`` / -1.
    """
    del method  # "approx" and "exact" both select exactly here
    if normalize:
        queries = l2_normalize(queries)
    if db.dtype == torch.int8:
        from wdbx_tpu_torch.kernels.quant import int8_score

        scores = int8_score(db, scales, queries, precision=precision)
    else:
        scores = score_block(db, queries, precision=precision)
    if valid is not None:
        scores = torch.where(valid[None, :], scores, float("-inf"))
    k_eff = min(k, db.shape[0])
    top_scores, top_idx = torch.topk(scores, k_eff, dim=-1)
    top_idx = top_idx.to(torch.int64)
    if k_eff < k:
        pad = k - k_eff
        top_scores = torch.nn.functional.pad(
            top_scores, (0, pad), value=float("-inf")
        )
        top_idx = torch.nn.functional.pad(top_idx, (0, pad), value=-1)
    return top_scores, top_idx


def score_block(
    db: torch.Tensor, queries: torch.Tensor, precision: str = "highest"
) -> torch.Tensor:
    """``(B, N)`` inner products with float32 accumulation.

    Queries are cast to the slab's float type first (as the JAX
    version does), then both operands widen to float32: the products
    of bf16 values are exact there, so this is the bf16 x bf16 -> f32
    product of the JAX path. ``precision="highest"`` is true float32;
    any other precision follows the process's TF32 setting.
    """
    if db.dtype != queries.dtype and db.is_floating_point():
        queries = queries.to(db.dtype)
    q, rows = queries.to(torch.float32), db.to(torch.float32)
    if precision == "highest":
        return f32_scores(q, rows)
    return q @ rows.T


@contextmanager
def true_f32():
    """Float32 products inside the block run in true float32: TF32 is
    switched off for the CUDA device and the caller's setting restored,
    so precision never depends on earlier calls."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def f32_scores(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``queries @ rows.T`` in true float32 (see ``true_f32``)."""
    with true_f32():
        return queries @ rows.T
