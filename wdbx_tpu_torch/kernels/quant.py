"""Per-row int8 and packed int4 quantization of embedding slabs.

Torch port of the non-Pallas parts of ``wdbx_tpu/kernels/quant.py``
and of its query-side prep for the clustered block scan.
The codes are bit-identical to the JAX package's: both round half to
even, and the int4 packing keeps the same layout — byte j of a row
holds dim j in the LOW nibble and dim j + d/2 in the HIGH nibble, as
offset-8 codes in [1, 15].
"""

from __future__ import annotations

import torch


def _recip(c: float) -> torch.Tensor:
    """float32 reciprocal of a constant. XLA rewrites ``x / c`` into
    ``x * (1/c)``, so the JAX package's scales are products with it;
    multiplying by the same float32 value keeps them bit-identical."""
    return torch.tensor(1.0 / c, dtype=torch.float32)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(N, d) float -> (int8 codes, (N,) float32 scales)`` with
    ``scale = max|x| / 127`` and codes ``round(x / scale)``."""
    x = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x), dim=-1)
    scale = torch.clamp_min(absmax, 1e-12) * _recip(127.0)
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[:, None]


def int8_score(
    q_values: torch.Tensor,
    scales: torch.Tensor,
    queries: torch.Tensor,
    precision: str = "default",
) -> torch.Tensor:
    """``(B, N)`` scores against an int8 slab: bf16 queries times the
    int8 codes (exact in bf16), accumulated in float32, then scaled by
    each row's scale."""
    del precision  # int8 x bf16 products are exact at any precision
    q = queries.to(torch.bfloat16).to(torch.float32)
    s = q @ q_values.to(torch.float32).T
    return s * scales[None, :]


def quantize_rows_int4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(N, d) float -> ((N, d//2) uint8 packed codes, (N,) scales)``
    with ``scale = max|x| / 7``."""
    x = x.to(torch.float32)
    d = x.shape[1]
    absmax = torch.amax(torch.abs(x), dim=-1)
    scale = torch.clamp_min(absmax, 1e-12) * _recip(7.0)
    q = torch.clamp(torch.round(x / scale[:, None]), -7, 7) + 8.0
    q = q.to(torch.uint8)
    lo, hi = q[:, : d // 2], q[:, d // 2:]
    return lo | (hi << 4), scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """``(..., d//2) uint8 -> (..., d) int8`` codes in [-7, 7]."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=-1)


def dequantize_rows_int4(
    packed: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    return unpack_int4(packed).to(torch.float32) * scale[:, None]


def prep_query_block(
    q: torch.Tensor, slab_dtype: torch.dtype, int8: bool, qprec: str,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Query-side prep of the clustered block scan (K3): validates
    ``qprec`` and picks the query representation against the slab.
    Returns ``(qq, qs, b)``; ``qs`` is ``(B, 1)`` float32.

    - an int8 / int4 slab (``int8=True``) with ``qprec="bf16"``: bf16
      queries, ``qs`` zeros (no query dequant);
    - with ``qprec="int8"``: symmetric per-query quantization, scale
      ``max|q| / 127`` (1e-20 floor), codes ``round(q / scale)`` in
      [-127, 127], bit-identical to the JAX package's;
    - a float slab: queries in the slab's type, ``qs`` zeros.

    Unlike the JAX version, batches under 32 rows are not padded (that
    was the TPU's int8 sublane tile), so ``b`` is always the batch."""
    qprec = str(qprec).lower()
    if qprec not in ("bf16", "int8"):
        raise ValueError(f"qprec must be 'bf16' or 'int8', got {qprec!r}")
    b = q.shape[0]
    if int8 and qprec == "int8":
        qf = q.to(torch.float32)
        qmax = torch.clamp_min(torch.amax(torch.abs(qf), dim=1, keepdim=True),
                               1e-20)
        qs = qmax * _recip(127.0)
        qq = torch.clamp(torch.round(qf / qs), -127, 127).to(torch.int8)
        return qq, qs, b
    qs = torch.zeros((b, 1), dtype=torch.float32, device=q.device)
    return q.to(torch.bfloat16 if int8 else slab_dtype), qs, b
