"""Per-row int8 and packed int4 quantization of embedding slabs.

Torch port of the non-Pallas parts of ``wdbx_tpu/kernels/quant.py``.
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
