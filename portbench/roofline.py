"""The least time a kernel launch could take on one NVIDIA H100 SXM.

Published peaks (NVIDIA's data sheet, SXM part, dense, at the 700 W
limit): HBM3 at 3.35 TB/s; 989 TFLOP/s in bf16 (int8 and int4 codes are
scored as bf16 products by the port's bodies), 1,979 TOP/s in int8
products, 67 TFLOP/s in float32 outside the tensor cores. Each input
byte is counted once and each output byte once, whatever a kernel reads
again. The least time is the larger of the bytes over the HBM rate and
the operations over the product rate; the functions return it with the
name of the bound.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 989e12,
              "int4": 989e12}
#: product rate by query type (the block scan's s8 products)
PEAK_QOPS_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
#: bytes a stored row element takes, by slab type
ROW_BYTES = {"float32": 4.0, "bfloat16": 2.0, "int8": 1.0, "int4": 0.5}
#: bytes of a query element in the kernel, by query type
Q_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def _bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flat_search_s(slab: str, n: int, d: int, b: int, k: int
                  ) -> tuple[float, str]:
    """K1 / K2 and their merge, as one search: the slab, its validity
    flags and (quantized slabs) scales, the queries, the (B, k) results
    (float32 score and int64 row). ``chip_smoke.py``'s ``_bound_ms``."""
    nbytes = n * (ROW_BYTES[slab] * d + 1)
    if slab in ("int8", "int4"):
        nbytes += 4 * n
    nbytes += b * d * (4 if slab == "float32" else 2) + b * k * 12
    return _bound(nbytes, 2.0 * b * n * d, PEAK_OPS_S[slab])


def flat_stage1_s(slab: str, n_valid: int, d: int, b: int, k: int,
                  parts: int) -> tuple[float, str]:
    """K1 / K2 stage 1 alone: the valid rows (row bytes and validity
    flag, scales for quantized slabs), the queries in the kernel's type,
    and the (B, parts, k) partials written (float32 score, int32 row)."""
    nbytes = n_valid * (ROW_BYTES[slab] * d + 1)
    if slab in ("int8", "int4"):
        nbytes += 4 * n_valid
    nbytes += b * d * (4 if slab == "float32" else 2) + b * parts * k * 8
    return _bound(nbytes, 2.0 * b * n_valid * d, PEAK_OPS_S[slab])


def block_scan_s(slab: str, qtype: str, live: int, c: int, d: int, b: int,
                 k: int, u: int) -> tuple[float, str]:
    """K3 / K4 over ``live`` blocks of ``c`` rows: the blocks' rows,
    flags and scales, the ``u`` block-list entries, the queries and the
    (B, k) results. ``chip_smoke.py``'s ``_block_bound_ms``."""
    quant = slab in ("int8", "int4")
    nbytes = live * c * (ROW_BYTES[slab] * d + 1 + (4 if quant else 0))
    nbytes += 8 * u + b * d * Q_BYTES[qtype] + b * k * 8
    return _bound(nbytes, 2.0 * b * live * c * d, PEAK_QOPS_S[qtype])
