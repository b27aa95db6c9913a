"""IVF bucket scan + top-k (K5): the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``wdbx_tpu/kernels/ivf_scan.py`` (its Pallas body ``_kernel``).
For S (query, probe) pairs, each pair scores its query row against one
``(C, d)`` bucket of a dense ``(nlist, C, d)`` table, masks the bucket's
invalid rows and keeps its exact top-k. The kernel is hand-written CUDA
C++ for Hopper in ``csrc/ivf_scan.cu`` (its header gives the bound on
the card and the design): stage 1 (``ivf_bucket_partial``) scores row
splits of each pair's bucket with per-warp top-k buffers, stage 2 is the
fused scan's ``topk_merge_partials`` with S in the place of B.

On a CUDA tensor ``ivf_bucket_scan`` launches the kernels or raises; on
a CPU tensor it runs ``ivf_bucket_scan_plain`` (gather each pair's
bucket and query, float32 products of the table-typed operands, mask,
``torch.topk``), which the CPU tests use.

Differences from the JAX kernel, all deliberate:
  * the validity table is ``(nlist, C)`` bool; JAX's 8x-replicated
    ``(nlist, 8, C)`` int8 table (a Mosaic block-shape workaround) is
    accepted too, and its first copy read;
  * ranks past a bucket's valid count are -inf / -1 (JAX: its ``NEG``
    sentinel, with whatever position its argmax picked);
  * positions come back int64 (JAX: int32);
  * ``interpret`` is accepted for the JAX signature and ignored.
"""

from __future__ import annotations

import torch

from wdbx_tpu_torch.kernels import fused_topk as _ft
from wdbx_tpu_torch.ops.exact_search import true_f32

#: deepest k the kernel serves (the TPU kernel's 128 result lanes)
K_MAX = 128
#: CUDA kernel code of each table type
TABLE_CODES = {"float32": 0, "bfloat16": 1}
_TABLES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_PLAIN_PAIRS = 256  # pairs the plain version scores at once


def table_key(bucket_rows: torch.Tensor) -> str:
    if bucket_rows.dtype not in _TABLES:
        raise TypeError(
            f"ivf_bucket_scan requires a float bucket table, got "
            f"{bucket_rows.dtype} (int8 tables must use the lax path)"
        )
    return _TABLES[bucket_rows.dtype]


def _check_k(k: int) -> None:
    if not 1 <= k <= K_MAX:
        raise ValueError(
            f"ivf_bucket_scan supports k <= {K_MAX}, got {k} "
            "(route deeper fetches to the lax scan)"
        )


def _valid2d(bucket_valid: torch.Tensor) -> torch.Tensor:
    """The ``(nlist, C)`` bool table of a ``(nlist, C)`` or replicated
    ``(nlist, 8, C)`` validity table."""
    if bucket_valid.ndim == 3:
        bucket_valid = bucket_valid[:, 0, :]
    return bucket_valid != 0


def plan(s: int, c: int, sm_count: int) -> tuple[int, int]:
    """Stage-1 grid ``(splits, rows_per_split)``: each pair's bucket cut
    into splits of whole 32-row groups, so that the grid holds about
    four CTAs per SM whatever the pair count is."""
    groups = -(-c // 32)
    splits = max(1, min(groups, -(-4 * sm_count // max(1, s))))
    rows = -(-groups // splits) * 32
    return -(-c // rows), rows


def ivf_bucket_partial(
    bucket_rows: torch.Tensor,
    valid: torch.Tensor,
    probes: torch.Tensor,
    qidx: torch.Tensor,
    qq: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 on the card: ``(S, splits * warps, k)`` float32 scores and
    int32 bucket-local positions, each warp's k best of its rows (unsorted;
    -inf / -1 pads). ``qq`` (B, d) has the table's type; ``valid`` is the
    ``(nlist, C)`` bool table."""
    from wdbx_tpu_torch.kernels import build

    key = table_key(bucket_rows)
    _check_k(k)
    nlist, c, d = bucket_rows.shape
    s, b = probes.shape[0], qq.shape[0]
    tensors = (bucket_rows, valid, probes, qidx, qq)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("ivf_bucket_partial takes CUDA tensors")
    if qq.dtype != bucket_rows.dtype or qq.ndim != 2 or qq.shape[1] != d \
            or valid.shape != (nlist, c) or valid.dtype != torch.bool \
            or probes.shape != (s,) or qidx.shape != (s,) or s < 1 or b < 1:
        raise ValueError(
            f"shape mismatch: table {tuple(bucket_rows.shape)} "
            f"{bucket_rows.dtype}, queries {tuple(qq.shape)} {qq.dtype}, "
            f"valid {tuple(valid.shape)}, probes {tuple(probes.shape)}, "
            f"qidx {tuple(qidx.shape)}"
        )
    rows, valid, qq = (bucket_rows.contiguous(), valid.contiguous(),
                       qq.contiguous())
    probes = probes.to(torch.int32).contiguous()
    qidx = qidx.to(torch.int32).contiguous()
    lib = build.load("ivf_scan")
    sm = torch.cuda.get_device_properties(rows.device).multi_processor_count
    splits, rps = plan(s, c, sm)
    parts = splits * lib.wdbx_ivf_bucket_partial_warps()
    part_v = torch.empty((s, parts, k), dtype=torch.float32,
                         device=rows.device)
    part_i = torch.empty((s, parts, k), dtype=torch.int32, device=rows.device)
    with torch.cuda.device(rows.device):
        rc = lib.wdbx_ivf_bucket_partial(
            TABLE_CODES[key], rows.data_ptr(), valid.data_ptr(),
            probes.data_ptr(), qidx.data_ptr(), qq.data_ptr(), nlist, c, d,
            b, s, k, _ft._cap(k), splits, rps, part_v.data_ptr(),
            part_i.data_ptr(), _ft._stream(rows),
        )
    if rc != 0:
        raise RuntimeError(f"ivf_bucket_partial[{key}] launch failed: "
                           f"CUDA error {rc}")
    ivf_bucket_partial.launches[key] += 1
    return part_v, part_i


ivf_bucket_partial.launches = {key: 0 for key in TABLE_CODES}


def reset_launches() -> None:
    for key in ivf_bucket_partial.launches:
        ivf_bucket_partial.launches[key] = 0


def ivf_bucket_scan_plain(
    bucket_rows: torch.Tensor,
    bucket_valid: torch.Tensor,
    probes: torch.Tensor,
    qidx: torch.Tensor,
    q: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's function: each pair's bucket
    and query row gathered, float32 products of the table-typed operands
    (exact for bf16), masked by the bucket's validity, ``torch.topk``.
    Returns sorted ``(S, k)`` float32 scores and int64 bucket-local
    positions, -inf / -1 past the valid count."""
    valid = _valid2d(bucket_valid)
    probes, qidx = probes.to(torch.int64), qidx.to(torch.int64)
    qf = q.to(bucket_rows.dtype).to(torch.float32)
    c = bucket_rows.shape[1]
    k_eff = min(k, c)
    vals, poss = [], []
    for lo in range(0, probes.shape[0], _PLAIN_PAIRS):
        p = probes[lo:lo + _PLAIN_PAIRS]
        rows = bucket_rows[p].to(torch.float32)  # (s, C, d)
        qs = qf[qidx[lo:lo + _PLAIN_PAIRS], :, None]
        with true_f32():
            s = torch.bmm(rows, qs)[..., 0]
        s = torch.where(valid[p], s, float("-inf"))
        v, i = torch.topk(s, k_eff, dim=-1)
        vals.append(v)
        poss.append(i)
    v = torch.cat(vals) if vals else torch.empty((0, k_eff), device=q.device)
    i = (torch.cat(poss) if poss
         else torch.empty((0, k_eff), dtype=torch.int64, device=q.device))
    if k_eff < k:
        v = torch.nn.functional.pad(v, (0, k - k_eff), value=float("-inf"))
        i = torch.nn.functional.pad(i, (0, k - k_eff), value=-1)
    return v, torch.where(v == float("-inf"), -1, i)


def ivf_bucket_scan(
    bucket_rows: torch.Tensor,
    bucket_valid: torch.Tensor,
    probes: torch.Tensor,
    qidx: torch.Tensor,
    q: torch.Tensor,
    k: int = 10,
    interpret: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5: per-(query, probe) exact top-k over one bucket each.

    ``bucket_rows`` (nlist, C, d) float32 or bf16 table; ``bucket_valid``
    (nlist, C) bool or (nlist, 8, C) replicated; ``probes`` / ``qidx``
    (S,) bucket ids and the query row of each pair; ``q`` (B, d), cast
    to the table's type. Returns ``(S, k)`` float32 scores, sorted, and
    int64 bucket-local positions, -inf / -1 past the valid count. Raises
    ``ValueError`` for k > 128 and ``TypeError`` for a table that is not
    float. ``interpret`` is accepted for the JAX signature and ignored."""
    del interpret
    _check_k(k)
    table_key(bucket_rows)
    if not bucket_rows.is_cuda:
        return ivf_bucket_scan_plain(bucket_rows, bucket_valid, probes, qidx,
                                     q, k)
    if probes.shape[0] == 0:  # nothing to launch
        return (torch.empty((0, k), dtype=torch.float32,
                            device=bucket_rows.device),
                torch.empty((0, k), dtype=torch.int64,
                            device=bucket_rows.device))
    part_v, part_i = ivf_bucket_partial(
        bucket_rows, _valid2d(bucket_valid), probes, qidx,
        q.to(bucket_rows.dtype), k,
    )
    return _ft.topk_merge_partials(part_v, part_i, k)
