"""IVF bucket scan + top-k (K5): the CUDA kernels' wrappers and their
plain PyTorch versions.

Port of ``wdbx_tpu/kernels/ivf_scan.py`` (its Pallas body ``_kernel``).
For S (query, probe) pairs, each pair scores its query row against one
``(C, d)`` bucket of a dense ``(nlist, C, d)`` table, masks the bucket's
invalid rows and keeps its exact top-k. The kernels are hand-written
CUDA C++ for Hopper in ``csrc/ivf_scan.cu`` (its header gives the bound
on the card and the design). Stage 1 has two bodies, picked from the
shapes by ``pick_body``:

  * ``grouped`` (rows of whole 16-byte chunks, a 16-byte aligned table):
    ``group_pairs`` sorts the pairs by bucket on the card into items of
    at most ``group_size`` pairs of one bucket; then each probed bucket's
    valid rows are read once per item and scored against all its pairs,
    in ``plan_grouped``'s parts of whole 32-row groups, by a grid of the
    resident warps;
  * ``pair`` (every other width, unaligned views): the first port, one
    CTA per (pair, row split), each pair reading its bucket itself.

Stage 2 is the fused scan's ``topk_merge_partials`` with S in the place
of B. On a CUDA tensor ``ivf_bucket_scan`` launches the kernels or
raises; on a CPU tensor it runs ``ivf_bucket_scan_plain`` (gather each
pair's bucket and query, float32 products of the table-typed operands,
mask, ``torch.topk``), which the CPU tests use. ``group_pairs_plain`` is
the grouping's plain version.

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
#: stage-1 bodies (see the module docstring)
BODIES = ("grouped", "pair")
#: the grouped body's shared memory, mirrored from csrc/ivf_scan.cu: a
#: warp's cp.async ring (3 tiles of 32 rows x 144 bytes) and group masks,
#: then per pair of its item the query as float32, its id, count and
#: threshold and a candidate buffer of _cap(k) entries
_RING_BYTES = 3 * 32 * 144 + 64 * 4
_MAX_ITEM = 8  # pairs an item may hold (the kernel's registers)
_MAX_GROUPS = 64  # 32-row groups a part may hold
_CTA_WARPS = 4
#: bytes of a warp that keep 12 warps resident on a 228 KB SM (3 CTAs)
_WARP_BUDGET = 18 * 1024
_SMEM_MAX = 227 * 1024  # shared memory one CTA may take
#: (item, part) units the plan aims at per resident warp: more balance
#: the tail, fewer keep the merge shallow and the per-unit set-up rare
UNITS_PER_WARP = 8


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


def _pair_bytes(d: int, k: int) -> int:
    return 12 + 4 * d + 8 * _ft._cap(k)


def _warp_bytes(d: int, k: int, g: int) -> int:
    return -(-(_RING_BYTES + g * _pair_bytes(d, k)) // 16) * 16


def pick_body(key: str, d: int, rows_ptr: int) -> str:
    """The stage-1 body for a ``key`` table of width ``d`` at address
    ``rows_ptr``: ``grouped`` when its rows are whole 16-byte chunks, the
    table is 16-byte aligned and one pair's query and buffer fit a warp's
    share of shared memory; ``pair`` otherwise."""
    es = 4 if key == "float32" else 2
    fits = _CTA_WARPS * _warp_bytes(d, K_MAX, 1) <= _SMEM_MAX
    return ("grouped" if (d * es) % 16 == 0 and rows_ptr % 16 == 0 and fits
            else "pair")


def group_size(d: int, k: int) -> int:
    """Pairs of one bucket an item of the grouped body holds: as many as
    fit the warp budget beside the ring (at least 1, at most 8)."""
    return max(1, min(_MAX_ITEM,
                      (_WARP_BUDGET - _RING_BYTES) // _pair_bytes(d, k)))


def plan_grouped(s: int, c: int, warps: int) -> tuple[int, int]:
    """The grouped body's ``(parts, rows_per_part)``: each bucket cut into
    parts of whole 32-row groups (at most 64 a part), about
    ``UNITS_PER_WARP`` (item, part) units per resident warp if every pair
    were its own item."""
    groups = -(-c // 32)
    parts = -(-UNITS_PER_WARP * max(1, warps) // max(1, s))
    parts = max(-(-groups // _MAX_GROUPS), min(groups, parts))
    rows = -(-groups // parts) * 32
    return -(-c // rows), rows


def group_pairs_plain(probes: torch.Tensor, qidx: torch.Tensor, nlist: int,
                      b: int, g: int):
    """Plain version of the grouping: ``(order, items, n_items)`` with
    ``order`` (S,) int32 the pair ids stably sorted by bucket (pairs whose
    probe or query id is out of range last, as bucket -1) and ``items``
    (n_items, 3) int32 rows of (bucket or -1, first position in
    ``order``, pair count <= g), in bucket order."""
    probes, qidx = probes.to(torch.int64), qidx.to(torch.int64)
    ok = (probes >= 0) & (probes < nlist) & (qidx >= 0) & (qidx < b)
    key = torch.where(ok, probes, nlist)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=nlist + 1)
    per = (counts + g - 1) // g  # items of each bin
    bins = torch.repeat_interleave(torch.arange(nlist + 1,
                                                device=key.device), per)
    nth = torch.arange(bins.shape[0], device=key.device) - \
        (torch.cumsum(per, 0) - per)[bins]
    start = (torch.cumsum(counts, 0) - counts)[bins] + nth * g
    count = torch.clamp(counts[bins] - nth * g, max=g)
    bucket = torch.where(bins < nlist, bins, -1)
    items = torch.stack([bucket, start, count], 1).to(torch.int32)
    return order.to(torch.int32), items, int(items.shape[0])


def group_pairs(probes: torch.Tensor, qidx: torch.Tensor, nlist: int,
                b: int, g: int):
    """Stage 0 on the card: ``(order, items, n_items)`` as
    ``group_pairs_plain`` gives them, but ``items`` is the (S, 3) buffer
    of which the first ``n_items`` rows are written, ``n_items`` a (2,)
    int32 tensor (the item count, then stage 1's zeroed unit counter)
    that stays on the card, and the order of pair ids within one bucket
    is the kernel's (atomics): no host synchronisation. The grouped body
    launches this kernel itself, from its C entry point."""
    from wdbx_tpu_torch.kernels import build

    s = probes.shape[0]
    if not (probes.is_cuda and qidx.is_cuda):
        raise ValueError("group_pairs takes CUDA tensors")
    if probes.dtype != torch.int32 or qidx.dtype != torch.int32 or \
            probes.shape != (s,) or qidx.shape != (s,) or s < 1:
        raise ValueError("group_pairs takes matching (S,) int32 ids")
    probes, qidx = probes.contiguous(), qidx.contiguous()
    ws = torch.empty((4 * s + 2,), dtype=torch.int32, device=probes.device)
    lib = build.load("ivf_scan")
    ptr = ws.data_ptr()
    with _ft._on(probes):
        rc = lib.wdbx_ivf_group_pairs(
            probes.data_ptr(), qidx.data_ptr(), nlist, b, s, g, ptr,
            ptr + 4 * s, ptr + 16 * s, _ft._stream(probes))
    if rc != 0:
        raise RuntimeError(f"group_pairs launch failed: CUDA error {rc}")
    group_pairs.launches += 1
    return ws[:s], ws[s:4 * s].view(s, 3), ws[4 * s:]


group_pairs.launches = 0
_warps: dict[tuple, int] = {}  # resident warps by (card, table, d, k, g)


def ivf_bucket_partial(
    bucket_rows: torch.Tensor,
    valid: torch.Tensor,
    probes: torch.Tensor,
    qidx: torch.Tensor,
    qq: torch.Tensor,
    k: int,
    body: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 on the card: ``(S, parts, k)`` float32 scores and int32
    bucket-local positions, each part's k best of its rows (unsorted;
    -inf / -1 pads). ``qq`` (B, d) has the table's type; ``valid`` is the
    ``(nlist, C)`` bool table. ``body`` names the stage-1 body
    (``BODIES``) instead of ``pick_body``'s, for timing one against the
    other; the C entry points refuse a body the arguments break."""
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
    if body is None:
        body = pick_body(key, d, rows.data_ptr())
    elif body not in BODIES:
        raise ValueError(f"no stage-1 body {body!r}")
    lib = build.load("ivf_scan")
    cap = _ft._cap(k)
    if body == "grouped":
        g = group_size(d, k)
        wkey = (rows.device.index, key, d, k, g)
        if wkey not in _warps:
            with _ft._on(rows):
                _warps[wkey] = lib.wdbx_ivf_grouped_warps(
                    TABLE_CODES[key], d, cap, g)
        parts, rps = plan_grouped(s, c, _warps[wkey])
    else:
        sm = torch.cuda.get_device_properties(
            rows.device).multi_processor_count
        splits, rps = plan(s, c, sm)
        parts = splits * lib.wdbx_ivf_bucket_partial_warps()
    part_v = torch.empty((s, parts, k), dtype=torch.float32,
                         device=rows.device)
    part_i = torch.empty((s, parts, k), dtype=torch.int32, device=rows.device)
    if body == "grouped":  # stage 0 (group_pairs) and stage 1 in one call
        ws = torch.empty((4 * s + 2,), dtype=torch.int32, device=rows.device)
        with _ft._on(rows):
            rc = lib.wdbx_ivf_grouped_scan(
                TABLE_CODES[key], rows.data_ptr(), valid.data_ptr(),
                probes.data_ptr(), qidx.data_ptr(), qq.data_ptr(), nlist, c,
                d, b, s, k, cap, g, parts, rps, ws.data_ptr(),
                part_v.data_ptr(), part_i.data_ptr(), _ft._stream(rows),
            )
        if rc == 0:
            group_pairs.launches += 1
    else:
        with _ft._on(rows):
            rc = lib.wdbx_ivf_bucket_partial(
                TABLE_CODES[key], rows.data_ptr(), valid.data_ptr(),
                probes.data_ptr(), qidx.data_ptr(), qq.data_ptr(), nlist, c,
                d, b, s, k, cap, splits, rps, part_v.data_ptr(),
                part_i.data_ptr(), _ft._stream(rows),
            )
    if rc != 0:
        raise RuntimeError(f"ivf_bucket_partial[{key}] ({body}) launch "
                           f"failed: CUDA error {rc}")
    ivf_bucket_partial.launches[key] += 1
    ivf_bucket_partial.bodies[body] += 1
    return part_v, part_i


ivf_bucket_partial.launches = {key: 0 for key in TABLE_CODES}
#: launches by stage-1 body
ivf_bucket_partial.bodies = {body: 0 for body in BODIES}


def reset_launches() -> None:
    for counts in (ivf_bucket_partial.launches, ivf_bucket_partial.bodies):
        for key in counts:
            counts[key] = 0
    group_pairs.launches = 0


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
