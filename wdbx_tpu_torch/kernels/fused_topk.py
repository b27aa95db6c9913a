"""Fused score + top-k over a device slab: the CUDA kernels' wrappers
and their plain PyTorch version.

Port of ``wdbx_tpu/kernels/fused_topk.py`` (its Pallas bodies ``_kernel``
and ``_kernel_int8``). The kernels are hand-written CUDA C++ for Hopper
in ``csrc/fused_topk.cu``; that file's header gives the bound on the
card and the design. In short: stage 1 (``fused_topk_partial``) streams
row chunks in parallel CTAs and keeps each query's k best per chunk,
stage 2 (``topk_merge_partials``) merges the chunks into the sorted
``(B, k)`` result. Stage 1 runs one of four scan bodies, which
``pick_body`` picks from the shapes alone: the register-tiled float32
body for float32 slabs with ``d % 4 == 0`` and 16-byte aligned slab and
queries; the pipelined tensor-core body for bf16, int8 and packed int4
slabs with ``d % 32 == 0``, aligned operands and candidate buffers that
fit for k; the first tensor-core body for the tensor-core launches whose
buffers fit no query tile (k = 128 / 1024 at d = 384); the CUDA-core
body otherwise. ``fused_topk_partial(..., body=...)`` reaches
any body whose rule the arguments meet, for timing one against
another.

On a CUDA tensor the wrappers launch the kernels or raise; on a CPU
tensor they run the plain version (``fused_topk_plain``: matmul, scale,
mask, ``torch.topk``), which the CPU tests use. There is no fallback
from the kernel to the plain version.

Differences from the JAX kernel, all deliberate:
  * selection is exact: ``group`` (the grouped approximate pre-reduction)
    and ``block_n`` (the VMEM tile) are accepted and ignored;
  * k is capped at ``K_MAX`` (the JAX kernel has no cap);
  * indices come back int64 with -1 (and scores -inf) where fewer than
    k rows are valid; JAX leaves the index of an invalid rank undefined.
"""

from __future__ import annotations

import contextlib
import math

import torch

from wdbx_tpu_torch.ops.exact_search import f32_scores
from wdbx_tpu_torch.ops.normalize import l2_normalize
from wdbx_tpu_torch.utils.metrics import span

#: deepest k the kernels serve (filtered search asks max(4*limit, 50),
#: the int4 rerank 20*limit)
K_MAX = 1024
#: CUDA kernel code of each slab type
SLAB_CODES = {"float32": 0, "bfloat16": 1, "int8": 2, "int4": 3}
_ROWS = 128  # rows_per_chunk granularity of the CUDA kernel (kRowsM)


def slab_key(db: torch.Tensor, int4: bool = False) -> str:
    if int4:
        return "int4"
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16",
             torch.int8: "int8"}
    if db.dtype not in names:
        raise ValueError(f"unsupported slab dtype {db.dtype}")
    return names[db.dtype]


def _check_k(k: int) -> None:
    if not 1 <= k <= K_MAX:
        raise ValueError(
            f"fused top-k serves 1 <= k <= K_MAX={K_MAX}, got k={k}"
        )


def _cap(k: int) -> int:
    """Per-query candidate buffer: k survivors plus room for one tile's
    offers (the kernels need cap >= k + 32)."""
    return k + 64


#: stage-1 scan bodies of ``csrc/topk_common.cuh``, by their C code
BODY_CODES = {"fma": 0, "mma": 1, "fma_tiled": 2, "mma_pipe": 3}
#: query tiles of the pipelined tensor-core body (its CTA writes 128 / qt
#: parts a query), and the shared memory its resident queries may take:
#: bf16 queries 128 at d <= 384, 64 at d <= 768, 32 at d <= 1536; int8
#: queries (1 byte a dim) 128 at d <= 768, 64 at d <= 1536, 32 at d <= 3072
PIPE_QT = (32, 64, 128)
PIPE_QUERY_BYTES = 96 * 1024
#: bytes a query element takes in the pipelined body's shared memory
QUERY_BYTES = {"bfloat16": 2, "int8": 1}
#: query tiles of the tiled float32 body, and the shared memory a CTA
#: may ask for (227 KB less the kernels' static arrays)
TILED_QT = (16, 32, 64, 128)
SMEM_MAX = 226 * 1024
_SM_SMEM = 228 * 1024  # shared memory of one SM


def scan_body(slab: str, qtype: str, d: int, db_ptr: int,
              q_ptr: int) -> str:
    """The stage-1 body a launch takes, from the slab and query types,
    the width and the operands' addresses, all with 16-byte aligned slab
    and queries: ``"fma_tiled"`` for float32 slabs with ``d % 4 == 0``;
    ``"mma_pipe"`` for bf16, int8 and packed int4 slabs with
    ``d % 32 == 0`` against bf16 queries (an int4 row's d/2 bytes are
    whole 16-byte chunks) or ``d % 64 == 0`` against int8 queries (int8 /
    int4 slabs: whole 32-byte k-steps of s8 products), when 32 queries
    of width d fit ``PIPE_QUERY_BYTES`` (d <= 1536 bf16, 3072 int8);
    ``"mma"`` for the wider tensor-core cases; ``"fma"`` otherwise
    (ragged widths, unaligned views). ``pipe_qt`` may still send a
    ``"mma_pipe"`` launch to ``"mma"`` when no query tile's buffers fit
    for its k. The C entry points refuse a body whose rule the arguments
    break."""
    aligned = db_ptr % 16 == 0 and q_ptr % 16 == 0
    if slab == "float32":
        return "fma_tiled" if d % 4 == 0 and aligned else "fma"
    width = 64 if qtype == "int8" else 32
    if d % width or not aligned:
        return "fma"
    if PIPE_QT[0] * d * QUERY_BYTES[qtype] <= PIPE_QUERY_BYTES:
        return "mma_pipe"
    return "mma"


def pipe_qt(b: int, k: int, d: int, partial_smem,
            qtype: str = "bfloat16") -> int | None:
    """Queries per CTA of the pipelined body: the smallest of
    ``PIPE_QT`` that holds the batch among those whose resident queries
    (``QUERY_BYTES[qtype]`` a dim) fit ``PIPE_QUERY_BYTES`` and whose
    128 candidate buffers fit beside them for this k
    (``partial_smem(qt, cap)``), else the largest that fits; None when
    none does (k beyond ~90 at d=384: the launch takes ``"mma"``)."""
    cap = _cap(k)
    fits = [qt for qt in PIPE_QT
            if qt * d * QUERY_BYTES[qtype] <= PIPE_QUERY_BYTES
            and partial_smem(qt, cap) <= SMEM_MAX]
    if not fits:
        return None
    return next((qt for qt in fits if qt >= b), fits[-1])


def tiled_qt(b: int, k: int, partial_smem) -> int:
    """Queries per CTA of the tiled body: the smallest tile that holds
    the batch among those whose candidate buffers fit beside the ring
    for this k (128 up to k ~45, then 64, 32, 16)."""
    cap = _cap(k)
    fits = [qt for qt in TILED_QT if partial_smem(qt, cap) <= SMEM_MAX]
    if not fits:
        raise ValueError(f"k={k} needs more shared memory than a CTA has")
    return next((qt for qt in fits if qt >= b), fits[-1])


def tiled_cap(qt: int, k: int, partial_smem) -> int:
    """Candidate buffer of the tiled body at ``qt`` queries per CTA:
    ``_cap(k)`` grown into the shared memory left beside the ring, up to
    128 entries (a cut of up to 128 keeps its keys in registers). More
    room means fewer cuts, and a cut in one warp holds the whole CTA at
    its next barrier."""
    cap = _cap(k)
    if cap >= 128:
        return cap
    base = partial_smem(qt, cap)
    per_entry = partial_smem(qt, cap + 1) - base
    return min(128, cap + max(0, (SMEM_MAX - base) // per_entry))


def whole_waves(qtiles: int, slots: int, need: int = 1) -> int:
    """Parts per query tile: at least ``need``, and such that
    ``qtiles * parts`` is a whole number of waves of ``slots`` CTAs."""
    per_wave = slots // math.gcd(qtiles, slots)
    return per_wave * max(1, -(-need // per_wave))


def cta_slots(sm_count: int, smem: int, per_sm: int = 2) -> int:
    """CTAs the card runs at once at ``smem`` bytes each (the SM's 228
    KB, 1 KB reserved a CTA; at most ``per_sm`` a SM for the registers:
    2 for the tiled body, 1 for the pipelined one)."""
    return sm_count * max(1, min(per_sm, _SM_SMEM // (smem + 1024)))


def plan(n: int, b: int, k: int, sm_count: int, partial_smem,
         body: str = "mma", d: int = 0,
         qtype: str = "bfloat16") -> tuple[int, int, int]:
    """Stage-1 tiling ``(qt, chunks, rows_per_chunk)``.

    The tiled float32 body (``body="fma_tiled"``, ``partial_smem`` its
    size): ``tiled_qt`` queries per CTA, and as many row chunks as make
    the grid one whole number of waves, so that every SM gets an equal
    share of long chunks (131 chunks of 63 tiles at 1M rows, B=128).
    The pipelined body (``body="mma_pipe"``, width ``d``, query type
    ``qtype``): the same with ``pipe_qt`` queries per CTA and one CTA a
    SM (131 chunks of 63 tiles at 1M x 384, B=128).
    The other bodies: 64 queries per CTA when their candidate buffers
    fit in shared memory beside the tiles (k up to ~140), else 16;
    enough row chunks for ~4 CTAs per SM. CTAs of one chunk are
    adjacent in the grid, so the query tiles of a large batch read each
    chunk while it is in L2."""
    cap = _cap(k)
    if body in ("fma_tiled", "mma_pipe"):
        pipe = body == "mma_pipe"
        qt = (pipe_qt(b, k, d, partial_smem, qtype) if pipe
              else tiled_qt(b, k, partial_smem))
        if qt is None:
            raise ValueError(f"k={k} at d={d} does not fit the pipelined body")
        qtiles = -(-b // qt)
        tiles = -(-n // _ROWS)
        smem = partial_smem(qt, tiled_cap(qt, k, partial_smem))
        parts = min(tiles, 65535, whole_waves(
            qtiles, cta_slots(sm_count, smem, 1 if pipe else 2)))
        rows = -(-tiles // parts) * _ROWS
        return qt, -(-n // rows), rows
    qt = 64 if partial_smem(64, cap) <= 160 * 1024 else 16
    if partial_smem(qt, cap) > 227 * 1024:
        raise ValueError(f"k={k} needs more shared memory than a CTA has")
    qtiles = -(-b // qt)
    max_chunks = min(-(-n // _ROWS), 65535)
    chunks = max(1, min(max_chunks, -(-4 * sm_count // qtiles)))
    rows = -(-n // chunks)
    rows = -(-rows // _ROWS) * _ROWS
    return qt, -(-n // rows), rows


def _stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream of ``t``'s card (the raw
    accessor where this PyTorch build has it: a launch's host cost)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


def _on(t: torch.Tensor):
    """The launch context for ``t``'s card: nothing to switch when it is
    the current one (the common case, and the cheap one)."""
    if t.device.index in (None, torch.cuda.current_device()):
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def pick_body(key: str, qtype: str, b: int, k: int, d: int, db_ptr: int,
              q_ptr: int, smem_of) -> str:
    """``scan_body``'s choice, with a ``"mma_pipe"`` launch whose buffers
    fit no query tile for this k (``pipe_qt``) sent to ``"mma"``.
    ``smem_of(code)`` gives the shared-memory function of a body code."""
    body = scan_body(key, qtype, d, db_ptr, q_ptr)
    if body == "mma_pipe" and pipe_qt(
            b, k, d, smem_of(BODY_CODES[body]), qtype) is None:
        return "mma"
    return body


def fused_topk_partial(
    db: torch.Tensor,
    queries: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    scales: torch.Tensor | None = None,
    int4: bool = False,
    body: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 on the card: ``(B, parts, k)`` float32 scores and int32
    row indices, each part's k best per query (unsorted; -inf / -1
    pads). ``queries`` must already have the kernel's type: float32 for
    a float32 slab, bf16 otherwise. ``body`` names the scan body
    (``BODY_CODES``) instead of the shape rule's (``pick_body``), for
    timing one body against another; the C entry point refuses a body
    whose rule the arguments break."""
    from wdbx_tpu_torch.kernels import build

    key = slab_key(db, int4)
    _check_k(k)
    n, b, d = db.shape[0], queries.shape[0], queries.shape[1]
    want_q = torch.float32 if key == "float32" else torch.bfloat16
    if not (db.is_cuda and queries.is_cuda and valid.is_cuda):
        raise ValueError("fused_topk_partial takes CUDA tensors")
    if queries.dtype != want_q or valid.dtype != torch.bool:
        raise ValueError(
            f"{key} slab needs {want_q} queries and a bool valid mask"
        )
    if db.shape[1] != (d // 2 if int4 else d) or valid.shape != (n,):
        raise ValueError(f"shape mismatch: db {tuple(db.shape)}, "
                         f"queries {tuple(queries.shape)}, "
                         f"valid {tuple(valid.shape)}")
    if n >= 2**31:
        raise ValueError("row indices are int32 in the kernel")
    if key in ("int8", "int4"):
        if scales is None or scales.dtype != torch.float32 or \
                scales.shape != (n,) or not scales.is_cuda:
            raise ValueError("int8/int4 slabs need (N,) float32 CUDA scales")
        scales = scales.contiguous()
    db, queries, valid = db.contiguous(), queries.contiguous(), valid.contiguous()
    lib = build.load("fused_topk")
    slab_code = SLAB_CODES[key]

    def smem_of(code):
        return lambda qt, cap: lib.wdbx_fused_topk_partial_smem(
            code, slab_code, qt, cap, d)

    if body is None:
        body = pick_body(key, "float32" if key == "float32" else "bfloat16",
                         b, k, d, db.data_ptr(), queries.data_ptr(), smem_of)
    elif body not in BODY_CODES:
        raise ValueError(f"no scan body {body!r}")
    code = BODY_CODES[body]
    smem = smem_of(code)
    sm = torch.cuda.get_device_properties(db.device).multi_processor_count
    qt, chunks, rows = plan(n, b, k, sm, smem, body, d)
    tiled = body in ("fma_tiled", "mma_pipe")
    cap = tiled_cap(qt, k, smem) if tiled else _cap(k)
    parts = chunks * (128 // qt if body == "mma_pipe" else 1)
    part_v = torch.empty((b, parts, k), dtype=torch.float32, device=db.device)
    part_i = torch.empty((b, parts, k), dtype=torch.int32, device=db.device)
    with span("kernel.k1", slab=key, body=body, n=n, b=b, d=d, k=k,
              parts=parts), _on(db):
        rc = lib.wdbx_fused_topk_partial(
            code, slab_code, qt, db.data_ptr(), queries.data_ptr(),
            valid.data_ptr(), scales.data_ptr() if scales is not None else None,
            n, d, b, k, cap, rows, chunks,
            part_v.data_ptr(), part_i.data_ptr(), _stream(db),
        )
    if rc != 0:
        raise RuntimeError(f"fused_topk_partial[{key}] ({body}) launch "
                           f"failed: CUDA error {rc}")
    fused_topk_partial.launches[key] += 1
    fused_topk_partial.bodies[body] += 1
    return part_v, part_i


fused_topk_partial.launches = {key: 0 for key in SLAB_CODES}
#: launches by scan body
fused_topk_partial.bodies = {body: 0 for body in BODY_CODES}


def topk_merge_partials(
    part_v: torch.Tensor, part_i: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 on the card: merge ``(B, chunks, k)`` partials into the
    sorted ``(B, k)`` float32 scores and int64 indices."""
    from wdbx_tpu_torch.kernels import build

    _check_k(k)
    if not (part_v.is_cuda and part_i.is_cuda):
        raise ValueError("topk_merge_partials takes CUDA tensors")
    if part_v.dtype != torch.float32 or part_i.dtype != torch.int32 or \
            part_v.shape != part_i.shape or part_v.ndim != 3:
        raise ValueError("partials must be matching (B, C, k) f32 / int32")
    b = part_v.shape[0]
    m = part_v.shape[1] * part_v.shape[2]
    part_v, part_i = part_v.contiguous(), part_i.contiguous()
    lib = build.load("fused_topk")
    out_v = part_v.new_empty((b, k))
    out_i = part_v.new_empty((b, k), dtype=torch.int64)
    with _on(part_v):
        rc = lib.wdbx_topk_merge_partials(
            part_v.data_ptr(), part_i.data_ptr(), b, m, k, _cap(k),
            out_v.data_ptr(), out_i.data_ptr(), _stream(part_v),
        )
    if rc != 0:
        raise RuntimeError(f"topk_merge_partials launch failed: CUDA error {rc}")
    topk_merge_partials.launches += 1
    return out_v, out_i


topk_merge_partials.launches = 0


def reset_launches() -> None:
    for counts in (fused_topk_partial.launches, fused_topk_partial.bodies):
        for key in counts:
            counts[key] = 0
    topk_merge_partials.launches = 0


def merge_partials_plain(
    part_v: torch.Tensor, part_i: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of stage 2 (a yardstick for the merge kernel)."""
    b = part_v.shape[0]
    v, pos = torch.topk(part_v.reshape(b, -1), k, dim=-1)
    i = torch.gather(part_i.reshape(b, -1), -1, pos).to(torch.int64)
    return v, torch.where(v == float("-inf"), -1, i)


def fused_topk_plain(
    db: torch.Tensor,
    queries: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    scales: torch.Tensor | None = None,
    int4: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernels' function, on the queries
    as the kernel receives them: float32 products of the stored values
    (exact for bf16 / int8 / int4 operands), times the row scale, masked
    by ``valid``, then ``torch.topk``. Returns sorted ``(B, k)`` float32
    scores and int64 indices with -inf / -1 past the valid count."""
    from wdbx_tpu_torch.kernels.quant import unpack_int4

    rows = unpack_int4(db) if int4 else db
    s = f32_scores(queries.to(torch.float32), rows.to(torch.float32))
    if scales is not None:
        s = s * scales[None, :]
    s = torch.where(valid[None, :], s, float("-inf"))
    k_eff = min(k, s.shape[1])
    v, i = torch.topk(s, k_eff, dim=-1)
    if k_eff < k:
        v = torch.nn.functional.pad(v, (0, k - k_eff), value=float("-inf"))
        i = torch.nn.functional.pad(i, (0, k - k_eff), value=-1)
    return v, torch.where(v == float("-inf"), -1, i.to(torch.int64))


def _prep_queries(db, queries, scales, normalize):
    """Query-side work of ``fused_topk_search`` (JAX :319-328), in
    plain torch before the launch: optional l2-normalize, then bf16
    against a quantized slab, the slab's type otherwise."""
    if normalize:
        queries = l2_normalize(queries)
    if scales is not None:
        return queries.to(torch.bfloat16)
    return queries.to(db.dtype)


def _search(db, queries, valid, k, scales, int4):
    if db.is_cuda and queries.shape[0] == 0:  # nothing to launch
        return (torch.empty((0, k), dtype=torch.float32, device=db.device),
                torch.empty((0, k), dtype=torch.int64, device=db.device))
    if db.is_cuda:
        part_v, part_i = fused_topk_partial(
            db, queries, valid, k, scales=scales, int4=int4
        )
        return topk_merge_partials(part_v, part_i, k)
    return fused_topk_plain(db, queries, valid, k, scales=scales, int4=int4)


def fused_topk_local(db, queries, valid, k, scales=None, int4=False):
    """Stage 1 of one shard of a mesh: ``(B, parts, k)`` float32 scores
    and int32 row indices (each part's k best, -inf / -1 pads), for
    ``queries`` already of the kernel's type (``_prep_queries``). On a
    CUDA slab it launches ``fused_topk_partial``; on a CPU slab it runs
    the plain version as one part."""
    if db.is_cuda:
        return fused_topk_partial(db, queries, valid, k, scales=scales,
                                  int4=int4)
    v, i = fused_topk_plain(db, queries, valid, k, scales=scales, int4=int4)
    return v[:, None, :], i.to(torch.int32)[:, None, :]


def merge_partials(part_v, part_i, k):
    """Stage 2 over ``(B, parts, k')`` partials of any part count: the
    merge kernel on CUDA tensors, its plain version on CPU tensors."""
    if part_v.is_cuda:
        return topk_merge_partials(part_v, part_i, k)
    return merge_partials_plain(part_v, part_i, k)


def fused_topk_search(
    db: torch.Tensor,
    queries: torch.Tensor,
    valid: torch.Tensor,
    k: int = 10,
    block_n: int | None = None,
    scales: torch.Tensor | None = None,
    group: int | None = None,
    normalize: bool = False,
    int4: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner products of ``queries`` (B, d) against ``db`` (N, d).

    ``db`` is a float32 or bf16 slab, an int8 slab with per-row
    ``scales``, or a packed ``(N, d/2)`` uint8 int4 slab with
    ``int4=True`` and scales. ``valid`` (N,) bool masks rows. Returns
    sorted ``(B, k)`` float32 scores and int64 row indices, -inf / -1
    where fewer than k rows are valid. ``block_n`` and ``group`` are
    accepted for the JAX signature and ignored: selection is exact.
    """
    del block_n, group
    if int4 and scales is None:
        raise ValueError("int4 slabs require per-row scales")
    _check_k(k)
    if scales is not None:
        scales = scales.to(torch.float32)
    q = _prep_queries(db, queries, scales, normalize)
    return _search(db, q, valid.to(torch.bool), k, scales, int4)


def fused_topk_search_batched(
    db: torch.Tensor,
    qstack: torch.Tensor,
    valid: torch.Tensor,
    k: int = 10,
    block_n: int | None = None,
    scales: torch.Tensor | None = None,
    group: int | None = None,
    normalize: bool = False,
    int4: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``fused_topk_search`` over a (NB, B, d) query stack. Queries are
    independent, so on the card the stack runs as ONE launch pair over
    NB*B queries; the plain version runs batch by batch (its score
    matrix is (B, N)). Returns (NB, B, k) scores and indices."""
    del block_n, group
    if int4 and scales is None:
        raise ValueError("int4 slabs require per-row scales")
    _check_k(k)
    nb, b, d = qstack.shape
    if scales is not None:
        scales = scales.to(torch.float32)
    valid = valid.to(torch.bool)
    q = _prep_queries(db, qstack.reshape(nb * b, d), scales, normalize)
    if db.is_cuda:
        v, i = _search(db, q, valid, k, scales, int4)
        return v.reshape(nb, b, k), i.reshape(nb, b, k)
    outs = [_search(db, qb, valid, k, scales, int4) for qb in q.split(b)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))
