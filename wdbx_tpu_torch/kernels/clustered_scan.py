"""Clustered block scan + top-k: the CUDA kernel's wrappers and its
plain PyTorch version.

Port of ``wdbx_tpu/kernels/clustered_scan.py``: ``_kernel_v2`` (K3,
``clustered_block_topk_v2``) and ``_kernel`` (K4, v1,
``clustered_block_topk``). Both are one hand-written CUDA C++ kernel for
Hopper in ``csrc/clustered_scan.cu`` (its header gives the bound on the
card and the design): stage 1 (``clustered_block_partial``) scores the
blocks a CTA reads from the deduplicated block list, with its group of
list entries and its query tile, and keeps each query's k best; stage 2
is the fused scan's ``topk_merge_partials``. v1 is v2 with bf16 / float
queries (its function), under its own launch counter. The scan body
follows the fused scan's rule (``fused_topk.pick_body``): float32 slabs
take the register-tiled body, bf16 / int8 / int4 slabs the pipelined
tensor-core body (bf16 products against bf16 queries, s8 products
against int8 queries) where its buffers fit; the CTAs of both split the
live blocks' tiles evenly among themselves on the card.

On a CUDA tensor the wrappers launch the kernels or raise; on a CPU
tensor they run ``clustered_block_topk_plain`` (gather the listed
blocks, multiply, scale, mask, ``torch.topk``), which the CPU tests use.
The index's portable scan (``ivf_kernel="lax"``, chosen by the caller)
is that plain version too, on either device.

Differences from the JAX kernels, all deliberate:
  * selection is exact: ``group`` and ``n_ways`` (the approximate
    grouped and pair reductions, and the ways per grid step) are
    accepted and ignored, which can only raise recall;
  * query batches are not padded to 32 rows (the TPU's int8 tile);
  * k is capped at ``K_MAX`` (shared with the fused scan);
  * positions come back int64, with -inf / -1 past the valid count
    (JAX: int32, with its ``NEG`` sentinel left in unfilled ranks);
  * the int8-query scale multiplies each score before selection rather
    than at emit: the same values (``(acc * row scale) * query scale``),
    and a positive scale keeps the order.
"""

from __future__ import annotations

import torch

from wdbx_tpu_torch.kernels import fused_topk as _ft
from wdbx_tpu_torch.kernels.quant import prep_query_block, unpack_int4
from wdbx_tpu_torch.ops.exact_search import f32_scores

K_MAX = _ft.K_MAX
#: CUDA kernel code of each query type
QUERY_CODES = {"float32": 0, "bfloat16": 1, "int8": 2}
_MAX_WAYS = 32  # block-list entries per CTA (kMaxWays)
_SPAN_ENTRIES = _MAX_WAYS - 1  # list entries per CTA of the tiled body
#: (generation, slab type, query type) of every kernel mode
MODES = (
    [("v2", s, q) for s, q in (
        ("float32", "float32"), ("bfloat16", "bfloat16"),
        ("int8", "bfloat16"), ("int4", "bfloat16"),
        ("int8", "int8"), ("int4", "int8"))]
    + [("v1", s, q) for s, q in (
        ("float32", "float32"), ("bfloat16", "bfloat16"),
        ("int8", "bfloat16"))]
)


def mode_key(gen: str, slab: str, qtype: str) -> str:
    return f"{gen}[{slab},q={qtype}]"


def plan(u: int, b: int, k: int, sm_count: int, partial_smem,
         body: str = "mma", d: int = 0,
         qtype: str = "bfloat16") -> tuple[int, int, int]:
    """Stage-1 grid ``(qt, ways, groups)``.

    The tiled float32 body (``body="fma_tiled"``, ``partial_smem`` its
    size): ``fused_topk.tiled_qt`` queries per CTA, ``ways`` 0 (unused:
    each CTA takes an equal span of the live blocks' tiles, counted on
    the card), and groups for one whole number of waves, at least
    ``u / 31`` so that a span stays within 32 list entries. The
    pipelined body (``body="mma_pipe"``, width ``d``, query type
    ``qtype``) the same, with ``fused_topk.pipe_qt`` queries per CTA and
    one CTA a SM.
    The other bodies: 64 queries per CTA when their candidate buffers
    fit beside the tiles, else 16; ``ways`` list entries per CTA, so
    that the grid holds about four CTAs per SM."""
    cap = _ft._cap(k)
    if body in ("fma_tiled", "mma_pipe"):
        pipe = body == "mma_pipe"
        qt = (_ft.pipe_qt(b, k, d, partial_smem, qtype) if pipe
              else _ft.tiled_qt(b, k, partial_smem))
        if qt is None:
            raise ValueError(f"k={k} at d={d} does not fit the pipelined body")
        qtiles = -(-b // qt)
        smem = partial_smem(qt, _ft.tiled_cap(qt, k, partial_smem))
        groups = _ft.whole_waves(
            qtiles, _ft.cta_slots(sm_count, smem, 1 if pipe else 2),
            -(-u // _SPAN_ENTRIES))
        return qt, 0, groups
    qt = 64 if partial_smem(64, cap) <= 160 * 1024 else 16
    if partial_smem(qt, cap) > 226 * 1024:
        raise ValueError(f"k={k} needs more shared memory than a CTA has")
    qtiles = -(-b // qt)
    target = max(1, -(-4 * sm_count // qtiles))
    ways = min(_MAX_WAYS, max(1, -(-u // target)))
    return qt, ways, -(-u // ways)


def _qtype(qq: torch.Tensor) -> str:
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16",
             torch.int8: "int8"}
    if qq.dtype not in names:
        raise ValueError(f"unsupported query dtype {qq.dtype}")
    return names[qq.dtype]


def clustered_block_partial(
    slab: torch.Tensor,
    valid: torch.Tensor,
    scales: torch.Tensor | None,
    uniq: torch.Tensor,
    ok: torch.Tensor,
    qq: torch.Tensor,
    qs: torch.Tensor,
    k: int,
    c: int,
    int4: bool = False,
    gen: str = "v2",
    body: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 on the card: ``(B, parts, k)`` float32 scores and int32
    global slab positions, each part's k best per query (unsorted;
    -inf / -1 pads). ``qq`` / ``qs`` come from ``prep_query_block``.
    ``body`` names the scan body instead of the shape rule's, as in
    ``fused_topk.fused_topk_partial``."""
    from wdbx_tpu_torch.kernels import build

    skey = _ft.slab_key(slab, int4)
    qkey = _qtype(qq)
    key = mode_key(gen, skey, qkey)
    if key not in clustered_block_partial.launches:
        raise ValueError(f"no kernel mode {key}")
    _ft._check_k(k)
    n, b, d = slab.shape[0], qq.shape[0], qq.shape[1]
    u = uniq.shape[0]
    tensors = (slab, valid, uniq, ok, qq, qs) + (
        (scales,) if scales is not None else ())
    if not all(t.is_cuda for t in tensors):
        raise ValueError("clustered_block_partial takes CUDA tensors")
    if slab.shape[1] != (d // 2 if int4 else d) or valid.shape != (n,) \
            or valid.dtype != torch.bool or uniq.shape != ok.shape \
            or uniq.ndim != 1 or u < 1:
        raise ValueError(f"shape mismatch: slab {tuple(slab.shape)}, "
                         f"queries {tuple(qq.shape)}, valid "
                         f"{tuple(valid.shape)}, uniq {tuple(uniq.shape)}")
    if n % c or n >= 2**31:
        raise ValueError(f"slab rows {n} must be a multiple of c={c} "
                         "and below 2^31 (int32 positions)")
    if skey in ("int8", "int4"):
        if scales is None or scales.dtype != torch.float32 or \
                scales.shape != (n,):
            raise ValueError("int8/int4 slabs need (N,) float32 scales")
        scales = scales.contiguous()
    qscale = qs.reshape(-1).to(torch.float32).contiguous()
    slab, valid, qq = slab.contiguous(), valid.contiguous(), qq.contiguous()
    uniq = uniq.to(torch.int32).contiguous()
    ok = ok.to(torch.int32).contiguous()
    lib = build.load("clustered_scan")
    slab_code = _ft.SLAB_CODES[skey]

    def smem_of(code):
        return lambda qt, cap: lib.wdbx_clustered_block_partial_smem(
            code, slab_code, QUERY_CODES[qkey], qt, cap, d)

    if body is None:
        body = _ft.pick_body(skey, qkey, b, k, d, slab.data_ptr(),
                             qq.data_ptr(), smem_of)
    elif body not in _ft.BODY_CODES:
        raise ValueError(f"no scan body {body!r}")
    code = _ft.BODY_CODES[body]
    smem = smem_of(code)
    sm = torch.cuda.get_device_properties(slab.device).multi_processor_count
    qt, ways, groups = plan(u, b, k, sm, smem, body, d, qkey)
    tiled = body in ("fma_tiled", "mma_pipe")
    cap = _ft.tiled_cap(qt, k, smem) if tiled else _ft._cap(k)
    parts = groups * (128 // qt if body == "mma_pipe" else 1)
    part_v = torch.empty((b, parts, k), dtype=torch.float32,
                         device=slab.device)
    part_i = torch.empty((b, parts, k), dtype=torch.int32,
                         device=slab.device)
    with _ft._on(slab):
        rc = lib.wdbx_clustered_block_partial(
            code, slab_code, QUERY_CODES[qkey], qt,
            slab.data_ptr(), qq.data_ptr(), qscale.data_ptr(),
            valid.data_ptr(),
            scales.data_ptr() if scales is not None else None,
            uniq.data_ptr(), ok.data_ptr(), n, u, ways, c, d, b, k,
            cap, groups, part_v.data_ptr(), part_i.data_ptr(),
            _ft._stream(slab),
        )
    if rc != 0:
        raise RuntimeError(f"clustered_block_partial {key} ({body}) launch "
                           f"failed: CUDA error {rc}")
    clustered_block_partial.launches[key] += 1
    clustered_block_partial.bodies[body] += 1
    return part_v, part_i


clustered_block_partial.launches = {mode_key(*m): 0 for m in MODES}
#: launches by scan body
clustered_block_partial.bodies = {body: 0 for body in _ft.BODY_CODES}


def reset_launches() -> None:
    for counts in (clustered_block_partial.launches,
                   clustered_block_partial.bodies):
        for key in counts:
            counts[key] = 0


def clustered_block_topk_plain(
    slab: torch.Tensor,
    valid: torch.Tensor,
    scales: torch.Tensor | None,
    uniq: torch.Tensor,
    ok: torch.Tensor,
    q: torch.Tensor,
    k: int,
    c: int,
    int4: bool = False,
    qprec: str = "bf16",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's function: queries prepared
    as the kernel receives them (``prep_query_block``), the listed
    blocks with ``ok != 0`` gathered, float32 products of the stored
    values (exact for bf16 / int8 / int4 operands), times the row scale
    and then the query scale, masked by ``valid``, ``torch.topk``, and
    the columns mapped to global slab positions. Returns sorted
    ``(B, k)`` float32 scores and int64 positions, -inf / -1 past the
    valid count."""
    qq, qs, b = prep_query_block(q, slab.dtype, scales is not None, qprec)
    valid = valid.reshape(-1) != 0
    ids = uniq[ok.reshape(-1) != 0].to(torch.int64)
    pos = (ids[:, None] * c
           + torch.arange(c, device=slab.device)[None, :]).reshape(-1)
    rows = slab[pos]
    if int4:
        rows = unpack_int4(rows)
    s = f32_scores(qq.to(torch.float32), rows.to(torch.float32))
    if scales is not None:
        s = s * scales[pos][None, :]
        if qq.dtype == torch.int8:
            s = s * qs
    s = torch.where(valid[pos][None, :], s, float("-inf"))
    k_eff = min(k, s.shape[1])
    v, i = torch.topk(s, k_eff, dim=-1)
    p = pos[i]
    if k_eff < k:
        v = torch.nn.functional.pad(v, (0, k - k_eff), value=float("-inf"))
        p = torch.nn.functional.pad(p, (0, k - k_eff), value=-1)
    return v, torch.where(v == float("-inf"), -1, p)


def _block_topk(slab, valid, scales, uniq, ok, q, k, c, int4, qprec, gen):
    _ft._check_k(k)
    if int4 and scales is None:
        raise ValueError("int4 slabs require per-row scales")
    if scales is not None:
        scales = scales.reshape(-1).to(torch.float32)
    valid = valid.reshape(-1) != 0
    if not slab.is_cuda:
        return clustered_block_topk_plain(slab, valid, scales, uniq, ok, q,
                                          k, c, int4=int4, qprec=qprec)
    if q.shape[0] == 0:  # nothing to launch
        return (torch.empty((0, k), dtype=torch.float32, device=slab.device),
                torch.empty((0, k), dtype=torch.int64, device=slab.device))
    qq, qs, _ = prep_query_block(q, slab.dtype, scales is not None, qprec)
    part_v, part_i = clustered_block_partial(
        slab, valid, scales, uniq, ok, qq, qs, k, c, int4=int4, gen=gen)
    return _ft.topk_merge_partials(part_v, part_i, k)


def clustered_block_topk_v2(
    slab: torch.Tensor,
    valid_i8: torch.Tensor,
    scales: torch.Tensor | None,
    uniq: torch.Tensor,
    ok: torch.Tensor,
    q: torch.Tensor,
    k: int,
    c: int,
    interpret: bool = False,
    group: int | None = None,
    n_ways: int = 8,
    int4: bool = False,
    qprec: str = "bf16",
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: top-k of float queries ``q`` (B, d) over the listed c-row
    blocks of ``slab`` (cap, d; (cap, d/2) uint8 with ``int4=True``).
    ``valid_i8`` (cap,) or (1, cap) non-zero for live rows; ``scales``
    per row for int8 / int4 slabs; ``uniq`` / ``ok`` the (u,) block ids
    and their live flags. ``qprec`` picks bf16 or int8 queries against
    an int8 / int4 slab. Returns sorted ``(B, k)`` float32 scores and
    int64 global slab positions, -inf / -1 past the valid count.
    ``interpret``, ``group`` and ``n_ways`` are accepted for the JAX
    signature and ignored."""
    del interpret, group, n_ways
    return _block_topk(slab, valid_i8, scales, uniq, ok, q, k, c, int4,
                       qprec, "v2")


def clustered_block_topk(
    slab: torch.Tensor,
    valid_i8: torch.Tensor,
    scales: torch.Tensor | None,
    uniq: torch.Tensor,
    ok: torch.Tensor,
    q: torch.Tensor,
    k: int,
    c: int,
    interpret: bool = False,
    group: int | None = None,
    n_ways: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 (v1): ``clustered_block_topk_v2``'s contract for float32 /
    bf16 / int8 slabs with bf16 (int8 slab) or slab-typed queries; no
    int4 and no int8 queries, as in the JAX package."""
    del interpret, group, n_ways
    if slab.dtype == torch.uint8:
        raise ValueError("v1 has no int4 unpack; packed slabs take v2")
    return _block_topk(slab, valid_i8, scales, uniq, ok, q, k, c, False,
                       "bf16", "v1")
