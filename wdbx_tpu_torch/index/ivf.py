"""IVF (partitioned) index: the dense bucket-table engine, and the
training bookkeeping, residual merge, filter boosts and recall tuners
that the clustered engine (``index/clustered.py``) inherits.

Torch port of ``wdbx_tpu/index/ivf.py``. The dense engine
(``INDEX_TYPE=ivf_dense``, or ``ivf`` with ``IVF_ASSIGNMENTS>=2``):

  * vectors always live in the base FlatIndex slab (the source of truth
    for mutation, persistence and re-ranking);
  * a build trains spherical k-means centroids and lays the live rows out
    in a dense ``(nlist, cap_b)`` table of slot ids, with a contiguous
    ``(nlist, cap_b, d)`` copy of the rows (bf16, or int8 codes with a
    scale table for an int8 slab). One assignment per row is capped at
    ~1.3x the mean bucket (overflow spills to the next-best centroid, then
    to the residual buffer); ``assignments=2`` is SOAR spilled assignment:
    each row joins its two nearest buckets;
  * a query scores the centroids, picks ``nprobe`` buckets and scores
    their rows: the portable scan (``ivf_kernel="lax"``, the default)
    scores each probed bucket once against the whole batch with a
    per-query membership mask; the kernel path (``ivf_kernel="pallas"``)
    runs K5, ``kernels/ivf_scan.py`` (the hand-written CUDA kernel on the
    card, its plain version on the CPU), one (query, probe) pair at a
    time;
  * adds after a build land in a residual (fresh) buffer that is
    brute-force scanned and merged; deletes and updates invalidate their
    bucket entries; freed slots are quarantined until the next build.

Differences from the JAX engine, all deliberate: query batches and
residual lists are not padded (``pad_b`` still picks the flat fallback);
the bucket tables' pad entries still hold the slab capacity (so that
checkpoints move between the packages) but are masked, and clamped
before any gather; the portable scan selects exactly (``torch.topk`` for
``approx_max_k``) and gathers its buckets in chunks; the kernel path
maps bucket positions to slots on the device (no host label decode); the
validity table is not replicated 8x for the kernel. The on-disk format
(``.ivf.npz`` + ``.ivf.json`` beside the flat checkpoint, bf16 tables as
uint16 bits) is the JAX package's.
"""

from __future__ import annotations

import json
import logging
import math
import os
from typing import Any

import numpy as np
import torch

from wdbx_tpu_torch.index.base import Pending, Plan
from wdbx_tpu_torch.index.flat import (
    FlatIndex,
    _next_pow2,
    slab_from_numpy,
    slab_to_numpy,
    to_tensor,
)
from wdbx_tpu_torch.kernels.quant import unpack_int4
from wdbx_tpu_torch.ops.exact_search import f32_scores
from wdbx_tpu_torch.ops.kmeans import kmeans
from wdbx_tpu_torch.ops.normalize import l2_normalize

logger = logging.getLogger("wdbx_tpu_torch.index")

#: bytes of float32 bucket rows the portable scan gathers at once
_SCAN_CHUNK_BYTES = 1 << 26


def _scores_of(rows: torch.Tensor, q: torch.Tensor, precision: str,
               quant: bool) -> torch.Tensor:
    """``(B, R)`` float32 products of ``q`` against ``rows`` as the
    JAX scans take them: bf16 queries against int8 / int4 codes, the
    slab's type otherwise; float32 accumulation of exact products
    (true float32 for ``precision="highest"``)."""
    if quant:
        qf = q.to(torch.bfloat16).to(torch.float32)
    else:
        qf = q.to(rows.dtype).to(torch.float32)
    rf = rows.to(torch.float32)
    if precision == "highest":
        return f32_scores(qf, rf)
    return qf @ rf.T


def _probes(q: torch.Tensor, centroids: torch.Tensor, nprobe: int,
            precision: str) -> torch.Tensor:
    """``(B, P)`` ids of each query's ``nprobe`` best centroids."""
    cs = (f32_scores(q, centroids) if precision == "highest"
          else q @ centroids.T)
    return torch.topk(cs, min(nprobe, centroids.shape[0]), dim=-1).indices


def _residual_merge(
    slab: torch.Tensor,
    valid: torch.Tensor,
    residual_pos: torch.Tensor,
    scales: torch.Tensor | None,
    vals: torch.Tensor,
    labels: torch.Tensor,
    q: torch.Tensor,
    k: int,
    precision: str,
    int8: bool = False,
    int4: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge ``(B, C)`` scan candidates (scores, int64 positions) with a
    brute-force scan of the fresh rows at ``residual_pos`` (the live
    positions only: unlike the JAX version there are no pad entries one
    past the slab). Scores ``<= -3e38`` (JAX's ``NEG`` sentinel) count
    as -inf. Returns sorted ``(B, k)`` scores and positions, -inf / -1
    past the candidate count."""
    b = q.shape[0]
    scores = torch.where(vals <= -3.0e38, float("-inf"), vals)
    flat_labels = labels.to(torch.int64)
    if residual_pos.numel():
        rows = slab[residual_pos]
        if int4:
            rows = unpack_int4(rows)
        r_scores = _scores_of(rows, q, precision, int8 or int4)
        if int8 or int4:
            r_scores = r_scores * scales[residual_pos][None, :]
        r_scores = torch.where(valid[residual_pos][None, :], r_scores,
                               float("-inf"))
        scores = torch.cat([scores, r_scores], dim=-1)
        flat_labels = torch.cat(
            [flat_labels, residual_pos[None, :].expand(b, -1)], dim=-1
        )
    k_eff = min(k, scores.shape[-1])
    top, pos = torch.topk(scores, k_eff, dim=-1)
    top_labels = torch.gather(flat_labels, -1, pos)
    if k_eff < k:
        top = torch.nn.functional.pad(top, (0, k - k_eff),
                                      value=float("-inf"))
        top_labels = torch.nn.functional.pad(top_labels, (0, k - k_eff),
                                             value=-1)
    return top, top_labels


def _ivf_search(slab, valid, centroids, bucket_slot, bucket_valid,
                bucket_rows, bucket_scale, residual_pos, scales, q, k,
                nprobe, precision, int8=False, normalize=False):
    """The portable dense scan (JAX's lax dedup scan): the batch's probed
    buckets, each scored once against the whole batch, a (B, buckets)
    membership mask keeping per-query probe semantics (a query sees only
    the rows of buckets it probed itself), then the residual merge.
    Buckets are gathered a chunk at a time and the top-k merged as it
    goes, so the scan never holds more than one chunk of rows. Returns
    sorted ``(B, k)`` scores and slots (slot -1 or any slot where the
    score is -inf)."""
    if normalize:
        q = l2_normalize(q)
    b = q.shape[0]
    _, c, d = bucket_rows.shape
    probe = _probes(q, centroids, nprobe, precision)  # (B, P)
    uniq = torch.unique(probe)  # sorted unique bucket ids
    member = (probe[:, :, None] == uniq[None, None, :]).any(dim=1)
    qf = q.to(torch.bfloat16 if int8 else bucket_rows.dtype)
    qf = qf.to(torch.float32)
    g = max(1, _SCAN_CHUNK_BYTES // (c * d * 4))
    best_v = torch.full((b, 0), float("-inf"), device=q.device)
    best_s = torch.full((b, 0), -1, dtype=torch.int64, device=q.device)
    for lo in range(0, uniq.shape[0], g):
        ids = uniq[lo:lo + g]
        rows = bucket_rows[ids].reshape(-1, d).to(torch.float32)
        s = f32_scores(qf, rows)  # (B, g * C): exact bf16 / int8 products
        if int8:
            s = s * bucket_scale[ids].reshape(1, -1)
        ok = bucket_valid[ids].reshape(1, -1) & \
            member[:, lo:lo + g].repeat_interleave(c, dim=1)
        s = torch.where(ok, s, float("-inf"))
        slots = bucket_slot[ids].reshape(-1).to(torch.int64)
        v = torch.cat([best_v, s], dim=1)
        sl = torch.cat([best_s, slots[None, :].expand(b, -1)], dim=1)
        best_v, pos = torch.topk(v, min(k, v.shape[1]), dim=1)
        best_s = torch.gather(sl, 1, pos)
    return _residual_merge(slab, valid, residual_pos, scales, best_v, best_s,
                           q, k=k, precision=precision, int8=int8)


def _ivf_query_pallas(centroids, bucket_rows, bucket_valid, bucket_slot,
                      slab, valid, residual_pos, scales, q, k, nprobe,
                      precision, int8=False, normalize=True):
    """The kernel path: probe top-k, K5 over the (query, probe) pairs,
    the pairs' bucket positions mapped to slots on the device (ranks
    past a bucket's valid count stay -1), then the residual merge."""
    from wdbx_tpu_torch.kernels.ivf_scan import ivf_bucket_scan

    if normalize:
        q = l2_normalize(q)
    b = q.shape[0]
    cap_b = bucket_rows.shape[1]
    probe = _probes(q, centroids, nprobe, precision)
    p_eff = probe.shape[1]
    probes_flat = probe.reshape(-1)
    qidx = torch.arange(b, device=q.device).repeat_interleave(p_eff)
    kv, kp = ivf_bucket_scan(bucket_rows, bucket_valid, probes_flat, qidx,
                             q, k=min(k, cap_b))
    kb = kv.shape[-1]
    slots = bucket_slot[probes_flat[:, None], kp.clamp(min=0)].to(torch.int64)
    slots = torch.where(kp >= 0, slots, -1)
    return _residual_merge(
        slab, valid, residual_pos, scales, kv.reshape(b, p_eff * kb),
        slots.reshape(b, p_eff * kb), q, k=k, precision=precision, int8=int8,
    )


#: selectivity below which filtered ANN searches route to the exact
#: masked flat scan: probing nprobe buckets for a filter matching <2%
#: of rows rarely surfaces k matches, while the exact scan is recall 1.0
FILTER_EXACT_THRESHOLD = 0.02

#: selectivity bin edges for the filtered probe boost; each bin maps to
#: one boost factor
_BOOST_BINS = (0.5, 0.25, 0.125)
#: default boost per bin, about 2/selectivity at the bin's lower edge;
#: tune_filtered() replaces these with measured values
_DEFAULT_BOOSTS = (2, 4, 8, 16)
#: candidate factors tune_filtered may pin (~1.5x steps)
_BOOST_LADDER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)


def _boost_bin(selectivity: float) -> int:
    for i, edge in enumerate(_BOOST_BINS):
        if selectivity >= edge:
            return i
    return len(_BOOST_BINS)


def _filter_boost(selectivity: float, table=None) -> int:
    """Probe multiplier for a filter passing a fraction ``s`` of rows
    (about 2/s); ``table`` (bin -> factor, from ``tune_filtered``)
    overrides the defaults."""
    b = _boost_bin(selectivity)
    if table:
        got = table.get(b)
        if got:
            return int(got)
    return _DEFAULT_BOOSTS[b]


def _mask_bucket_valid_body(bucket_valid: torch.Tensor,
                            bucket_slot: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """AND a per-slot filter mask into the bucket validity table. Pad
    entries hold the slab capacity (one past the slab at build time):
    the slot is clamped to one past the mask, which reads a trailing
    False."""
    mask_pad = torch.cat([mask, mask.new_zeros(1)])
    idx = torch.clamp(bucket_slot.to(torch.int64), max=mask.shape[0])
    return bucket_valid & mask_pad[idx]


def _capped_placement(
    assign_multi: np.ndarray, nlist: int
) -> tuple[np.ndarray, int]:
    """Capacity-capped bucket placement: buckets cap at ~1.3x the mean
    (k-means skew would otherwise make the dense table several times the
    corpus); overflow rows greedily spill to their next-best centroid
    (columns of ``assign_multi``); rows whose every choice is full return
    -1 (the caller parks them in the residual buffer). Returns
    ``(placed_bucket_per_row, cap_b)``."""
    n_live, n_choices = assign_multi.shape
    cap_b = max(
        128, int(math.ceil(1.3 * n_live / max(nlist, 1) / 128.0)) * 128
    )
    placed = np.full(n_live, -1, np.int32)
    cap_left = np.full(nlist, cap_b, np.int64)
    for a in range(n_choices):
        un = np.nonzero(placed < 0)[0]
        if not len(un):
            break
        b = assign_multi[un, a]
        order_r = np.argsort(b, kind="stable")
        b_sorted = b[order_r]
        starts = np.searchsorted(b_sorted, np.arange(nlist))
        rank = np.arange(len(b_sorted)) - starts[b_sorted]
        ok = rank < cap_left[b_sorted]
        sel = un[order_r[ok]]
        placed[sel] = b_sorted[ok]
        cap_left -= np.bincount(b_sorted[ok], minlength=nlist)
    return placed, cap_b


def _pack_slot_positions(
    slot_arr: np.ndarray, c_arr: np.ndarray, p_arr: np.ndarray,
    cap: int, n_assign: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized slot -> (cluster, position) tables: ``(cap, n_assign)``
    int32 arrays, -1 for absent entries."""
    table_c = np.full((cap, n_assign), -1, np.int32)
    table_p = np.full((cap, n_assign), -1, np.int32)
    if len(slot_arr):
        order = np.argsort(slot_arr, kind="stable")
        ss = slot_arr[order]
        occ = np.arange(len(ss)) - np.searchsorted(ss, ss)
        table_c[ss, occ] = c_arr[order]
        table_p[ss, occ] = p_arr[order]
    return table_c, table_p


def _dedup_rows(scores: np.ndarray, slots: np.ndarray, k: int):
    """Keep the first (best) occurrence of each slot per row; needed when
    multi-assignment lets the same slot surface from two buckets."""
    b = scores.shape[0]
    out_s = np.full((b, k), -np.inf, np.float32)
    out_i = np.full((b, k), -1, np.int64)
    for r in range(b):
        seen = set()
        j = 0
        for score, slot in zip(scores[r], slots[r]):
            if j >= k:
                break
            if slot < 0 or score == -np.inf or slot in seen:
                continue
            seen.add(int(slot))
            out_s[r, j] = score
            out_i[r, j] = slot
            j += 1
    return out_s, out_i


class IVFIndex(FlatIndex):
    kind = "ivf"
    # dense bucket tables duplicate rows outside the flat slab; the
    # slab-external scheme cannot reconstruct them from raw rows
    supports_slab_external = False

    def __init__(
        self,
        dim: int,
        metric: str = "cosine",
        dtype: str = "float32",
        capacity: int = 1024,
        nlist: int = 100,
        nprobe: int = 8,
        train_threshold: int = 4096,
        rebuild_fraction: float = 0.2,
        kmeans_iters: int = 15,
        train_sample: int = 262_144,
        assignments: int = 1,
        device: Any = None,
    ):
        super().__init__(dim, metric=metric, dtype=dtype, capacity=capacity,
                         device=device)
        if dtype == "int4" and self.kind == "ivf":
            raise ValueError(
                "int4 is supported by 'flat', 'sharded_flat', "
                "'ivf_clustered' and 'sharded_clustered' "
                "(the dense-table IVF stays int8)"
            )
        self.nlist = nlist
        self.nprobe = nprobe
        #: clusters each vector joins (2 = SOAR-style spilled assignment:
        #: boundary vectors become findable from their runner-up cluster,
        #: buying recall at fixed nprobe for 2x bucket-table memory)
        self.assignments = max(1, int(assignments))
        self.train_threshold = train_threshold
        self.rebuild_fraction = rebuild_fraction
        self.kmeans_iters = kmeans_iters
        self.train_sample = train_sample
        #: fall back to a flat scan when batched probes cover the corpus
        self.batch_flat_fallback = True
        # ANN context: the flat fallbacks select with exact_search (the
        # JAX package's approximate selector is exact here)
        self.topk_method = "approx"
        #: bucket-scan implementation: "lax" (the portable scan) or
        #: "pallas" (K5: the CUDA kernel on the card, its plain version on
        #: the CPU); float tables and k * min(assignments, 2) <= 128 only
        self.ivf_kernel = "lax"
        #: calibrated filtered-probe boosts (selectivity bin -> factor),
        #: populated by tune_filtered(); empty -> _DEFAULT_BOOSTS
        self._filter_boosts: dict[int, int] = {}
        self._reset_overlay()

    def _reset_overlay(self) -> None:
        self._centroids = None  # (nlist, d) float32
        #: (nlist, cap_b) int32 slab slots; pad entries hold the slab
        #: capacity at build time (one past the slab then)
        self._bucket_slot = None
        self._bucket_valid = None  # (nlist, cap_b) bool
        self._bucket_rows = None  # (nlist, cap_b, d) contiguous row copy
        self._bucket_scale = None  # (nlist, cap_b) float32; int8 tables
        #: (cap, n_assign) int32 slot -> cluster / -> position tables
        self._slot_bucket_c: np.ndarray | None = None
        self._slot_bucket_p: np.ndarray | None = None
        self._residual: list[int] = []  # slots added since last build
        self._residual_base = 0  # spill-seeded entries (don't re-trigger)
        self._quarantine: list[int] = []  # freed slots held until rebuild
        self._built_size = 0

    @property
    def is_trained(self) -> bool:
        return self._centroids is not None

    # -- mutation: fresh buffer bookkeeping ---------------------------------
    def add_batch(self, vectors) -> np.ndarray:
        with self._mu.write():
            slots = super().add_batch(vectors)
            if self.is_trained:
                self._residual.extend(int(s) for s in slots)
            return slots

    def update_slots(self, slots: np.ndarray, vectors) -> None:
        """In-place vector update: the bucket table's copy would go
        stale, so the bucket entry is invalidated and the slot re-enters
        through the fresh buffer."""
        with self._mu.write():
            super().update_slots(slots, vectors)
            if not self.is_trained:
                return
            slot_list = [int(s) for s in np.asarray(slots, np.int64)]
            self._invalidate_bucket_entries(slot_list)
            present = set(self._residual)
            self._residual.extend(s for s in slot_list if s not in present)

    def remove_slots(self, slots: np.ndarray) -> None:
        """Tombstone, but quarantine the slots until the next build
        instead of recycling them (a reused slot would surface from its
        old bucket entry too). The bucket entry is invalidated directly:
        the scan trusts the bucket validity table for bucketed rows."""
        with self._mu.write():
            super().remove_slots(slots)
            if self.is_trained:
                freed = set(int(s) for s in np.asarray(slots, np.int64))
                self._free = [s for s in self._free if s not in freed]
                self._quarantine.extend(freed)
                self._invalidate_bucket_entries(freed)

    def _invalidate_bucket_entries(self, slots) -> None:
        cs, ps = self._take_bucket_positions(slots)
        if len(cs):
            self._bucket_valid[
                torch.as_tensor(cs, dtype=torch.int64, device=self.device),
                torch.as_tensor(ps, dtype=torch.int64, device=self.device),
            ] = False

    def _take_bucket_positions(self, slots) -> tuple[np.ndarray, np.ndarray]:
        """Pop (cluster, position) entries for ``slots`` from the packed
        tables."""
        if self._slot_bucket_c is None:
            return np.empty(0, np.int32), np.empty(0, np.int32)
        idx = np.asarray(list(slots), np.int64)
        idx = idx[(idx >= 0) & (idx < self._slot_bucket_c.shape[0])]
        cs = self._slot_bucket_c[idx].reshape(-1)
        ps = self._slot_bucket_p[idx].reshape(-1)
        keep = cs >= 0
        self._slot_bucket_c[idx] = -1
        self._slot_bucket_p[idx] = -1
        return cs[keep], ps[keep]

    def clear(self) -> None:
        with self._mu.write():
            super().clear()
            self._reset_overlay()

    def optimize(self) -> None:
        if self._size > 0:
            self.build()

    def compact(self):
        with self._mu.write():
            old, new = super().compact()
            # bucket tables and fresh buffer reference pre-compaction slots
            self._reset_overlay()
            if self._size >= self.train_threshold:
                self.build()
            return old, new

    # -- build ---------------------------------------------------------------
    def build(self) -> None:
        """(Re)train centroids and lay out the bucket tables from the
        live slab. Holds the write lock throughout: searches block during
        a rebuild (rare, triggered by ``rebuild_fraction``)."""
        with self._mu.write():
            self._build_locked()

    def _gather_rows(self, slab, scales, idx: np.ndarray) -> torch.Tensor:
        """Float32 rows at positions ``idx`` (dequantized; unit norm
        for cosine)."""
        ix = torch.as_tensor(idx, device=self.device)
        rows = slab[ix]
        if self._is_int4:
            rows = unpack_int4(rows)
        rows = rows.to(torch.float32)
        if self._is_quantized:
            rows = rows * scales[ix][:, None]
        if self.metric == "cosine":
            rows = rows / torch.clamp_min(
                torch.linalg.norm(rows, dim=-1, keepdim=True), 1e-12
            )
        return rows

    def _build_locked(self) -> None:
        hwm = self._next_slot
        if self._size == 0 or hwm == 0:
            self._reset_overlay()
            return
        valid = self._valid[:hwm].cpu().numpy()
        live_slots = np.nonzero(valid)[0].astype(np.int32)
        n_live = len(live_slots)
        nlist = min(self.nlist, n_live)
        sample = live_slots
        if n_live > self.train_sample:
            sel = np.random.default_rng(0).choice(
                n_live, self.train_sample, replace=False
            )
            sample = live_slots[np.sort(sel)]
        train = self._gather_rows(self._slab, self._scales, sample)
        centroids, _ = kmeans(train, num_clusters=nlist,
                              iters=self.kmeans_iters)
        del train

        n_assign = min(self.assignments, nlist)
        # extra choices beyond the genuine copies: spill candidates for
        # the capacity-capped placement
        n_choices = min(max(4, n_assign), nlist)
        # chunked: each pass gathers at most `chunk` rows (dequantized,
        # normalized) and frees them before the next
        chunk = 131_072
        assign_multi = np.empty((n_live, n_choices), np.int32)
        for i in range(0, n_live, chunk):
            end = min(i + chunk, n_live)
            rows = self._gather_rows(self._slab, self._scales,
                                     live_slots[i:end])
            assign_multi[i:end] = torch.topk(
                f32_scores(rows, centroids), n_choices, dim=-1
            ).indices.to(torch.int32).cpu().numpy()
            del rows

        spilled = 0
        if n_assign == 1:
            placed, cap_b = _capped_placement(assign_multi, nlist)
            keep = placed >= 0
            spilled = int((~keep).sum())
            leftover_slots = live_slots[~keep]
            assign = placed[keep]
            live_slots = live_slots[keep]
        else:
            # SOAR keeps the dense layout (each row appears n_assign
            # times; skew capping would break copies)
            assign = assign_multi[:, :n_assign].reshape(-1)
            live_slots = np.repeat(live_slots, n_assign)
            leftover_slots = np.empty(0, np.int32)
            counts = np.bincount(assign, minlength=nlist)
            cap_b = max(128, int(math.ceil(counts.max() / 128.0)) * 128)
        n_entries = len(assign)
        bucket_slot = np.full((nlist, cap_b), self._cap, np.int32)  # pad
        bucket_valid = np.zeros((nlist, cap_b), bool)
        # stable-sort rows by cluster; position = global rank - start
        order = np.argsort(assign, kind="stable")
        sorted_assign = assign[order]
        starts = np.searchsorted(sorted_assign, np.arange(nlist))
        pos_within = np.arange(n_entries) - starts[sorted_assign]
        slot_sorted = live_slots[order]
        bucket_slot[sorted_assign, pos_within] = slot_sorted
        bucket_valid[sorted_assign, pos_within] = True

        # each bucket's rows copied contiguously, straight from the slab
        # (unit rows already for cosine): bf16 for float slabs, raw codes
        # + a scale table for int8. Chunked scatter: peak slab + table +
        # one chunk.
        dev = self.device
        table_dtype = torch.int8 if self._is_int8 else torch.bfloat16
        bucket_rows = torch.zeros((nlist, cap_b, self.dim), dtype=table_dtype,
                                  device=dev)
        bucket_scale = (
            torch.zeros((nlist, cap_b), dtype=torch.float32, device=dev)
            if self._is_int8 else None
        )
        for i in range(0, n_entries, chunk):
            end = min(i + chunk, n_entries)
            s_idx = torch.as_tensor(slot_sorted[i:end], dtype=torch.int64,
                                    device=dev)
            c_idx = torch.as_tensor(sorted_assign[i:end], dtype=torch.int64,
                                    device=dev)
            p_idx = torch.as_tensor(pos_within[i:end], dtype=torch.int64,
                                    device=dev)
            bucket_rows[c_idx, p_idx] = self._slab[s_idx].to(table_dtype)
            if self._is_int8:
                bucket_scale[c_idx, p_idx] = self._scales[s_idx]
        self._bucket_rows = bucket_rows
        self._bucket_scale = bucket_scale
        self._slot_bucket_c, self._slot_bucket_p = _pack_slot_positions(
            slot_sorted, sorted_assign.astype(np.int32),
            pos_within.astype(np.int32), self._cap, n_assign,
        )
        self._centroids = centroids.to(dev)
        self._bucket_slot = torch.from_numpy(bucket_slot).to(dev)
        self._bucket_valid = torch.from_numpy(bucket_valid).to(dev)
        # rows that could not be placed under the bucket cap live in the
        # residual buffer (brute-scanned every query, like fresh adds)
        self._residual = [int(s) for s in leftover_slots]
        self._residual_base = len(self._residual)
        if spilled:
            logger.info(
                "ivf build: %d rows spilled to the residual buffer "
                "(bucket cap %d)", spilled, cap_b,
            )
        self._free.extend(self._quarantine)  # safe to recycle post-rebuild
        self._quarantine = []
        self._built_size = self._size

    def _needs_build(self) -> bool:
        if not self.is_trained:
            return self._size >= self.train_threshold
        fresh = len(self._residual) - getattr(self, "_residual_base", 0)
        return bool(self._built_size) and (
            fresh > self.rebuild_fraction * self._built_size
        )

    def _maybe_build(self) -> None:
        if self._needs_build():
            self.build()

    # -- query ---------------------------------------------------------------
    def _plan(self, b: int, slot_mask, stack: bool = False) -> Plan:
        if not self.is_trained:
            # below the training threshold a flat scan is exact and cheap
            return Plan(exact=True, mask=self._row_mask(slot_mask),
                        stack=stack)
        nlist = int(self._centroids.shape[0])
        mask, nprobe, exact = self._filter_plan(
            slot_mask, min(self.nprobe, nlist), nlist)
        plan = Plan(exact, mask, stack, nprobe=nprobe,
                    pad_b=self._pad_b(b, stack))
        if not (exact or stack) and self.batch_flat_fallback and (
            self._scan_reads(plan) >= max(1, self._size)
        ):
            plan.exact = True
        return plan

    def _row_mask(self, slot_mask):
        """A slot filter in the slab's row space (slots here)."""
        return slot_mask

    def _pad_b(self, b: int, stack: bool = False) -> int:
        """JAX's batch width: routing and the dedup length only (the
        queries are not padded). A batch of a pipelined stack gets it
        too: the JAX store pads a pipelined batch to that width, so a
        batch gets the blocks it gets from ``search_batch`` whether it
        comes through the store's submit (the QueryBatcher) or not."""
        return _next_pow2(max(b, 1))

    def _scan_reads(self, plan: Plan) -> int:
        """Rows the scan reads for ``plan``: the dedup-aware cost guard
        reads at most u unique buckets once each; a flat scan reads N
        rows once."""
        nlist, cap_b = (int(n) for n in self._bucket_slot.shape)
        return min(plan.pad_b * plan.nprobe, nlist) * cap_b

    def _filter_plan(self, slot_mask, nprobe: int, nlist: int):
        """Plan a filtered search: ``(mask, nprobe_eff, exact)``, the
        mask in row space (``_row_mask``). Pushdown ANDs it into row
        validity and boosts nprobe by the selectivity bin's factor;
        filters under ``FILTER_EXACT_THRESHOLD`` take the exact masked
        scan."""
        mask = self._row_mask(slot_mask)
        if mask is None:
            return None, nprobe, False
        sel = self._mask_selectivity(slot_mask)
        if sel < FILTER_EXACT_THRESHOLD:
            return mask, nprobe, True
        boost = _filter_boost(sel, getattr(self, "_filter_boosts", None))
        return mask, min(nlist, nprobe * boost), False

    def _use_pallas(self, k: int) -> bool:
        """K5 speaks float tables and k <= 128 result lanes; int8 code
        tables and deeper fetches take the portable scan."""
        return (self.ivf_kernel == "pallas" and not self._is_int8
                and k * min(self.assignments, 2) <= 128)

    def _residual_tensor(self) -> torch.Tensor:
        return torch.as_tensor(np.asarray(self._residual, np.int64),
                               device=self.device)

    def _enqueue(self, queries, k: int, plan: Plan) -> Pending:
        """The dense scan (K5 or the portable scan; a pipelined stack
        takes the portable scan, as JAX's does)."""
        if plan.exact:
            return super()._enqueue(queries, k, plan)
        valid, bucket_valid = self._valid, self._bucket_valid
        if plan.mask is not None:
            valid = self._masked_valid_dev(valid, plan.mask, self._cap)
            mask = np.zeros(self._cap, bool)
            n = min(len(plan.mask), self._cap)
            mask[:n] = plan.mask[:n]
            # bucket-resident rows are filtered by the bucket table, not
            # the global mask
            bucket_valid = _mask_bucket_valid_body(
                bucket_valid, self._bucket_slot,
                torch.from_numpy(mask).to(self.device),
            )
        q = to_tensor(queries, self.device, torch.float32)
        # multi-assignment can surface one slot from two buckets: fetch
        # extra candidates, dedup on the host, truncate back to k
        k_fetch = k * min(self.assignments, 2)
        common = dict(k=k_fetch, nprobe=plan.nprobe,
                      precision=self._precision, int8=self._is_int8,
                      normalize=self.metric == "cosine")
        if not plan.stack and self._use_pallas(k):
            scores, slots = _ivf_query_pallas(
                self._centroids, self._bucket_rows, bucket_valid,
                self._bucket_slot, self._slab, valid,
                self._residual_tensor(), self._scales, q, **common,
            )
        else:
            scores, slots = _ivf_search(
                self._slab, valid, self._centroids, self._bucket_slot,
                bucket_valid, self._bucket_rows, self._bucket_scale,
                self._residual_tensor(), self._scales, q, **common,
            )
        return Pending(scores, slots, k, self._finish)

    def _finish(self, scores: np.ndarray, ids: np.ndarray, k: int):
        """-1 where the score is -inf, then the multi-assignment dedup
        where the scan over-fetched (only it returns more than k
        columns)."""
        scores, out = super()._finish(scores, ids, k)
        width = scores.shape[-1]
        if width <= k:
            return scores, out
        s, o = _dedup_rows(scores.reshape(-1, width), out.reshape(-1, width),
                           k)
        lead = scores.shape[:-1]
        return s.reshape(lead + (k,)), o.reshape(lead + (k,))

    def tune(
        self,
        queries: np.ndarray,
        k: int = 10,
        target_recall: float = 0.95,
        max_scan_fraction: float = 1.0,
        exclude_slots: np.ndarray | None = None,
    ) -> float:
        """Pick the smallest ``nprobe`` hitting ``target_recall`` on a
        sample query set, measured against this index's own exact scan.
        Returns the achieved recall. ``exclude_slots`` (one slot per
        query) holds each query's own row out of both sides."""
        self._build_if_stale()
        if not self.is_trained:
            return 1.0
        queries = self._prep(queries)
        fetch_k = k + 1 if exclude_slots is not None else k

        def row_sets(slot_rows) -> list[set]:
            out = []
            for qi, row in enumerate(slot_rows):
                kept = [int(s) for s in row if s >= 0]
                if exclude_slots is not None:
                    own = int(exclude_slots[qi])
                    kept = [s for s in kept if s != own]
                out.append(set(kept[:k]))
            return out

        _, exact = self._oracle_search(queries, fetch_k)
        exact_sets = [s or {-1} for s in row_sets(exact)]
        nlist = int(self._centroids.shape[0])
        max_probe = max(1, int(nlist * max_scan_fraction))

        def recall_at(nprobe: int) -> float:
            self.nprobe = nprobe
            fallback = self.batch_flat_fallback
            self.batch_flat_fallback = False  # measure the real scan path
            try:
                _, got = self.search(queries, fetch_k)
            finally:
                self.batch_flat_fallback = fallback
            return float(np.mean([
                len(e & g) / len(e)
                for e, g in zip(exact_sets, row_sets(got))
            ]))

        prior = self.nprobe
        try:
            # geometric climb to bracket the target
            lo, hi = 0, 1
            recall = recall_at(hi)
            while recall < target_recall and hi < max_probe:
                lo = hi
                hi = min(max_probe, hi * 2)
                recall = recall_at(hi)
            if recall < target_recall:
                self.nprobe = prior = hi
                return recall
            # binary search down to the smallest passing nprobe
            best_probe, best_recall = hi, recall
            while lo + 1 < hi:
                mid = (lo + hi) // 2
                r = recall_at(mid)
                if r >= target_recall:
                    hi, best_probe, best_recall = mid, mid, r
                else:
                    lo = mid
            self.nprobe = best_probe
            prior = best_probe
            return best_recall
        finally:
            if self.nprobe != prior:
                self.nprobe = prior

    def tune_filtered(
        self,
        queries: np.ndarray,
        slot_mask: np.ndarray,
        k: int = 10,
        target_recall: float = 0.95,
        max_boost: int = 64,
    ) -> float:
        """Calibrate the filtered probe boost of ``slot_mask``'s
        selectivity bin on a bounded factor ladder, both ways: escalate
        until filtered recall@k meets ``target_recall`` (against the
        exact masked scan), or de-escalate to the smallest rung that
        still holds it. Returns the recall at the pinned factor."""
        self._build_if_stale()
        if not self.is_trained:
            return 1.0
        queries = self._prep(queries)
        slot_mask = np.asarray(slot_mask, bool)
        sel = self._mask_selectivity(slot_mask)
        if sel < FILTER_EXACT_THRESHOLD:
            return 1.0  # this bin already routes to the exact masked scan
        bin_ = _boost_bin(sel)
        _, exact = self._oracle_search(queries, k, slot_mask)
        exact_sets = [
            set(int(s) for s in row if s >= 0) or {-1} for row in exact
        ]
        nlist = int(self._centroids.shape[0])
        fallback = self.batch_flat_fallback
        self.batch_flat_fallback = False  # measure the real scan path

        def recall_at(factor: int) -> float:
            self._filter_boosts[bin_] = factor
            _, got = self.search(queries, k, slot_mask=slot_mask)
            return float(np.mean([
                len(e & set(int(s) for s in g)) / len(e)
                for e, g in zip(exact_sets, got)
            ]))

        ladder = [f for f in _BOOST_LADDER if f <= max_boost]
        try:
            at_least = [
                i for i, f in enumerate(ladder)
                if f >= _DEFAULT_BOOSTS[bin_]
            ]
            start = at_least[0] if at_least else len(ladder) - 1
            rec = recall_at(ladder[start])
            if rec >= target_recall:
                lo, hi = 0, start  # hi passes
                best = (start, rec)
                while lo < hi:
                    mid = (lo + hi) // 2
                    r = recall_at(ladder[mid])
                    if r >= target_recall:
                        hi, best = mid, (mid, r)
                    else:
                        lo = mid + 1
                self._filter_boosts[bin_] = ladder[best[0]]
                return best[1]
            for i in range(start + 1, len(ladder)):
                rec = recall_at(ladder[i])
                saturated = ladder[i] * self.nprobe >= nlist
                if rec >= target_recall or saturated:
                    return rec
            return rec
        finally:
            self.batch_flat_fallback = fallback

    def _oracle_search(self, queries, k, slot_mask=None):
        """The flat route, whatever the plan: tune()'s and
        tune_filtered()'s recall oracle."""
        queries = self._prep(queries)
        with self._mu.read():
            plan = Plan(exact=True, mask=self._row_mask(slot_mask))
            return self.resolve_pipelined(self._enqueue(queries, k, plan))

    # the JAX package's name for the masked oracle
    _oracle_search_masked = _oracle_search

    # -- persistence ---------------------------------------------------------
    # ``<path>.ivf.npz`` holds the trained overlay (bf16 tables as uint16
    # bits), ``<path>.ivf.json`` its scalars, beside the flat checkpoint:
    # the JAX package's format, so checkpoints move between the two.
    def save(self, path: str, skip_slab: bool = False) -> None:
        with self._mu.read():
            FlatIndex._save_locked(self, path, skip_slab=skip_slab)
            overlay = (self._overlay_host_arrays() if self.is_trained
                       else None)
            if not self._is_lead():
                self._barrier()
                return
            if overlay is not None:
                np.savez(path + ".ivf.npz", **overlay)
            with open(path + ".ivf.json", "w") as f:
                json.dump({
                    "nlist": self.nlist,
                    "nprobe": self.nprobe,
                    "trained": self.is_trained,
                    "built_size": self._built_size,
                    "residual_base": self._residual_base,
                    "quarantine": self._quarantine,
                }, f)
            self._barrier()

    def _overlay_host_arrays(self) -> dict[str, np.ndarray] | None:
        """The trained overlay as the ``.ivf.npz`` sidecar holds it (on
        the rank that writes it; None on the others)."""
        arrays = dict(
            centroids=self._centroids.cpu().numpy(),
            bucket_slot=self._bucket_slot.cpu().numpy(),
            bucket_valid=self._bucket_valid.cpu().numpy(),
            bucket_rows=slab_to_numpy(self._bucket_rows),
            residual=np.asarray(self._residual, np.int32),
        )
        if self._bucket_scale is not None:
            arrays["bucket_scale"] = self._bucket_scale.cpu().numpy()
        return arrays

    def load(self, path: str) -> bool:
        with self._mu.write():
            if not FlatIndex._load_locked(self, path):
                return False
            self._reset_overlay()
            if not os.path.exists(path + ".ivf.json"):
                return True
            with open(path + ".ivf.json") as f:
                meta = json.load(f)
            self.nlist = meta["nlist"]
            self.nprobe = meta["nprobe"]
            self._built_size = meta.get("built_size", 0)
            self._residual_base = int(meta.get("residual_base", 0))
            self._quarantine = [int(s) for s in meta.get("quarantine", [])]
            if meta.get("trained") and os.path.exists(path + ".ivf.npz"):
                with np.load(path + ".ivf.npz") as data:
                    arrays = {key: data[key] for key in data.files}
                self._install_tables(arrays)
            return True

    def _install_tables(self, arrays: dict) -> None:
        """Install a trained overlay from host arrays (a ``.ivf.npz``
        sidecar's): the slot -> bucket tables are rebuilt from the
        validity table."""
        dev = self.device
        rows = arrays["bucket_rows"]
        table_dtype = {"uint16": torch.bfloat16, "bfloat16": torch.bfloat16,
                       "int8": torch.int8, "float32": torch.float32}
        self._bucket_rows = slab_from_numpy(
            rows, table_dtype[rows.dtype.name]).to(dev)
        self._centroids = torch.from_numpy(
            np.array(arrays["centroids"], np.float32)).to(dev)
        bs = np.array(arrays["bucket_slot"], np.int32)
        bv = np.array(arrays["bucket_valid"], bool)
        self._bucket_slot = torch.from_numpy(bs).to(dev)
        self._bucket_valid = torch.from_numpy(bv).to(dev)
        if "bucket_scale" in arrays:
            self._bucket_scale = torch.from_numpy(
                np.array(arrays["bucket_scale"], np.float32)).to(dev)
        self._residual = [int(s) for s in arrays["residual"]]
        cs, ps = np.nonzero(bv)
        self._slot_bucket_c, self._slot_bucket_p = _pack_slot_positions(
            bs[cs, ps], cs.astype(np.int32), ps.astype(np.int32),
            self._cap, max(1, self.assignments),
        )

    def get_stats(self) -> dict:
        stats = super().get_stats()
        stats.update(
            nlist=self.nlist,
            nprobe=self.nprobe,
            trained=self.is_trained,
            residual=len(self._residual),
        )
        return stats
