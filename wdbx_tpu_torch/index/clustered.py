"""Cluster-ordered IVF: the bucket table IS the slab.

Torch port of ``wdbx_tpu/index/clustered.py``. ``build()`` reorders the
slab into bucket order, so each bucket occupies one contiguous row range
``[bucket_start[p], bucket_start[p+1])`` and a probe reads contiguous
rows, at no extra corpus bytes (bookkeeping adds ~9 bytes a row).

  * **Stable slots.** External slot ids never change across rebuilds: a
    slot <-> position indirection (two host int32 arrays) maps the
    store's handles to physical rows.
  * **Block scan.** The slab is viewed as ``(cap/c, c, d)`` blocks; a
    probed bucket expands to its covering blocks, and the probed
    multiset of a batch dedups to unique blocks (``_dedup_blocks``),
    each scored once against the whole batch. Rows of other buckets
    that share a scanned block are extra candidates with true scores.
    On the CUDA device the scan is the hand-written block-scan kernel
    (``kernels/clustered_scan.py``, K3 / K4).
  * **Mutation.** Fresh adds land at or above a block-aligned boundary
    past the clustered region and are brute-scanned through the
    residual list; deletes tombstone and quarantine their position until
    the next build (or a bucket-matched reuse); updates MOVE the row.
    Scanned blocks and the residual rows are therefore disjoint.
  * **Streaming two-pass build.** ``build_from()`` ingests a re-iterable
    chunk source straight into cluster order (pass 1 trains and assigns,
    pass 2 writes), keeping the device peak at slab + one chunk.

Differences from the JAX engine, all deliberate: query batches are not
padded to a power of two (``pad_b`` still chooses the path and sizes the
dedup, so the port scans the blocks JAX scans for the real queries; the
JAX pad rows' own probes of buckets 0..P-1 do not exist here); no pad
positions one past the slab anywhere (residual lists, scatters and
tombstones are sliced to their live entries); the portable scan selects
exactly (``torch.topk`` for ``approx_max_k``); the ``_pos_mask`` cache
is keyed on the write counter ``_gen`` (writes go in place here, so the
identity of ``_valid`` no longer changes on a write). The on-disk format
(``.ivfc.npz`` + ``.ivfc.json`` beside the flat checkpoint) is the JAX
package's, so checkpoints move between the two.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Any

import numpy as np
import torch

from wdbx_tpu_torch.index.flat import FlatIndex, _next_pow2, to_tensor
from wdbx_tpu_torch.index.ivf import (
    FILTER_EXACT_THRESHOLD,
    IVFIndex,
    _filter_boost,
    _probes,
    _residual_merge,
)
from wdbx_tpu_torch.kernels.quant import unpack_int4
from wdbx_tpu_torch.ops.kmeans import kmeans
from wdbx_tpu_torch.ops.normalize import l2_normalize

logger = logging.getLogger("wdbx_tpu_torch.index")


def _assign_blocked(rows: torch.Tensor, centroids: torch.Tensor,
                    block: int = 8192) -> np.ndarray:
    """Nearest-centroid assignment on bf16-rounded rows and centroids
    with float32 accumulation, as the JAX version scores it, ``block``
    rows at a time so the (rows, nlist) score tile stays small. The
    products of bf16 operands are exact in float32; the process-wide
    TF32 switch is left alone, since searches run on other threads while
    a background build assigns. Returns int32 numpy."""
    cents = centroids.to(torch.bfloat16).to(torch.float32)
    out = []
    for i in range(0, rows.shape[0], block):
        chunk = rows[i:i + block].to(torch.bfloat16).to(torch.float32)
        out.append(torch.argmax(chunk @ cents.T, dim=-1))
    if not out:
        return np.empty(0, np.int32)
    return torch.cat(out).to(torch.int32).cpu().numpy()


def _block_rows(dim: int, itemsize: int, cap: int,
                target: int = 786_432) -> int:
    """Rows per scan block: about ``target`` bytes a block, a power of
    two that divides the capacity."""
    c = _next_pow2(max(256, target // max(1, dim * itemsize)))
    c = min(c, 4096)
    while cap % c != 0 and c > 1:
        c //= 2
    return max(1, c)


def _dedup_blocks(probe: torch.Tensor, blk_lo: torch.Tensor,
                  blk_hi: torch.Tensor, nblocks: int, u: int, m: int,
                  valid: torch.Tensor | None = None, c: int | None = None):
    """Expand probed buckets to covering blocks and dedup to ``u``
    popularity-ranked unique block ids: ``(uniq, ok)``, int64 ids and a
    bool live flag, live entries first (most-probed first), the rest
    pinned to block ``nblocks - 1``. ``valid`` (the (cap,) live mask,
    ``c`` rows per block) drops blocks with no live row before the
    ranking. Entry for entry the JAX function, including its int32
    clamp of the counts."""
    dev = probe.device
    lo = blk_lo[probe]
    hi = blk_hi[probe]
    blocks = lo[..., None] + torch.arange(m, dtype=lo.dtype, device=dev)
    in_range = blocks < hi[..., None]
    if valid is not None:
        blk_live = valid[: nblocks * c].reshape(nblocks, c).any(dim=1)
        in_range = in_range & blk_live[blocks.clamp(0, nblocks - 1)]
    flat = torch.where(in_range, blocks,
                       torch.full_like(blocks, nblocks)).reshape(-1)
    bp = flat.shape[0]
    u = min(u, bp)
    sorted_ids = torch.sort(flat).values
    is_first = torch.ones(bp, dtype=torch.bool, device=dev)
    is_first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    is_first = is_first & (sorted_ids < nblocks)
    counts = (torch.searchsorted(sorted_ids, sorted_ids, right=True)
              - torch.searchsorted(sorted_ids, sorted_ids, right=False))
    # the JAX ranking keeps counts * bp inside int32; the same clamp
    # keeps the same order here
    counts = torch.clamp_max(counts, (2**31 - 1 - bp) // bp)
    prio = torch.where(
        is_first,
        counts * bp + (bp - torch.arange(bp, device=dev)),
        torch.zeros_like(counts),
    )
    sel = torch.topk(prio, u).indices
    uniq_ok = is_first[sel]
    uniq = torch.where(
        uniq_ok, torch.clamp_max(sorted_ids[sel], nblocks - 1),
        torch.full_like(sel, nblocks - 1),
    )
    return uniq, uniq_ok


def _clustered_search(slab, valid, scales, centroids, blk_lo, blk_hi,
                      residual_pos, q, k, nprobe, u, m, c, precision,
                      int8=False, normalize=False, int4=False, pad_b=None):
    """The portable block scan (the JAX lax path): the kernel path's
    block list, cut to the ``steps * g`` entries JAX's scan walks, the
    kernel's plain version over it, and the residual merge. JAX keeps
    each step's top-k of ``g`` blocks, then the top-k of the steps; with
    exact selection that is one top-k over the cut list. ``pad_b`` is
    the JAX batch width that bounds ``u`` (the tensors are not
    padded)."""
    from wdbx_tpu_torch.kernels.clustered_scan import (
        clustered_block_topk_plain,
    )

    q, uniq, uniq_ok = _kernelpath_list(
        slab, valid, centroids, blk_lo, blk_hi, q, nprobe, u, m, c,
        precision, normalize, pad_b,
    )
    u = min(u, (pad_b or q.shape[0]) * min(nprobe, centroids.shape[0]) * m)
    g = max(1, min(8, 8192 // c, u))
    # the tail past steps * g holds the lowest-priority dedup slots
    n_scan = max(1, u // g) * g
    kv, kp = clustered_block_topk_plain(
        slab, valid, scales if (int8 or int4) else None, uniq[:n_scan],
        uniq_ok[:n_scan], q, k, c, int4=int4,
    )
    return _residual_merge(
        slab, valid, residual_pos, scales, kv, kp, q, k=k,
        precision=precision, int8=int8, int4=int4,
    )


def _clustered_search_ranges(slab, valid, scales, centroids, row_lo,
                             row_cnt, residual_pos, q, k, nprobe, L,
                             precision, int8=False, normalize=False,
                             int4=False):
    """Small-batch latency path: each query scores its probed buckets'
    exact row ranges (slices of ``L`` rows starting at the bucket start
    rounded down to 512 rows, masked to the bucket). A query only sees
    its own probes, so shared buckets give no duplicate candidates."""
    if normalize:
        q = l2_normalize(q)
    b = q.shape[0]
    cap = slab.shape[0]
    probe = _probes(q, centroids, nprobe, precision)  # (B, P)
    p_eff = probe.shape[1]
    ls = min(L, cap)
    lo = row_lo[probe]
    cnt = row_cnt[probe]
    start = torch.clamp((lo // 512) * 512, 0, cap - ls)
    pos = start[..., None] + torch.arange(ls, device=slab.device)  # (B,P,L)
    rows = slab[pos.reshape(-1)]
    if int4:
        rows = unpack_int4(rows)
    quant = int8 or int4
    if quant:
        qf = q.to(torch.bfloat16).to(torch.float32)
    else:
        qf = q.to(rows.dtype).to(torch.float32)
    rf = rows.to(torch.float32).reshape(b, p_eff * ls, -1)
    if precision == "highest":
        from wdbx_tpu_torch.ops.exact_search import true_f32

        with true_f32():
            s = torch.bmm(rf, qf[:, :, None])[..., 0]
    else:
        s = torch.bmm(rf, qf[:, :, None])[..., 0]  # (B, P*L)
    flat_pos = pos.reshape(b, -1)
    if quant:
        s = s * scales[flat_pos]
    in_bucket = (valid[flat_pos] & (pos >= lo[..., None]).reshape(b, -1)
                 & (pos < (lo + cnt)[..., None]).reshape(b, -1))
    s = torch.where(in_bucket, s, float("-inf"))
    kv, sel = torch.topk(s, min(k, s.shape[-1]), dim=-1)
    kp = torch.gather(flat_pos, -1, sel)
    return _residual_merge(
        slab, valid, residual_pos, scales, kv, kp, q, k=k,
        precision=precision, int8=int8, int4=int4,
    )


def _kernelpath_list(slab, valid, centroids, blk_lo, blk_hi, q, nprobe, u,
                     m, c, precision, normalize=False, pad_b=None):
    """The kernel path's block list: ``(q, uniq, ok)``, the (normalized)
    queries and the deduplicated blocks of their probes."""
    if normalize:
        q = l2_normalize(q)
    probe = _probes(q, centroids, nprobe, precision)
    nblocks = slab.shape[0] // c
    u = min(u, (pad_b or q.shape[0]) * min(nprobe, centroids.shape[0]) * m)
    uniq, uniq_ok = _dedup_blocks(probe, blk_lo, blk_hi, nblocks, u, m,
                                  valid=valid, c=c)
    return q, uniq, uniq_ok


def _clustered_search_kernelpath(slab, valid, scales, centroids, blk_lo,
                                 blk_hi, residual_pos, q, k, nprobe, u, m, c,
                                 precision, int8=False, normalize=False,
                                 int4=False, kern="v1", qprec="bf16",
                                 pad_b=None):
    """The kernel path: probe selection, block dedup, the block-scan
    kernel (K3 ``clustered_block_topk_v2``, or K4 ``clustered_block_topk``
    for ``kern="v1"``; their plain version on CPU tensors) and the
    residual merge, with no host synchronisation."""
    from wdbx_tpu_torch.kernels.clustered_scan import (
        clustered_block_topk,
        clustered_block_topk_v2,
    )

    q, uniq, uniq_ok = _kernelpath_list(
        slab, valid, centroids, blk_lo, blk_hi, q, nprobe, u, m, c,
        precision, normalize, pad_b,
    )
    quant = int8 or int4
    sc = scales if quant else None
    if kern == "v2" or int4:
        kv, kp = clustered_block_topk_v2(
            slab, valid, sc, uniq, uniq_ok, q, k=k, c=c, int4=int4,
            qprec=qprec,
        )
    else:
        kv, kp = clustered_block_topk(slab, valid, sc, uniq, uniq_ok, q,
                                      k=k, c=c)
    return _residual_merge(
        slab, valid, residual_pos, scales, kv, kp, q, k=k,
        precision=precision, int8=int8, int4=int4,
    )


class ClusteredSlotMixin:
    """Slot <-> position bookkeeping and mutation rules of the
    cluster-ordered layout.

    Invariant while trained: every live position below the block-aligned
    clustered boundary (``_fresh_base``) was placed by a build or was
    recycled into a hole inside its own assigned bucket's extent (see
    ``_place_batch``); fresh rows otherwise take positions at or above
    the boundary. Freed clustered-region positions are quarantined per
    bucket, and updates move the row, so the block scan and the residual
    scan never overlap and every scanned row belongs to the bucket whose
    extent covers it. The kernel path relies on this to skip per-row
    bucket masking.
    """

    #: reuse quarantined clustered-region holes for inserts / updates
    #: whose nearest centroid matches the hole's bucket (IVF_RECYCLE_HOLES)
    recycle_holes = True

    # ``self._quar`` maps bucket id -> quarantined positions of that
    # bucket's extent (-1: bucket unknown, never recycled, only counted)

    @property
    def _pos_quarantine(self) -> list[int]:
        return self._quar_flat()

    def _quar_len(self) -> int:
        # a plain int kept under the write lock: the lock-free
        # _needs_build() pre-check reads it without iterating the dict
        return self._quar_n

    def _quar_flat(self) -> list[int]:
        return [p for holes in self._quar.values() for p in holes]

    def _quarantine_positions(self, pos: np.ndarray) -> None:
        pos = np.asarray(pos, np.int64)
        if len(pos) == 0:
            return
        for p, b in zip(pos.tolist(), self._bucket_of_pos(pos).tolist()):
            self._quar.setdefault(int(b), []).append(int(p))
        self._quar_n += len(pos)

    def _place_batch(self, vectors, n: int):
        """Physical positions for ``n`` prepped rows: each row fills a
        quarantined hole of its nearest centroid's bucket when one is
        free (the build's bf16 assignment rule), else takes a residual-
        region position. Returns ``(pos, fresh)``, ``fresh`` marking the
        residual-region rows."""
        recyclable = (
            n > 0 and self.is_trained and self.recycle_holes
            and any(b >= 0 and holes for b, holes in self._quar.items())
        )
        if not recyclable:
            return self._take_slots(n), np.ones(n, bool)
        rows = to_tensor(vectors, self.device, torch.float32)
        if self.metric == "cosine":
            rows = l2_normalize(rows)
        buckets = _assign_blocked(rows, self._centroids)
        pos = np.full(n, -1, np.int64)
        for i, b in enumerate(buckets.tolist()):
            holes = self._quar.get(b)
            if holes:
                pos[i] = holes.pop()
                self._quar_n -= 1
                if not holes:
                    del self._quar[b]
        fresh = pos < 0
        n_fresh = int(fresh.sum())
        if n_fresh:
            pos[fresh] = self._take_slots(n_fresh)
        return pos, fresh

    def _take_ext_slots(self, n: int) -> np.ndarray:
        slots = []
        while self._free_slots and len(slots) < n:
            slots.append(self._free_slots.pop())
        fresh = n - len(slots)
        if fresh:
            slots.extend(
                range(self._next_ext_slot, self._next_ext_slot + fresh)
            )
            self._next_ext_slot += fresh
        return np.asarray(slots, np.int64)

    def _map_pos_to_slots(self, scores: np.ndarray, pos: np.ndarray):
        """Translate physical positions to stable external slot ids."""
        out = self._slot_of[np.clip(pos, 0, self._cap - 1)].astype(np.int64)
        out[(pos < 0) | (scores == -np.inf)] = -1
        return scores, out

    def _positions_of(self, slots) -> np.ndarray:
        idx = np.asarray(slots, np.int64)
        return self._pos_of[np.clip(idx, 0, self._cap - 1)].astype(np.int64)

    # -- mutation -----------------------------------------------------------
    def add_batch(self, vectors) -> np.ndarray:
        with self._mu.write():
            vectors = self._prep(vectors)
            n = len(vectors)
            pos, fresh = self._place_batch(vectors, n)
            self._scatter(pos, vectors, True)
            self._size += n
            slots = self._take_ext_slots(n)
            self._slot_of[pos] = slots.astype(np.int32)
            self._pos_of[slots] = pos.astype(np.int32)
            if self.is_trained:
                self._residual.extend(int(p) for p in pos[fresh])
            if self._cow_writes:
                for s in slots:
                    self._bg_journal[int(s)] = "dirty"
            return slots

    def update_slots(self, slots: np.ndarray, vectors) -> None:
        slots = np.asarray(slots, np.int64)
        if not isinstance(vectors, torch.Tensor):
            vectors = np.asarray(vectors)
        if len(slots) != len(np.unique(slots)):
            # duplicate slot ids in one batch: the last row wins
            _, idx_rev = np.unique(slots[::-1], return_index=True)
            keep = np.sort(len(slots) - 1 - idx_rev)
            slots, vectors = slots[keep], vectors[keep]
        with self._mu.write():
            if self._cow_writes:
                for s in slots:
                    self._bg_journal[int(s)] = "dirty"
            vectors = self._prep(vectors)
            pos = self._positions_of(slots)
            known = pos >= 0
            slots = slots[known]
            if not known.all():
                vectors = vectors[known]
            if len(slots) == 0:
                return
            pos = pos[known]
            if not self.is_trained:
                self._scatter(pos, vectors, True)
                return
            # move-on-update: tombstone the old position (quarantined in
            # the clustered region, recycled above it) and land the new
            # row in a bucket-matched hole or above the boundary
            self._tombstone_positions(pos)
            # clear the moved-from label now: a stale label at a dead
            # position would survive save/load and alias the slot
            self._slot_of[pos] = -1
            clustered = pos < self._fresh_base
            self._quarantine_positions(pos[clustered])
            self._free.extend(int(p) for p in pos[~clustered])
            gone = set(int(x) for x in pos[~clustered])
            self._residual = [p for p in self._residual if p not in gone]
            new_pos, fresh = self._place_batch(vectors, len(slots))
            self._scatter(new_pos, vectors, True)
            self._slot_of[new_pos] = slots.astype(np.int32)
            self._pos_of[slots] = new_pos.astype(np.int32)
            self._residual.extend(int(p) for p in new_pos[fresh])

    def _tombstone_positions(self, pos: np.ndarray) -> None:
        self._tombstone(self._slot_tensor(pos))

    def remove_slots(self, slots: np.ndarray) -> None:
        slots = np.unique(np.asarray(slots, np.int64))
        if len(slots) == 0:
            return
        with self._mu.write():
            pos = self._positions_of(slots)
            known = pos >= 0  # unknown slots are a no-op
            slots, pos = slots[known], pos[known]
            if len(slots) == 0:
                return
            if self._cow_writes:
                for s in slots:
                    self._bg_journal[int(s)] = "removed"
            self._tombstone_positions(pos)
            self._size -= len(slots)
            # external slots recycle at once; clustered-region positions
            # quarantine until the next build, residual-region ones
            # (never block-scanned) recycle at once
            if self.is_trained:
                clustered = pos < self._fresh_base
                self._quarantine_positions(pos[clustered])
                self._free.extend(int(p) for p in pos[~clustered])
                res = set(int(p) for p in pos)
                self._residual = [p for p in self._residual if p not in res]
            else:
                self._free.extend(int(p) for p in pos)
            self._free_slots.extend(int(s) for s in slots)
            self._slot_of[pos] = -1
            self._pos_of[slots] = -1

    def _adopt_foreign_checkpoint(self, path: str) -> bool:
        """``load`` found no clustered sidecar: flat / IVF checkpoints
        (rows at slot == position) are adopted with identity slot maps
        (untrained until the next build); a same-kind checkpoint without
        its sidecar is corrupt and any other kind is refused."""
        meta_file = path + ".meta.json"
        src_kind = self.kind
        if os.path.exists(meta_file):
            with open(meta_file) as f:
                src_kind = json.load(f).get("kind", self.kind)
        if src_kind == self.kind:
            raise ValueError(
                f"checkpoint at {path!r} is kind {src_kind!r} but its "
                "clustered sidecar file is missing — refusing partial load"
            )
        if src_kind not in ("flat", "ivf", "sharded_flat", "sharded_ivf"):
            raise ValueError(
                f"cannot load a {src_kind!r} checkpoint "
                f"into a {self.kind!r} index"
            )
        hwm = self._next_slot
        live = np.ones(hwm, bool)
        free_live = [int(p) for p in self._free if p < hwm]
        live[free_live] = False
        pos = np.arange(hwm, dtype=np.int32)[live]
        self._slot_of[pos] = pos
        self._pos_of[pos] = pos
        self._next_ext_slot = hwm
        self._free_slots = list(free_live)
        return True

    # -- shared query helpers -----------------------------------------------
    def _scan_rows(self) -> int:
        return self._cap

    def _scan_u(self, pad_b: int, nprobe: int, geom: dict | None = None
                ) -> int:
        """Dedup scan length: the smaller of the worst case (prefix sum
        of the largest buckets' block counts for ``pad_b * nprobe``
        probes) and 1.5x the expected distinct-bucket count times the
        mean blocks per bucket, as a power of two. ``geom`` overrides
        the block geometry (the narrow latency path passes
        ``self._small``)."""
        if geom is None:
            geom = dict(
                c=self._c, m=self._m, u_prefix=self._u_prefix,
                nonempty=self._nonempty, avg_blocks=self._avg_blocks,
            )
        pref = geom["u_prefix"]
        nblocks = self._scan_rows() // geom["c"]
        draws = pad_b * nprobe
        worst = int(pref[min(draws, len(pref)) - 1]) if len(pref) else 1
        ne = max(1, geom["nonempty"])
        e_distinct = ne * (1.0 - (1.0 - 1.0 / ne) ** draws)
        expected = int(
            math.ceil(1.5 * e_distinct * geom["avg_blocks"])
        ) + 8
        return min(_next_pow2(max(1, min(worst, expected)) + 1),
                   _next_pow2(max(1, nblocks)), draws * geom["m"])

    def _use_ranges(self, pad_b: int, nprobe: int) -> bool:
        """Route small batches to the exact-bucket-range scan when the
        probes' read (every slice is the static max-bucket length L)
        stays within 8 MB."""
        lp = getattr(self, "latency_path", "auto")
        if lp in ("narrow", "wide"):
            return False
        if getattr(self, "_row_lo", None) is None:
            return False
        if lp == "ranges":
            return True
        bytes_per_row = self._slab.shape[1] * self._slab.element_size()
        read = self._range_L * min(nprobe, len(self._row_cnt))
        return (
            pad_b <= self.small_batch_threshold
            and read * bytes_per_row <= 1 << 23
        )

    def _kernel_gen(self) -> str:
        """Kernel generation of the kernel path ("v1" / "v2"); int4
        needs v2, and "auto" picks v2."""
        kv = getattr(self, "kernel_version", "auto")
        if kv in ("v1", "v2"):
            if kv == "v1" and self._is_int4:
                return "v2"
            return kv
        return "v2"

    #: deepest k the kernel path serves; beyond it the portable scan
    #: takes over (the JAX package's routing; KERNEL_K_MAX in config)
    KERNEL_K_MAX = 128

    def _use_kernel(self, k: int = 1) -> bool:
        """Block-scan kernel vs the portable scan: "auto" takes the
        kernel when the index lives on the CUDA device, "pallas" forces
        the kernel path (its plain version on the CPU), "lax" forces the
        portable scan."""
        if k > self.KERNEL_K_MAX:
            return False
        if self.ivf_kernel == "pallas":
            return True
        return self.ivf_kernel == "auto" and self.device.type == "cuda"

    def _needs_build(self) -> bool:
        if IVFIndex._needs_build(self):
            return True
        # tombstone bloat: quarantined positions return to service only
        # at a rebuild, so heavy delete churn triggers one
        return bool(self._built_size) and (
            self._quar_len() > self.rebuild_fraction * self._built_size
        )

    def _pos_mask(self, slot_mask) -> np.ndarray | None:
        """A slot-indexed filter mask in position space, cached by the
        mask object's identity and the write and layout generations
        (every write bumps ``_gen``; the cache holds the mask so its id
        cannot be recycled while cached)."""
        if slot_mask is None:
            return None
        cache = getattr(self, "_posmask_cache", None)
        if cache is None:
            cache = self._posmask_cache = {}
        key = (id(slot_mask), self._gen, getattr(self, "_layout_gen", 0))
        hit = cache.get(key)
        if hit is not None:
            return hit[1]
        mask = np.zeros(self._cap, bool)
        n = min(len(slot_mask), self._cap)
        sel = np.nonzero(slot_mask[:n])[0]
        pos = self._pos_of[sel]
        mask[pos[pos >= 0]] = True
        while len(cache) >= 4:
            cache.pop(next(iter(cache)))
        cache[key] = (slot_mask, mask)
        return mask

    def _mask_selectivity(self, slot_mask) -> float:
        """Fraction of live rows the mask passes, counted in position
        space."""
        pm = self._pos_mask(slot_mask)
        return float(pm.sum()) / max(1, self._size)

    def _oracle_search_masked(self, queries, k, slot_mask):
        pm = self._pos_mask(slot_mask)
        scores, pos = self._exact_masked_base(queries, k, pm)
        return self._map_pos_to_slots(scores, pos)

    def _exact_masked_base(self, queries, k, pos_mask):
        return FlatIndex.search(self, queries, k, pos_mask)

    def _filter_plan(self, slot_mask, nprobe: int, nlist: int):
        """Plan a filtered search: ``(pos_mask, nprobe_eff, exact)``.
        Pushdown ANDs the position mask into row validity and boosts
        nprobe by the selectivity bin's factor; filters under
        ``FILTER_EXACT_THRESHOLD`` take the exact masked scan."""
        pm = self._pos_mask(slot_mask)
        if pm is None:
            return None, nprobe, False
        sel = float(pm.sum()) / max(1, self._size)
        if sel < FILTER_EXACT_THRESHOLD:
            return pm, nprobe, True
        boost = _filter_boost(sel, getattr(self, "_filter_boosts", None))
        return pm, min(nlist, nprobe * boost), False

    # -- background-rebuild journal: off-lock drain + swap-time replay -------
    # Every slot journaled during the copy-on-write window has a stale
    # snapshot row: its position in the new layout is invalidated and,
    # if it is still live ("dirty"), its current row is replayed into
    # the fresh region. _prestage_bg_journal and _prepare_bg_swap run off
    # the lock; _bg_dirty_rows and _bg_delta_fixup pay only the final
    # delta under it.

    def _bg_dirty_rows(self, journal, fetch_rows, staged=None,
                       refetch=None):
        """Current rows of the journal's surviving "dirty" slots for the
        swap-time replay: staged copies where they are still current,
        a fresh fetch for the rest (and for ``refetch``)."""
        dirty = np.asarray(
            sorted(s for s, v in journal.items() if v == "dirty"),
            np.int64,
        )
        rows = None
        if len(dirty):
            cur_pos = self._positions_of(dirty)
            known = cur_pos >= 0
            dirty = dirty[known]
            cur_pos = cur_pos[known]
            if len(dirty):
                stage_of, staged_rows = staged if staged else ({}, None)
                rf = refetch if refetch is not None else ()
                hit = np.asarray(
                    [int(s) in stage_of and int(s) not in rf
                     for s in dirty], bool
                ) if staged_rows is not None else np.zeros(len(dirty), bool)
                if staged_rows is not None and hit.any():
                    n_staged = int(staged_rows.shape[0])
                    sel = np.zeros(len(dirty), np.int64)
                    sel[hit] = [stage_of[int(s)] for s in dirty[hit]]
                    pool = staged_rows
                    if (~hit).any():
                        fetched = to_tensor(
                            np.asarray(fetch_rows(cur_pos[~hit]), np.float32),
                            self.device,
                        )
                        pool = torch.cat([staged_rows, fetched], dim=0)
                        sel[~hit] = n_staged + np.arange(int((~hit).sum()))
                    rows = pool[torch.as_tensor(sel, device=self.device)]
                else:
                    rows = np.asarray(fetch_rows(cur_pos), np.float32)
        return dirty, rows

    def _prepare_bg_swap(self, snap_slot_of, src, dest, merged, cap):
        """Post-swap slot maps computed off the write lock; journaled
        slots are dropped. Returns ``(new_slot_of, new_pos_of,
        pre_dead)``."""
        slot_at_dest = snap_slot_of[src].copy()
        if merged:
            drop = np.fromiter(merged, np.int64, len(merged))
            hit = np.isin(slot_at_dest, drop)
            pre_dead = dest[hit]
            slot_at_dest[hit] = -1
        else:
            pre_dead = np.empty(0, np.int64)
        new_slot_of = np.full(cap, -1, np.int32)
        new_slot_of[dest] = slot_at_dest
        new_pos_of = np.full(cap, -1, np.int32)
        keep = slot_at_dest >= 0
        new_pos_of[slot_at_dest[keep]] = dest[keep].astype(np.int32)
        return new_slot_of, new_pos_of, pre_dead

    @staticmethod
    def _bg_delta_fixup(delta, new_slot_of, new_pos_of):
        """Null the prebuilt maps' entries of slots that mutated after
        ``_prepare_bg_swap`` (write lock held). Returns the extra new
        positions to invalidate."""
        extra_dead = []
        for s in delta:
            s = int(s)
            if s < len(new_pos_of):
                i = int(new_pos_of[s])
                if i >= 0:
                    new_slot_of[i] = -1
                    new_pos_of[s] = -1
                    extra_dead.append(i)
        return np.asarray(extra_dead, np.int64)

    def _prestage_bg_journal(self, fetch_rows, snap_gen,
                             rounds: int = 4, quiet: int = 8):
        """Iterative off-lock drain of the copy-on-write window's
        journal: each round swaps the journal for a fresh one under a
        brief write lock, then fetches the drained dirty slots' rows with
        no lock held; later mutations re-journal, so the last copy wins.
        Returns ``(merged_journal, (stage_of, staged_rows))``."""
        merged: dict[int, str] = {}
        slots_acc: list[int] = []
        rows_acc: list[np.ndarray] = []
        failed: set[int] = set()
        for _ in range(rounds):
            with self._mu.write():
                if (getattr(self, "_layout_gen", 0) != snap_gen
                        or not self._cow_writes):
                    break  # window invalidated: the swap will abandon
                j = self._bg_journal
                if not j:
                    break
                self._bg_journal = {}
                dirty = np.asarray(
                    sorted(s for s, v in j.items() if v == "dirty"),
                    np.int64,
                )
                pos = self._positions_of(dirty) if len(dirty) else None
            merged.update(j)
            if pos is not None:
                known = pos >= 0
                if known.any():
                    try:
                        rows = np.asarray(
                            fetch_rows(pos[known]), np.float32
                        )
                    except (RuntimeError, IndexError, ValueError):
                        # a racing clear()/load() broke the off-lock
                        # gather: abandon staging; this round's dirty
                        # slots must not resolve to an older staged copy
                        failed.update(int(s) for s in dirty)
                        break
                    slots_acc.extend(int(s) for s in dirty[known])
                    rows_acc.append(rows)
            if len(j) <= quiet:
                break
        staged_rows = None
        if rows_acc:
            staged_rows = to_tensor(np.concatenate(rows_acc, axis=0),
                                    self.device)
        stage_of = {
            s: i for i, s in enumerate(slots_acc) if s not in failed
        }
        return merged, (stage_of, staged_rows)

    def _replay_bg_dirty(self, dirty, rows):
        """Re-insert the journal's surviving mutated rows into the fresh
        region of the just-swapped layout, keeping their slot ids (write
        lock held)."""
        pos = self._take_slots(len(dirty))
        self._scatter(pos, rows, True)
        self._slot_of[pos] = dirty.astype(np.int32)
        self._pos_of[dirty] = pos.astype(np.int32)
        self._residual.extend(int(p) for p in pos)


class ClusteredIVFIndex(ClusteredSlotMixin, IVFIndex):
    """IVF whose bucket layout lives in the slab (no side tables).

    Memory: corpus bytes + ~9 bytes a row of bookkeeping. This is the
    engine behind ``INDEX_TYPE`` ``ivf``, ``hnsw``, faiss ``IVF...`` and
    ``ivf_clustered``.
    """

    kind = "ivf_clustered"
    # the layout lives in the flat slab, so slab-external checkpoints
    # reconstruct through _slot_of and the raw rows
    supports_slab_external = True

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
        device: Any = None,
    ):
        super().__init__(
            dim, metric=metric, dtype=dtype, capacity=capacity,
            nlist=nlist, nprobe=nprobe, train_threshold=train_threshold,
            rebuild_fraction=rebuild_fraction, kmeans_iters=kmeans_iters,
            train_sample=train_sample, assignments=1, device=device,
        )
        #: "auto" (the block-scan kernel on the CUDA device, the portable
        #: scan elsewhere), "pallas" (force the kernel path; its plain
        #: version on the CPU) or "lax" (force the portable scan)
        self.ivf_kernel = "auto"
        #: scan-block size in bytes; effective at the next build
        self.block_bytes_target = 786_432
        #: batches at or below this take the narrow-block (c/4) extents
        self.small_batch_threshold = 4
        #: small-batch program: "auto" scans the probed buckets' exact
        #: row ranges when their read is small; "ranges" / "narrow"
        #: force; "wide" keeps the serving blocks
        self.latency_path = "auto"
        #: optimize() uses build_background() (serving keeps the old
        #: layout during the rebuild); IVF_BACKGROUND_REBUILD
        self.background_rebuild = False

    def optimize(self, background: bool | None = None) -> None:
        """Rebuild the clustered layout. ``background`` forces the
        copy-on-write serve-through rebuild on or off for this call;
        ``None`` defers to ``background_rebuild``."""
        if self._size > 0:
            bg = self.background_rebuild if background is None else background
            if bg:
                self.build_background()
            else:
                self.build()

    # -- storage: position space + slot indirection -------------------------
    def _alloc(self, cap: int) -> None:
        super()._alloc(cap)
        self._slot_of = np.full(cap, -1, np.int32)  # pos -> slot
        self._pos_of = np.full(cap, -1, np.int32)  # slot -> pos
        self._free_slots: list[int] = []
        self._next_ext_slot = 0
        # storage replaced wholesale (clear/load): an in-flight
        # background rebuild abandons its snapshot at swap time
        self._layout_gen = getattr(self, "_layout_gen", 0) + 1
        self._cow_writes = False
        self._bg_journal = {}

    def _grow(self, need: int) -> None:
        old_cap = self._cap
        slot_of, pos_of = self._slot_of, self._pos_of
        super()._grow(need)
        so = np.full(self._cap, -1, np.int32)
        so[:old_cap] = slot_of
        self._slot_of = so
        po = np.full(self._cap, -1, np.int32)
        po[:old_cap] = pos_of
        self._pos_of = po

    def _reset_overlay(self) -> None:
        self._centroids = None
        self._centroids_np = None
        self._bucket_start: np.ndarray | None = None  # (nlist+1,) int64
        self._blk_lo = None  # (nlist,) device
        self._blk_hi = None
        self._row_lo = None
        self._row_cnt = None
        self._m = 1  # max blocks per bucket (pow2)
        self._c = 1  # scan-block rows (set by _install_layout)
        self._u_prefix: np.ndarray | None = None
        self._nonempty = 0
        self._avg_blocks = 1.0
        self._small = None
        self._residual: list[int] = []  # POSITIONS of unclustered rows
        self._residual_base = 0
        self._built_size = 0
        self._quar: dict[int, list[int]] = {}
        self._quar_n = 0
        self._fresh_base = 0

    def _bucket_of_pos(self, pos: np.ndarray) -> np.ndarray:
        """Bucket whose extent covers each clustered-region position; -1
        when the layout is unknown."""
        pos = np.asarray(pos, np.int64)
        if self._bucket_start is None:
            return np.full(len(pos), -1, np.int64)
        return np.searchsorted(self._bucket_start, pos, side="right") - 1

    def compact(self):
        """A rebuild is the compaction here; external slots are stable,
        so the returned remap is the identity."""
        with self._mu.write():
            if self.is_trained or self._size >= self.train_threshold:
                self._build_locked()
            else:
                self._compact_untrained_locked()
            live = np.nonzero(self._slot_of >= 0)[0]
            slots = np.sort(self._slot_of[live].astype(np.int64))
            return slots, slots

    def _compact_untrained_locked(self) -> None:
        """Pack live rows below the training threshold (no clustering)."""
        valid = self._valid.cpu().numpy()
        live_pos = np.nonzero(valid)[0]
        n = len(live_pos)
        if n and not (live_pos == np.arange(n)).all():
            rows = FlatIndex.get_vectors(self, live_pos)
            slot_of_live = self._slot_of[live_pos].copy()
            free_slots, next_ext = self._free_slots, self._next_ext_slot
            self._alloc(self._cap)  # resets mappings; slot state restored
            self._free_slots, self._next_ext_slot = free_slots, next_ext
            self._size = 0
            self._free = []
            self._next_slot = 0
            new_pos = FlatIndex.add_batch(self, rows)
            self._size = n
            self._slot_of[new_pos] = slot_of_live
            self._pos_of[:] = -1
            keep = slot_of_live >= 0
            self._pos_of[slot_of_live[keep]] = new_pos[keep].astype(np.int32)
        self._free = []
        self._next_slot = n

    # -- build: permute the slab into cluster order --------------------------
    def build(self) -> None:
        with self._mu.write():
            self._build_locked()

    def _build_locked(self) -> None:
        if self._cow_writes:
            # a background rebuild is in flight and swaps in shortly
            return
        hwm = self._next_slot
        if self._size == 0 or hwm == 0:
            self._reset_overlay()
            return
        valid = self._valid[:hwm].cpu().numpy()
        live_pos = np.nonzero(valid)[0].astype(np.int64)
        centroids, assign = self._cluster_plan(
            self._slab, self._scales, live_pos
        )
        order = np.argsort(assign, kind="stable")
        src = live_pos[order]  # old position of the row landing at dest i
        counts = np.bincount(assign, minlength=len(centroids))
        new_slab, new_valid, new_scales = self._permute(
            self._slab, self._scales, src
        )
        self._install_built(
            src, counts, centroids, new_slab, new_valid, new_scales
        )

    def _cluster_plan(self, slab, scales, live_pos: np.ndarray):
        """Train and assign the live rows of ``slab`` (reads only; no
        index state touched). Returns ``(centroids, assign)`` numpy."""
        n_live = len(live_pos)
        nlist = min(self.nlist, n_live)
        sample = live_pos
        if n_live > self.train_sample:
            sel = np.random.default_rng(0).choice(
                n_live, self.train_sample, replace=False
            )
            sample = live_pos[np.sort(sel)]
        train = self._gather_rows(slab, scales, sample)
        centroids, _ = kmeans(train, num_clusters=nlist,
                              iters=self.kmeans_iters)
        del train
        chunk = 131_072
        assign = np.empty(n_live, np.int32)
        for i in range(0, n_live, chunk):
            end = min(i + chunk, n_live)
            rows = self._gather_rows(slab, scales, live_pos[i:end])
            assign[i:end] = _assign_blocked(rows, centroids)
            del rows
        return centroids.cpu().numpy(), assign

    def _permute(self, slab, scales, src: np.ndarray, cap: int | None = None):
        """Chunked copy of ``slab`` rows into cluster order (new arrays;
        device peak old slab + new slab + one chunk)."""
        cap = self._cap if cap is None else cap
        n_live = len(src)
        chunk = 131_072
        new_slab = torch.zeros((cap, self._row_width), dtype=self._dtype,
                               device=self.device)
        new_valid = torch.zeros((cap,), dtype=torch.bool, device=self.device)
        new_scales = (
            torch.zeros((cap,), dtype=torch.float32, device=self.device)
            if self._is_quantized else None
        )
        for i in range(0, n_live, chunk):
            end = min(i + chunk, n_live)
            idx = torch.as_tensor(src[i:end], device=self.device)
            new_slab[i:end] = slab[idx]
            if self._is_quantized:
                new_scales[i:end] = scales[idx]
        new_valid[:n_live] = True
        return new_slab, new_valid, new_scales

    def _install_built(
        self, src, counts, centroids, new_slab, new_valid, new_scales,
        slot_src: np.ndarray | None = None,
        prebuilt: tuple[np.ndarray, np.ndarray] | None = None,
    ) -> None:
        """Swap the permuted arrays in and rebuild the maps and overlay
        (the tail of a build; write lock held). ``prebuilt`` = (slot_of,
        pos_of) computed off the lock by ``_prepare_bg_swap``."""
        n_live = len(src)
        self._slab = new_slab
        self._valid = new_valid
        if self._is_quantized:
            self._scales = new_scales
        self._gen += 1
        if prebuilt is not None:
            self._slot_of, self._pos_of = prebuilt
        else:
            slot_at_dest = (
                self._slot_of if slot_src is None else slot_src
            )[src]
            self._slot_of[:] = -1
            self._slot_of[: n_live] = slot_at_dest
            self._pos_of[:] = -1
            keep = slot_at_dest >= 0
            self._pos_of[slot_at_dest[keep]] = np.arange(
                n_live, dtype=np.int32
            )[keep]
        self._install_layout(np.asarray(centroids), counts)
        # fresh adds start at the next block boundary: scanned blocks and
        # the residual rows stay disjoint (kernel-path invariant)
        self._free = []
        self._quar = {}
        self._quar_n = 0
        self._next_slot = min(self._cap, -(-n_live // self._c) * self._c)
        self._fresh_base = self._next_slot
        self._residual = []
        self._residual_base = 0
        self._built_size = self._size

    def build_background(self) -> None:
        """Rebuild the cluster layout without blocking searches: (1) a
        brief write lock snapshots the tensors and turns the mutators to
        copy-on-write; (2) off the lock, train / assign / permute the
        snapshot while searches and mutations go on; (3) a brief write
        lock invalidates rows whose slots mutated meanwhile, swaps the
        new layout in and replays those mutations into the fresh region
        with their slot ids. Device peak: two slabs + one chunk."""
        with self._mu.write():
            if self._cow_writes:
                return  # already rebuilding
            hwm = self._next_slot
            if self._size == 0 or hwm == 0:
                self._reset_overlay()
                return
            self._cow_writes = True
            self._bg_journal: dict[int, str] = {}
            snap_slab, snap_scales = self._slab, self._scales
            snap_valid = self._valid[:hwm].cpu().numpy()
            snap_slot_of = self._slot_of.copy()
            snap_cap = self._cap
            snap_gen = getattr(self, "_layout_gen", 0)
        done = False
        try:
            live_pos = np.nonzero(snap_valid)[0].astype(np.int64)
            centroids, assign = self._cluster_plan(
                snap_slab, snap_scales, live_pos
            )
            order = np.argsort(assign, kind="stable")
            src = live_pos[order]
            counts = np.bincount(assign, minlength=len(centroids))
            new_slab, new_valid, new_scales = self._permute(
                snap_slab, snap_scales, src, cap=snap_cap
            )
            merged, staged = self._prestage_bg_journal(
                lambda p: FlatIndex.get_vectors(self, p), snap_gen
            )
            dest = np.arange(len(src), dtype=np.int64)
            new_slot_of, new_pos_of, pre_dead = self._prepare_bg_swap(
                snap_slot_of, src, dest, merged, snap_cap
            )
            done = True
        finally:
            if not done:
                with self._mu.write():
                    # release only OUR window: a clear()/load() already
                    # closed it, and a new build may own the flag by now
                    if getattr(self, "_layout_gen", 0) == snap_gen:
                        self._cow_writes = False
        with self._mu.write():
            try:
                if getattr(self, "_layout_gen", 0) != snap_gen:
                    return  # storage replaced mid-build: abandon
                if self._cap != snap_cap:
                    # capacity grew mid-build: redo blocking
                    self._cow_writes = False
                    self._build_locked()
                    return
                delta = self._bg_journal
                self._bg_journal = {}
                merged.update(delta)
                dirty, rows = self._bg_dirty_rows(
                    merged, lambda p: FlatIndex.get_vectors(self, p),
                    staged=staged, refetch=delta,
                )
                extra_dead = self._bg_delta_fixup(
                    delta, new_slot_of, new_pos_of
                )
                dead_dest = (
                    np.concatenate([pre_dead, extra_dead])
                    if len(extra_dead) else pre_dead
                )
                if len(dead_dest):
                    new_valid[torch.as_tensor(dead_dest,
                                              device=self.device)] = False
                self._cow_writes = False
                self._install_built(
                    src, counts, centroids, new_slab, new_valid,
                    new_scales, prebuilt=(new_slot_of, new_pos_of),
                )
                if rows is not None and len(dirty):
                    self._replay_bg_dirty(dirty, rows)
            finally:
                if getattr(self, "_layout_gen", 0) == snap_gen:
                    self._cow_writes = False

    def _install_layout(
        self, centroids: np.ndarray, counts: np.ndarray,
        c: int | None = None,
    ) -> None:
        """Set centroids and extents from bucket counts (rows already in
        cluster order in [0, sum(counts))). ``c`` must be the build-time
        block size when restoring persisted state."""
        nlist = len(counts)
        start = np.zeros(nlist + 1, np.int64)
        np.cumsum(counts, out=start[1:])
        if c is None:
            # row bytes of the STORAGE width (int4 packs two dims a byte)
            c = _block_rows(
                self._row_width, self._slab.element_size(), self._cap,
                target=self.block_bytes_target,
            )
        dev = self.device

        def extents(cc: int) -> dict:
            lo = (start[:-1] // cc).astype(np.int64)
            hi = (-(-start[1:] // cc)).astype(np.int64)
            bn = hi - lo
            ne = counts > 0
            return dict(
                c=cc,
                m=_next_pow2(max(1, int(bn[ne].max()) if ne.any() else 1)),
                lo=torch.as_tensor(lo, device=dev),
                hi=torch.as_tensor(hi, device=dev),
                u_prefix=np.cumsum(np.sort(bn[ne])[::-1]),
                nonempty=int(ne.sum()),
                avg_blocks=float(bn[ne].mean()) if ne.any() else 1.0,
            )

        main = extents(c)
        self._m = main["m"]
        self._c = c
        # an owned copy: the caller's array may be read-only
        self._centroids = torch.from_numpy(
            np.array(centroids, np.float32)
        ).to(dev)
        self._centroids_np = np.asarray(centroids)
        self._bucket_start = start
        # exact per-bucket row ranges for the small-batch ranges path
        cnt = (start[1:] - start[:-1]).astype(np.int64)
        self._row_lo = torch.as_tensor(start[:-1], device=dev)
        self._row_cnt = torch.as_tensor(cnt, device=dev)
        maxc = int(cnt.max()) if len(cnt) else 1
        # +512 margin: slice starts round down to a 512 boundary
        self._range_L = int(
            min(self._cap, -(-max(1, maxc) // 512) * 512 + 512)
        )
        self._blk_lo = main["lo"]
        self._blk_hi = main["hi"]
        self._u_prefix = main["u_prefix"]
        self._nonempty = main["nonempty"]
        self._avg_blocks = main["avg_blocks"]
        # narrow-block (c/4) extents for the latency path: same slab,
        # same invariants (the fresh boundary is c-aligned)
        c_s = max(256, c // 4)
        self._small = (
            extents(c_s)
            if c_s < c and self._cap % c_s == 0 else None
        )

    # -- streaming two-pass build --------------------------------------------
    def _prep_rows(self, raw) -> torch.Tensor:
        rows = to_tensor(raw, self.device, torch.float32)
        if self.metric == "cosine":
            rows = l2_normalize(rows)
        return rows

    def build_from(self, chunks_factory, *, train_chunks: int = 1):
        """Bulk-load a re-iterable chunk source straight into cluster
        order (the index must be empty). ``chunks_factory()`` returns an
        iterator of ``(n_i, dim)`` arrays (numpy or tensors); it is
        consumed twice: pass 1 trains centroids (on the first
        ``train_chunks`` chunks, up to ``train_sample`` rows) and
        assigns every row, pass 2 writes each row at its clustered
        position. Device peak: final slab + one chunk.

        Returns ``(n_total,)`` slot ids in source order."""
        with self._mu.write():
            if self._size:
                raise ValueError("build_from requires an empty index")
            t0 = time.perf_counter()
            centroids = None
            assigns: list[np.ndarray] = []
            pending: list[torch.Tensor] = []
            pending_rows = 0
            total = 0

            def train_and_flush():
                nonlocal centroids, pending
                train = (torch.cat(pending) if len(pending) > 1
                         else pending[0])[: self.train_sample]
                nlist = min(self.nlist, int(train.shape[0]))
                centroids, _ = kmeans(train, num_clusters=nlist,
                                      iters=self.kmeans_iters)
                del train
                for p in pending:
                    assigns.append(_assign_blocked(p, centroids))
                pending = []

            # ---- pass 1: train + assign ----
            for raw in chunks_factory():
                rows = self._prep_rows(raw)
                total += rows.shape[0]
                if centroids is None:
                    pending.append(rows)
                    pending_rows += rows.shape[0]
                    if (len(pending) >= train_chunks
                            or pending_rows >= self.train_sample):
                        train_and_flush()
                else:
                    assigns.append(_assign_blocked(rows, centroids))
                del rows
            if centroids is None:  # source smaller than train_chunks
                if not pending:
                    return np.empty(0, np.int64)
                train_and_flush()
            t1 = time.perf_counter()
            assign = np.concatenate(assigns)
            nlist = int(centroids.shape[0])
            counts = np.bincount(assign, minlength=nlist)
            # dest position of every source row: bucket start + stable
            # within-bucket rank
            order = np.argsort(assign, kind="stable")
            dest = np.empty(total, np.int64)
            dest[order] = np.arange(total)

            # ---- pass 2: write rows at their final positions ----
            if self._cap < total:
                self._grow(total)
            elif self._round_cap(total) != self._cap:
                self._cap = self._round_cap(max(total, 1024))
                self._alloc(self._cap)
            row_off = 0
            for raw in chunks_factory():
                rows = self._prep_rows(raw)
                n = rows.shape[0]
                idx = torch.as_tensor(dest[row_off: row_off + n],
                                      device=self.device)
                self._write_rows(idx, rows, True)
                row_off += n
                del rows
            self._size = total
            self._free = []
            self._free_slots = []
            self._quar = {}
            self._quar_n = 0
            # slots == positions for a fresh bulk load
            self._slot_of[:total] = np.arange(total, dtype=np.int32)
            self._pos_of[:total] = np.arange(total, dtype=np.int32)
            self._next_ext_slot = total
            self._install_layout(centroids.cpu().numpy(), counts)
            # block-aligned fresh boundary (kernel-path invariant)
            self._next_slot = min(self._cap, -(-total // self._c) * self._c)
            self._fresh_base = self._next_slot
            self._residual = []
            self._residual_base = 0
            self._built_size = total
            logger.info(
                "build_from: %d rows, pass 1 %.1fs, pass 2 %.1fs", total,
                t1 - t0, time.perf_counter() - t1,
            )
            return dest.copy()  # dest == slot ids (identity mapping)

    # -- query ---------------------------------------------------------------
    def _geom(self, pad_b: int):
        """The block geometry of a batch of (JAX) width ``pad_b``: the
        narrow c/4 extents at small batch, else the serving blocks."""
        geom = (
            self._small
            if pad_b <= self.small_batch_threshold
            and self.latency_path != "wide" and self._small else None
        )
        if geom:
            return geom, geom["c"], geom["m"], geom["lo"], geom["hi"]
        return None, self._c, self._m, self._blk_lo, self._blk_hi

    def _scan(self, q, k, nprobe, pad_b, valid, residual):
        """One batch through the path JAX would take for a batch of width
        ``pad_b``: ranges, kernel path or portable scan. Returns device
        ``(scores, positions)``."""
        geom, c_eff, m_eff, blk_lo, blk_hi = self._geom(pad_b)
        common = dict(
            precision=self._precision, int8=self._is_int8,
            normalize=self.metric == "cosine", int4=self._is_int4,
        )
        scales = self._scales
        if self._use_ranges(pad_b, nprobe):
            return _clustered_search_ranges(
                self._slab, valid, scales, self._centroids, self._row_lo,
                self._row_cnt, residual, q, k=k, nprobe=nprobe,
                L=self._range_L, **common,
            )
        u = self._scan_u(pad_b, nprobe, geom)
        if self._use_kernel(k):
            return _clustered_search_kernelpath(
                self._slab, valid, scales, self._centroids, blk_lo, blk_hi,
                residual, q, k=k, nprobe=nprobe, u=u, m=m_eff, c=c_eff,
                kern=self._kernel_gen(),
                qprec=getattr(self, "kernel_qprec", "bf16"), pad_b=pad_b,
                **common,
            )
        return _clustered_search(
            self._slab, valid, scales, self._centroids, blk_lo, blk_hi,
            residual, q, k=k, nprobe=nprobe, u=u, m=m_eff, c=c_eff,
            pad_b=pad_b, **common,
        )

    def _search_read_locked(self, queries, k, slot_mask):
        if not self.is_trained:
            scores, pos = FlatIndex.search(
                self, queries, k, self._pos_mask(slot_mask)
            )
            return self._map_pos_to_slots(scores, pos)
        queries = self._prep(queries)
        b = len(queries)
        pad_b = _next_pow2(max(b, 1))  # JAX's batch width: routing only
        nlist = int(self._centroids.shape[0])
        nprobe = min(self.nprobe, nlist)
        pm, nprobe, use_exact = self._filter_plan(slot_mask, nprobe, nlist)
        geom, c_eff, _, _, _ = self._geom(pad_b)
        u = self._scan_u(pad_b, nprobe, geom)
        if use_exact or (
            self.batch_flat_fallback and (u * c_eff >= max(1, self._size))
        ):
            scores, pos = FlatIndex.search(self, queries, k, pm)
            return self._map_pos_to_slots(scores, pos)
        valid = self._valid
        if pm is not None:
            valid = self._masked_valid_dev(valid, pm, self._cap)
        q = to_tensor(queries, self.device, torch.float32)
        scores, pos = self._scan(q, k, nprobe, pad_b, valid,
                                 self._residual_tensor())
        return self._map_pos_to_slots(
            scores.cpu().numpy(), pos.cpu().numpy().astype(np.int64)
        )

    # search() is inherited from IVFIndex (build-if-stale under the write
    # lock, then _search_read_locked under read).

    def search_pipelined(self, qstack, k, materialize: bool = True):
        """Serve a (NB, B, d) stack: each batch through the path of
        ``search`` (the kernel path on the card), results stacked to
        ``(NB, B, k)``. ``materialize=False`` returns the device tensors
        (scores, positions) without a synchronisation; resolve them with
        ``resolve_pipelined`` before mutating the index (positions map
        to slots at resolve time)."""
        if self._needs_build():
            with self._mu.write():
                self._maybe_build()
        with self._mu.read():
            if not self.is_trained:
                out = FlatIndex.search_pipelined(self, qstack, k,
                                                 materialize=False)
                return out if not materialize else \
                    self.resolve_pipelined(out)
            q = to_tensor(qstack, self.device, torch.float32)
            if q.ndim != 3 or q.shape[-1] != self.dim:
                raise ValueError(
                    f"query stack {tuple(q.shape)} is not (NB, B, {self.dim})"
                )
            nb, b, _ = q.shape
            nlist = int(self._centroids.shape[0])
            nprobe = min(self.nprobe, nlist)
            residual = self._residual_tensor()
            outs = [self._scan(q[i], k, nprobe, b, self._valid, residual)
                    for i in range(nb)]
            scores = torch.stack([o[0] for o in outs])
            pos = torch.stack([o[1] for o in outs])
            if not materialize:
                return scores, pos  # in-flight device tensors
        return self.resolve_pipelined((scores, pos))

    def resolve_pipelined(self, handle):
        """Materialize a ``search_pipelined(..., materialize=False)``
        result: one transfer, then the position -> slot mapping."""
        scores, pos = handle
        return self._map_pos_to_slots(
            scores.cpu().numpy(), pos.cpu().numpy().astype(np.int64)
        )

    def _oracle_search(self, queries, k):
        scores, pos = FlatIndex.search(self, queries, k)
        return self._map_pos_to_slots(scores, pos)

    def get_vectors(self, slots: np.ndarray) -> np.ndarray:
        return FlatIndex.get_vectors(self, self._positions_of(slots))

    # -- persistence ----------------------------------------------------------
    def _slots_for_positions(self, positions: np.ndarray) -> np.ndarray:
        return self._slot_of[np.asarray(positions, np.int64)]

    def _host_valid(self, hwm: int) -> np.ndarray:
        """Positions are live exactly where a slot label exists (a build
        rounds ``_next_slot`` up to a block boundary, and those padding
        positions are neither free nor quarantined)."""
        return self._slot_of[:hwm] >= 0

    def save(self, path: str, skip_slab: bool = False) -> None:
        with self._mu.read():
            FlatIndex._save_locked(self, path, skip_slab=skip_slab)
            hwm = self._next_slot
            arrays = dict(
                slot_of=self._slot_of[:hwm],
                residual=np.asarray(self._residual, np.int32),
            )
            if self.is_trained:
                arrays["centroids"] = self._centroids_np
                arrays["bucket_start"] = self._bucket_start
            np.savez(path + ".ivfc.npz", **arrays)
            with open(path + ".ivfc.json", "w") as f:
                json.dump(self._clustered_meta(), f)

    def _clustered_meta(self) -> dict:
        return {
            "nlist": self.nlist,
            "nprobe": self.nprobe,
            "trained": self.is_trained,
            "built_size": self._built_size,
            "residual_base": self._residual_base,
            "next_ext_slot": self._next_ext_slot,
            "free_slots": self._free_slots,
            "pos_quarantine": self._quar_flat(),
            "block_rows": self._c,
            "fresh_base": self._fresh_base,
        }

    def load(self, path: str) -> bool:
        with self._mu.write():
            if not FlatIndex._load_locked(self, path):
                return False
            # _load_locked sets _cap without _alloc: size the clustered
            # bookkeeping to the (possibly new) capacity
            self._slot_of = np.full(self._cap, -1, np.int32)
            self._pos_of = np.full(self._cap, -1, np.int32)
            self._free_slots = []
            self._next_ext_slot = 0
            self._reset_overlay()
            if not os.path.exists(path + ".ivfc.json"):
                return self._adopt_foreign_checkpoint(path)
            with open(path + ".ivfc.json") as f:
                meta = json.load(f)
            with np.load(path + ".ivfc.npz") as data:
                arrays = {key: data[key] for key in data.files}
            self._restore_clustered(arrays, meta,
                                    getattr(self, "_loaded_valid_np", None))
            return True

    def _restore_clustered(self, arrays: dict, meta: dict,
                           live: np.ndarray | None) -> None:
        """Install the clustered state of a ``.ivfc`` sidecar (arrays
        ``slot_of``, ``residual`` and, when trained, ``centroids`` and
        ``bucket_start``) over the flat state already in place. ``live``
        is the host validity of ``[0, _next_slot)``."""
        self.nlist = meta["nlist"]
        self.nprobe = meta["nprobe"]
        self._built_size = int(meta.get("built_size", 0))
        self._residual_base = int(meta.get("residual_base", 0))
        self._next_ext_slot = int(meta.get("next_ext_slot", 0))
        self._free_slots = [int(s) for s in meta.get("free_slots", [])]
        # legacy checkpoints (no fresh_base) quarantine everything below
        # the high-water mark rather than risk recycled positions inside
        # scanned blocks
        self._fresh_base = int(meta.get("fresh_base", self._next_slot))
        hwm = self._next_slot
        slot_of = np.asarray(arrays["slot_of"], np.int32)[:hwm]
        if live is None or len(live) != hwm:
            live = self._valid[:hwm].cpu().numpy()
        # drop labels on dead rows (older checkpoints kept moved-from
        # labels of updated slots)
        slot_of = np.where(live, slot_of, -1)
        self._slot_of[:hwm] = slot_of
        keep = slot_of >= 0
        self._pos_of[slot_of[keep]] = np.arange(hwm, dtype=np.int32)[keep]
        self._residual = [int(p) for p in arrays["residual"]]
        if meta.get("trained") and "centroids" in arrays:
            start = np.asarray(arrays["bucket_start"], np.int64)
            self._install_layout(
                np.asarray(arrays["centroids"]), np.diff(start),
                c=int(meta.get("block_rows", 0)) or None,
            )
        # after the layout install, so holes re-key to their buckets
        self._quarantine_positions(np.asarray(
            meta.get("pos_quarantine", []), np.int64
        ))
        self._gen += 1

    def get_stats(self) -> dict:
        stats = FlatIndex.get_stats(self)
        stats.update(
            nlist=self.nlist,
            nprobe=self.nprobe,
            trained=self.is_trained,
            residual=len(self._residual),
            layout="clustered",
            # quarantined positions are tombstones awaiting reuse or the
            # next build: counted so store.optimize() triggers compaction
            tombstones=len(self._free) + self._quar_len(),
        )
        return stats
