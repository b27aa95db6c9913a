"""Mesh-sharded IVF: bucket tables split over the mesh's shards,
centroids replicated, probe scan + merge over every shard.

Torch port of ``wdbx_tpu/parallel/sharded_ivf.py``:

  * the base slab is the ``ShardedFlatIndex`` striped layout: mutation,
    tombstones, persistence, growth and the fresh (residual) buffer all
    inherit unchanged;
  * the IVF overlay splits ``bucket_rows (nlist, cap_b, d)`` /
    ``bucket_slot`` / ``bucket_valid`` over the shards in nlist-major
    blocks (shard s owns buckets ``[s*L, (s+1)*L)``), one tensor set a
    shard on its position's device; the centroids are replicated;
  * a query batch takes the steps of JAX's ``_build_ivf_search`` in its
    order: probe selection over all centroids; on each shard the QUOTA
    compaction of the ``(B*P,)`` probe list, its own buckets first in
    rank order, keeping ``Q = ~2*B*P/n_dev`` entries (overflow drops the
    lowest-ranked probes, as JAX does); a per-(query, probe) top-k over
    each kept bucket; the residual scan over the shard's fresh slots; the
    shard's local top-k; the merge across shards.

The scan is plain torch, as JAX's is ``lax`` (K5 does not serve it).
Kept buckets are gathered a chunk at a time (``_SCAN_CHUNK_BYTES`` of
float32 rows), so one shard's quota never materializes whole. Probe
selection and the quota keep JAX's tie order (``lax.top_k`` keeps the
lower index): batches pad to a power of two with zero queries, whose
probes take quota slots on the padded batch exactly as in JAX.

Replica groups are not used by this engine (JAX's ``ShardedIVFIndex``
takes no ``replicas``): the tables live on the first group's positions,
and a replicated global mesh is refused (``ValueError``).
A checkpoint whose nlist does not split over this mesh's shards loads
untrained and rebuilds on the next search.

Global mesh (``ShardedFlatIndex``'s module docstring): the tables of a
shard live on the rank holding it (``None`` at the others'). A build
reads the training sample from its owners onto rank 0, which trains and
broadcasts the centroids (as ``ShardedClusteredIndex`` does); each rank
takes the top-``n_choices`` buckets of the live rows it holds and the
ranks exchange them, so the capped placement, the slot tables and the
residual list are computed alike on every rank on the host; the rows
then fill their buckets' tables ``_CHUNK`` at a time, a rank sending
only rows bound for another rank's shards (``collective.all_to_all``).
A search selects probes and compacts each shard's quota on identical
inputs on every rank, scans the rank's own shards' buckets and fresh
slots, merges them to ``(B, k)`` and merges once more across the ranks
(``ShardedFlatIndex._serve``, the same ``torch.topk`` rule): the one
merge's sets, except at ties. A rank holding no position holds no table
(the tables' shapes stay host state on every rank) and joins each
collective with an empty block. The filtered and fallback routes are
``ShardedFlatIndex``'s flat route. Checkpoints keep JAX's ``.ivf.npz``:
its tables gather on rank 0 (npz backend), or each rank writes its
shards' bucket rows into its own per-position files, the gathered slot
and validity tables staying in the ``.ivf.npz`` (``persist_backend=
"orbax"``).
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from wdbx_tpu_torch.index.base import Pending, Plan
from wdbx_tpu_torch.index.flat import (
    _next_pow2,
    slab_from_numpy,
    slab_to_numpy,
    to_tensor,
)
from wdbx_tpu_torch.index.ivf import (
    _SCAN_CHUNK_BYTES,
    IVFIndex,
    _capped_placement,
    _mask_bucket_valid_body,
    _pack_slot_positions,
    _scores_of,
)
from wdbx_tpu_torch.ops.exact_search import f32_scores, true_f32
from wdbx_tpu_torch.ops.normalize import l2_normalize
from wdbx_tpu_torch.parallel import collective
from wdbx_tpu_torch.parallel.sharded_flat import _CHUNK, ShardedFlatIndex

logger = logging.getLogger("wdbx_tpu_torch.parallel")


def _topk_merge(pv: torch.Tensor, pi: torch.Tensor, k: int):
    """``(B, parts, k')`` scores and slots -> the sorted ``(B, k)`` of
    their union (``torch.topk``, as the single-process merge)."""
    b = pv.shape[0]
    v, i = pv.reshape(b, -1), pi.reshape(b, -1)
    top, pos = torch.topk(v, min(k, v.shape[1]), dim=1)
    return top, torch.gather(i, 1, pos).to(torch.int64)


class ShardedIVFIndex(IVFIndex, ShardedFlatIndex):
    """IVF overlay on the mesh-striped slab. MRO: IVF bookkeeping
    (residual / quarantine / rebuild triggers) runs above the
    ShardedFlatIndex storage; build and search are the sharded ones."""

    kind = "sharded_ivf"
    #: the dense bucket tables gather raw codes with no nibble unpack
    _INT4_OK = False

    def __init__(self, dim, metric="cosine", dtype="float32",
                 capacity=1024, mesh=None, axis="shard", nlist=128,
                 nprobe=8, train_threshold=4096, rebuild_fraction=0.2,
                 kmeans_iters=15, train_sample=262_144, quota_slack=2.0,
                 device=None):
        # ShardedFlatIndex.__init__ consumes mesh / axis and reaches
        # FlatIndex through the MRO; the IVF knobs are set after
        ShardedFlatIndex.__init__(
            self, dim, metric=metric, dtype=dtype, capacity=capacity,
            mesh=mesh, axis=axis, device=device,
        )
        if self.mesh.is_global and self.replicas > 1:
            raise ValueError("ShardedIVFIndex takes no replica axis on a "
                             "mesh spanning ranks")
        self.nlist = nlist
        self.nprobe = nprobe
        self.assignments = 1
        self.train_threshold = train_threshold
        self.rebuild_fraction = rebuild_fraction
        self.kmeans_iters = kmeans_iters
        self.train_sample = train_sample
        #: per-shard probe quota = slack * B*P/n_dev
        self.quota_slack = quota_slack
        self.batch_flat_fallback = True
        self.topk_method = "auto"
        self.ivf_kernel = "lax"
        self._filter_boosts: dict[int, int] = {}
        self._reset_overlay()

    @property
    def _local_nlist(self) -> int:
        return self._table_shape[0]

    def _table_like(self, name: str):
        """The shape and dtype of one shard's table ``name`` (known on
        every rank, one holding no table too)."""
        local_n, cap_b = self._table_shape
        return {"bucket_slot": ((local_n, cap_b), torch.int32),
                "bucket_valid": ((local_n, cap_b), torch.bool),
                "bucket_rows": ((local_n, cap_b, self.dim), self._rows_dtype),
                "bucket_scale": ((local_n, cap_b), torch.float32)}[name]

    def _rank_k(self, k: int) -> int:
        """Every rank's merge keeps k: a shard's buckets hold rows of any
        shard, so its candidates are not bounded by its own rows."""
        return k

    def _shard_held(self, make) -> list:
        """``make(s, device)`` for each shard whose tables this process
        holds (the first group's positions), None at the others."""
        return [make(s, d) if s in self._local else None
                for s, d in enumerate(self.mesh.devices[:self.n_devices])]

    # -- topology -------------------------------------------------------------
    def adopt_mesh(self, mesh) -> None:
        """Cold re-host: empty storage on the new topology (the caller
        reloads from checkpoint); the bucket overlay resets."""
        ShardedFlatIndex.adopt_mesh(self, mesh)
        with self._mu.write():
            self._reset_overlay()

    def remesh(self, mesh) -> None:
        """Re-stripe the slab on the new mesh, then rebuild the bucket
        overlay there (its tables are split by shard)."""
        was_trained = self.is_trained
        ShardedFlatIndex.remesh(self, mesh)
        with self._mu.write():
            self._reset_overlay()
        if was_trained and self._size:
            self.build()

    # -- build ----------------------------------------------------------------
    def build(self) -> None:
        with self._mu.write():
            self._sharded_build_locked()

    def _gather_unit(self, slots: np.ndarray) -> torch.Tensor:
        """Float32 rows of slots held here (dequantized; unit norm for
        cosine)."""
        return self._unit(*self._gather_raw_of(
            self._slabs, self._row_scales, slots, self.n_devices))

    def _sharded_build_locked(self) -> None:
        hwm = self._next_slot
        if self._size == 0 or hwm == 0:
            self._reset_overlay()
            return
        live_slots = np.nonzero(self._host_valid_np()[:hwm])[0].astype(
            np.int64)
        n_live = len(live_slots)
        n_dev = self.n_devices
        # nlist must split evenly over the shards
        nlist = min(self.nlist, max(n_dev, n_live))
        nlist = max(n_dev, (nlist // n_dev) * n_dev)
        sample = live_slots
        if n_live > self.train_sample:
            sel = np.random.default_rng(0).choice(
                n_live, self.train_sample, replace=False
            )
            sample = live_slots[np.sort(sel)]
        centroids = self._train_centroids(self._slabs, self._row_scales,
                                          sample, nlist)
        assign_multi = self._assign_choices(live_slots, centroids,
                                            min(4, nlist))

        placed, cap_b = _capped_placement(assign_multi, nlist)
        keep = placed >= 0
        leftover_slots = live_slots[~keep]
        assign = placed[keep]
        kept_slots = live_slots[keep]
        n_entries = len(assign)

        bucket_slot = np.full((nlist, cap_b), self._cap, np.int32)  # pad
        bucket_valid = np.zeros((nlist, cap_b), bool)
        order = np.argsort(assign, kind="stable")
        sorted_assign = assign[order]
        starts = np.searchsorted(sorted_assign, np.arange(nlist))
        pos_within = np.arange(n_entries) - starts[sorted_assign]
        slot_sorted = kept_slots[order]
        bucket_slot[sorted_assign, pos_within] = slot_sorted
        bucket_valid[sorted_assign, pos_within] = True

        # tables: int8 slabs keep raw codes + a scale table, float slabs
        # store bf16; each shard's buckets on its position's device
        local_n = nlist // n_dev
        table_dtype = torch.int8 if self._is_int8 else torch.bfloat16
        self._rows_dtype = table_dtype
        self._bucket_rows = self._shard_held(lambda s, d: torch.zeros(
            (local_n, cap_b, self.dim), dtype=table_dtype, device=d))
        self._bucket_scale = (self._shard_held(lambda s, d: torch.zeros(
            (local_n, cap_b), dtype=torch.float32, device=d))
            if self._is_int8 else None)
        self._fill_tables(slot_sorted, sorted_assign.astype(np.int64),
                          pos_within.astype(np.int64), local_n)
        self._centroids = centroids.to(self.device)
        self._split_tables(bucket_slot, bucket_valid)
        self._slot_bucket_c, self._slot_bucket_p = _pack_slot_positions(
            slot_sorted, sorted_assign.astype(np.int32),
            pos_within.astype(np.int32), self._cap, 1,
        )
        self._residual = [int(x) for x in leftover_slots]
        self._residual_base = len(self._residual)
        self._free.extend(self._quarantine)
        self._quarantine = []
        self._built_size = self._size

    def _assign_choices(self, live_slots, centroids, n_choices):
        """``(n_live, n_choices)`` int32: each live row's best buckets."""
        mine = self._build_rows(live_slots)
        out = np.empty((len(mine), n_choices), np.int32)
        for i in range(0, len(mine), _CHUNK):
            rows = self._gather_unit(mine[i:i + _CHUNK])
            out[i:i + _CHUNK] = torch.topk(
                f32_scores(rows, centroids), n_choices, dim=-1
            ).indices.to(torch.int32).cpu().numpy()
            del rows
        return self._share_by_owner(live_slots, out)

    def _fill_tables(self, slots, buckets, within, local_n) -> None:
        """Copy each placed slot's stored row into its bucket's table,
        ``_CHUNK`` entries at a time (``_move_rows``: across ranks, a
        row travels to the rank holding its bucket's shard)."""
        for i in range(0, len(slots), _CHUNK):
            c, p = buckets[i:i + _CHUNK], within[i:i + _CHUNK]
            self._move_rows(
                self._slabs, self._row_scales, slots[i:i + _CHUNK],
                c // local_n,
                lambda at, rows, sc, c=c, p=p: self._put_entries(
                    c[at], p[at], rows, sc, local_n))

    def _put_entries(self, buckets, within, raw, sc, local_n) -> None:
        """Write stored rows (and scales) at (global bucket, position)
        entries into the tables of the shards held here."""
        owner = buckets // local_n
        for s, table in enumerate(self._bucket_rows):
            m = owner == s
            if table is None or not m.any():
                continue
            dev = table.device
            cs = torch.as_tensor(buckets[m] - s * local_n, device=dev)
            ps = torch.as_tensor(within[m], device=dev)
            at = torch.as_tensor(np.nonzero(m)[0], device=raw.device)
            table[cs, ps] = raw[at].to(table.dtype).to(dev)
            if self._bucket_scale is not None:
                self._bucket_scale[s][cs, ps] = sc[at].to(dev)

    def _split_tables(self, bucket_slot: np.ndarray,
                      bucket_valid: np.ndarray) -> None:
        """Global host slot / validity tables -> one block a shard."""
        local_n = bucket_slot.shape[0] // self.n_devices
        self._table_shape = (local_n, int(bucket_slot.shape[1]))
        self._bucket_slot = self._shard_held(
            lambda s, d: torch.from_numpy(np.ascontiguousarray(
                bucket_slot[s * local_n:(s + 1) * local_n])).to(d))
        self._bucket_valid = self._shard_held(
            lambda s, d: torch.from_numpy(np.ascontiguousarray(
                bucket_valid[s * local_n:(s + 1) * local_n])).to(d))

    def _invalidate_bucket_entries(self, slots) -> None:
        cs, ps = self._take_bucket_positions(slots)
        if not len(cs):
            return
        local_n = self._local_nlist
        cs, ps = cs.astype(np.int64), ps.astype(np.int64)
        for s, table in enumerate(self._bucket_valid):
            m = (cs // local_n) == s
            if table is not None and m.any():
                table[torch.as_tensor(cs[m] - s * local_n, device=table.device),
                      torch.as_tensor(ps[m], device=table.device)] = False

    # -- query ----------------------------------------------------------------
    def _quota(self, bp: int) -> int:
        return min(bp, max(
            8, int(math.ceil(bp / self.n_devices * self.quota_slack))
        ))

    def _pad_b(self, b: int, stack: bool = False) -> int:
        """JAX's batch width: a blocking batch pads to a power of two
        with zero queries, whose probes take quota slots on the padded
        batch; JAX's stack program runs each batch at its own width."""
        return b if stack else _next_pow2(max(b, 1))

    def _scan_reads(self, plan: Plan) -> int:
        return plan.pad_b * plan.nprobe * self._table_shape[1]

    def _enqueue(self, queries, k: int, plan: Plan) -> Pending:
        if plan.exact:
            return super()._enqueue(queries, k, plan)
        bucket_valid, valids = self._bucket_valid, self._valids
        if plan.mask is not None:
            # filter pushdown: AND the mask into each shard's bucket
            # validity (bucket-resident rows) and into the striped row
            # validity (residual leg); the plan boosted nprobe so the
            # thinned buckets still surface ~k matches
            mask = np.zeros(self._cap, bool)
            n = min(len(plan.mask), self._cap)
            mask[:n] = plan.mask[:n]
            bucket_valid = [
                None if bv is None else _mask_bucket_valid_body(
                    bv, bs, torch.from_numpy(mask).to(bv.device))
                for bv, bs in zip(self._bucket_valid, self._bucket_slot)
            ]
            valids = self._masked_valids(plan.mask)
        b = len(queries)
        q = torch.zeros((plan.pad_b, self.dim), dtype=torch.float32,
                        device=self.device)
        q[:b] = to_tensor(queries, self.device, torch.float32)
        v, i = self._ivf_query(q, k, plan.nprobe,
                               self._quota(plan.pad_b * plan.nprobe),
                               bucket_valid, valids)
        return Pending(v[:b], i[:b], k, self._finish)

    def _ivf_query(self, q, k, nprobe, quota, bucket_valid, valids):
        """One batch ``q`` (B, d) through every shard: sorted ``(B, k')``
        device scores and slots. On a global mesh each rank merges its
        shards to ``(B, k)`` (-inf / -1 past its candidates; a rank
        holding no shard none) and ``_serve`` gathers and merges the
        ranks'."""
        if self.metric == "cosine":
            q = l2_normalize(q)
        if not self.mesh.is_global:
            return self._ivf_shards(q, k, nprobe, quota, bucket_valid, valids)

        def run(g, lo, hi):
            top, slots = self._ivf_shards(q, k, nprobe, quota, bucket_valid,
                                          valids)
            pad = k - top.shape[1]
            return (torch.nn.functional.pad(top, (0, pad),
                                            value=float("-inf")),
                    torch.nn.functional.pad(slots, (0, pad), value=-1))

        return self._serve(q.shape[0], k, run, _topk_merge)

    def _ivf_shards(self, q, k, nprobe, quota, bucket_valid, valids):
        """Normalized queries ``q`` through the shards held here, merged
        to sorted ``(B, <= k)`` scores and slots."""
        n_dev = self.n_devices
        local_n = self._local_nlist
        cap_b = self._table_shape[1]
        k_bucket = min(k, cap_b)
        b = q.shape[0]
        # 1. probe selection over the replicated centroids; ties keep the
        # lower bucket, as lax.top_k does
        cs = f32_scores(q, self._centroids)
        probe = torch.sort(cs, dim=1, descending=True,
                           stable=True).indices[:, :nprobe]
        flat = probe.reshape(-1)
        bp = flat.shape[0]
        qidx = torch.arange(b, device=q.device).repeat_interleave(nprobe)
        # the tables hold bf16 rows or int8 codes: bf16 queries score them
        qb = q.to(torch.bfloat16).to(torch.float32)
        residual = torch.as_tensor(np.asarray(self._residual, np.int64))
        quant = self._is_quantized
        lv, ls = [], []
        for s in range(n_dev):
            if self._bucket_rows[s] is None:
                continue  # another rank's shard
            dev = self._bucket_rows[s].device
            # 2. quota compaction: this shard's probes first, in rank
            # order; past the quota the lowest-ranked probes drop
            local = (flat >= s * local_n) & (flat < (s + 1) * local_n)
            ranked = torch.argsort((~local).to(torch.int8), stable=True)[:quota]
            kept = ranked[local[ranked]]
            cand_v = torch.full((bp, k_bucket), float("-inf"), device=dev)
            cand_s = torch.full((bp, k_bucket), -1, dtype=torch.int64,
                                device=dev)
            if kept.numel():
                # 3. a top-k over each kept (query, probe) bucket
                v, sl = self._scan_buckets(
                    s, flat[kept] - s * local_n, qb[qidx[kept]], k_bucket,
                    bucket_valid[s])
                kept = kept.to(dev)
                cand_v[kept] = v
                cand_s[kept] = sl
            cand_v = cand_v.reshape(b, nprobe * k_bucket)
            cand_s = cand_s.reshape(b, nprobe * k_bucket)
            # 4. the residual scan over this shard's fresh slots
            mine = residual[residual % n_dev == s]
            if mine.numel():
                r = (mine // n_dev).to(self._slabs[s].device)
                rows = self._slabs[s][r]
                r_scores = _scores_of(rows, q.to(rows.device),
                                      self._precision, quant)
                if quant:
                    r_scores = r_scores * self._row_scales[s][r][None, :]
                r_scores = torch.where(valids[s][r][None, :], r_scores,
                                       float("-inf"))
                cand_v = torch.cat([cand_v, r_scores.to(dev)], dim=1)
                cand_s = torch.cat(
                    [cand_s, mine.to(dev)[None, :].expand(b, -1)], dim=1)
            # 5. the shard's local top-k
            v, pos = torch.topk(cand_v, min(k, cand_v.shape[1]), dim=1)
            lv.append(v.to(self.device))
            ls.append(torch.gather(cand_s, 1, pos).to(self.device))
        # 6. the merge across shards (across ranks: ``_serve``)
        return _topk_merge(torch.cat(lv, dim=1)[:, None],
                           torch.cat(ls, dim=1)[:, None], k)

    def _scan_buckets(self, s, buckets, qrows, k_bucket, bucket_valid):
        """``(n, k_bucket)`` scores and slots of ``n`` (query row, local
        bucket) pairs of shard ``s``, the buckets gathered a chunk at a
        time."""
        table = self._bucket_rows[s]
        dev = table.device
        _, cap_b, d = table.shape
        buckets, qrows = buckets.to(dev), qrows.to(dev)
        g = max(1, _SCAN_CHUNK_BYTES // (cap_b * d * 4))
        outs_v, outs_s = [], []
        with true_f32():
            for lo in range(0, buckets.shape[0], g):
                bk = buckets[lo:lo + g]
                blk = table[bk].to(torch.float32)  # (g, C, d)
                sc = torch.bmm(blk, qrows[lo:lo + g, :, None])[:, :, 0]
                if self._bucket_scale is not None:
                    sc = sc * self._bucket_scale[s][bk]
                sc = torch.where(bucket_valid[bk], sc, float("-inf"))
                v, i = torch.topk(sc, k_bucket, dim=1)
                outs_v.append(v)
                outs_s.append(torch.gather(
                    self._bucket_slot[s][bk].to(torch.int64), 1, i))
        return torch.cat(outs_v), torch.cat(outs_s)

    # -- persistence ------------------------------------------------------------
    # IVFIndex.save / load: the slab through ShardedFlatIndex's npz or
    # per-position hooks, the overlay as the JAX package's global
    # ``.ivf.npz`` tables (split again by shard at load). With the
    # per-position backend the bucket rows (and int8 scales) ride in each
    # shard's own file instead, and the ``.ivf.npz`` keeps the rest.
    def _shard_tables(self, name: str, parts) -> np.ndarray | None:
        """One shard-major host table from the tensors ``name`` of each
        shard (bf16 as uint16 bits), gathered when the shards span
        ranks: on rank 0 (None on the others), or on every rank where
        several write (``_choose_writer``)."""
        tail, dtype = self._table_like(name)
        held = [t.cpu() for t in parts if t is not None]
        if self._spans:
            mine = self._shard_stack(held, tail, dtype,
                                     everywhere=self._writers > 1)
            if mine is None:
                return None
        else:
            mine = torch.stack(held)
        return slab_to_numpy(mine.reshape((-1,) + tuple(tail[1:])))

    def save(self, path: str, skip_slab: bool = False) -> None:
        self._choose_writer(path)
        IVFIndex.save(self, path, skip_slab=skip_slab)

    def _overlay_host_arrays(self) -> dict[str, np.ndarray] | None:
        tables = {"bucket_slot": self._bucket_slot,
                  "bucket_valid": self._bucket_valid}
        if self.persist_backend != "orbax":
            tables["bucket_rows"] = self._bucket_rows
            if self._bucket_scale is not None:
                tables["bucket_scale"] = self._bucket_scale
        arrays = {name: self._shard_tables(name, parts)
                  for name, parts in tables.items()}
        if not self._is_lead():
            return None
        arrays.update(centroids=self._centroids.cpu().numpy(),
                      residual=np.asarray(self._residual, np.int32))
        return arrays

    def _position_arrays(self) -> dict[str, list[torch.Tensor]]:
        arrays = ShardedFlatIndex._position_arrays(self)
        if self.is_trained:
            own = self._positions_held()[0]
            arrays["bucket_rows"] = [self._bucket_rows[s] for s in own]
            if self._bucket_scale is not None:
                arrays["bucket_scale"] = [self._bucket_scale[s] for s in own]
        return arrays

    def _install_positions(self, arrays: dict[str, list]) -> None:
        # the bucket rows wait for the overlay's install in load()
        self._loaded_rows = {name: arrays.pop(name)
                             for name in ("bucket_rows", "bucket_scale")
                             if name in arrays}
        ShardedFlatIndex._install_positions(self, arrays)

    def _install_tables(self, arrays: dict) -> None:
        bs = np.array(arrays["bucket_slot"], np.int32)
        nlist = bs.shape[0]
        n_dev = self.n_devices
        if nlist % n_dev:
            logger.warning(
                "sharded_ivf: nlist %d does not split over %d shards; the "
                "overlay rebuilds", nlist, n_dev)
            return
        local_n = nlist // n_dev
        own = self._positions_held(writing=False)[0]
        loaded = getattr(self, "_loaded_rows", None) or {}
        self._loaded_rows = None

        def split(name, dtype):
            if name in loaded:  # this rank's shards' own files
                at = dict(zip(own, loaded[name]))
                return self._shard_held(lambda s, d: at[s].to(d))
            if name not in arrays:
                return None
            host = arrays[name]
            return self._shard_held(lambda s, d: slab_from_numpy(
                host[s * local_n:(s + 1) * local_n], dtype).to(d))

        table_dtype = {"uint16": torch.bfloat16, "bfloat16": torch.bfloat16,
                       "int8": torch.int8, "float32": torch.float32}
        rows = arrays.get("bucket_rows")
        held = loaded.get("bucket_rows") or [None]
        self._rows_dtype = (
            table_dtype[rows.dtype.name] if rows is not None
            else held[0].dtype if held[0] is not None
            else torch.int8 if self._is_int8 else torch.bfloat16)
        self._bucket_rows = split(
            "bucket_rows",
            None if rows is None else table_dtype[rows.dtype.name])
        self._bucket_scale = split("bucket_scale", torch.float32)
        bv = np.array(arrays["bucket_valid"], bool)
        self._split_tables(bs, bv)
        self._centroids = torch.from_numpy(
            np.array(arrays["centroids"], np.float32)).to(self.device)
        self._residual = [int(s) for s in arrays["residual"]]
        cs, ps = np.nonzero(bv)
        self._slot_bucket_c, self._slot_bucket_p = _pack_slot_positions(
            bs[cs, ps], cs.astype(np.int32), ps.astype(np.int32),
            self._cap, 1,
        )
