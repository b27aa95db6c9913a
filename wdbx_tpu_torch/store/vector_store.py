"""Sharded vector store: host bookkeeping over device-resident shard slabs.

Torch port of ``wdbx_tpu/store/vector_store.py``: the same store with
its shards' indexes built by the port's ``create_index`` on the
store's ``device``. The host layer (registries, metadata, raw store,
checkpoints) is the JAX package's, so a data_dir saved by either
package loads in the other.

Parity target is the reference ``VectorStore`` (reference
wdbx/core/vector_store.py:22): store/search/get/delete/update_metadata/
batch_store/clear/count/optimize/get_stats with ``_async`` twins, shard
fan-out search with top-k merge, Mongo-style metadata filters, threshold,
and disk persistence with restart-resume.

Differences from the reference:
  * shard placement uses a *stable* blake2 hash (the reference's
    ``abs(hash(id)) % n`` is salt-randomized per process, reference
    wdbx/core/vector_store.py:178-190);
  * vectors live in device HBM slabs (one index per shard); inserts are
    batched scatters, not per-vector C++ calls (reference hot loop at
    wdbx/core/indexing.py:378);
  * search accepts query *batches* and merges shard results with a device
    top-k instead of a host sort (reference wdbx/core/vector_store.py:384);
  * metadata lives in slot-aligned typed numpy columns
    (store/metastore.py) — filter masks are vectorized numpy, not a
    per-entry Python walk, and persistence is per-shard npz instead of
    the reference's one-blob JSON (wdbx/core/vector_store.py:136-176);
  * raw vectors live in a slot-indexed disk memmap (store/rawstore.py)
    instead of a host dict — the exact re-rank stays feasible at the
    20M-row capacity tier and ``save()`` never materializes the corpus;
  * ``_async`` methods wrap the sync path in ``asyncio.to_thread`` — CUDA
    launches are already asynchronous, so no thread-pool-per-index
    machinery (reference wdbx/core/vector_store.py:71-73) is needed;
  * persistence is npz/JSON/memmap, never pickle.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import os
import threading
from typing import Any

import numpy as np

from wdbx_tpu_torch.index.base import VectorIndex, create_index
from wdbx_tpu_torch import native as _native
from wdbx_tpu_torch.store.atomic import CheckpointRoot
from wdbx_tpu_torch.store.filters import compile_filter
from wdbx_tpu_torch.store.metastore import ColumnarMetadata
from wdbx_tpu_torch.store.rawstore import create_raw_store
from wdbx_tpu_torch.utils import heap
from wdbx_tpu_torch.utils.metrics import TRACER, LatencyRecorder

logger = logging.getLogger("wdbx_tpu_torch.store")

SearchHit = tuple[str, float, dict[str, Any]]


def stable_shard(vector_id: str, num_shards: int) -> int:
    """Deterministic id → shard placement, stable across processes."""
    digest = hashlib.blake2b(vector_id.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(digest, "big") % num_shards


class VectorStore:
    """Dimension-checked, sharded, persistent vector store."""

    def __init__(self, config: Any, data_dir: str | None = None,
                 device: Any = None):
        self.config = config
        #: where the shard indexes live: None = the CUDA device (raises
        #: without one), "cpu" to run on the CPU
        self.device = device
        self.dim = int(config.get("VECTOR_DIMENSION", 384))
        self.num_shards = int(config.get("NUM_SHARDS", 1))
        self.data_dir = data_dir or config.get("DATA_DIR", "./wdbx_data")
        self.autosave_interval = int(
            config.get("VECTOR_STORE_AUTOSAVE_INTERVAL", 1000)
        )
        self.save_immediately = bool(
            config.get("VECTOR_STORE_SAVE_IMMEDIATELY", False)
        )
        self.filter_mode = str(config.get("FILTER_MODE", "auto"))
        #: exact re-rank of top candidates from the raw store (SURVEY §7:
        #: protects recall when the slab is quantized): "auto" = on for
        #: int8/int4 indexes when a raw store exists; True/False force.
        self.rerank = config.get("RERANK", "auto")
        #: tune() learns the smallest re-rank over-fetch factor meeting
        #: the recall target; RERANK_FETCH_FACTOR config overrides
        self._tuned_fetch_factor: int | None = None
        self._fetch_factor_force: int | None = None
        # serializes concurrent tune() probes: the force pin above is
        # store-wide shared state, and one probe's finally-reset must
        # not unpin another's in-flight measurement
        self._tune_ff_mu = threading.Lock()

        #: crash-atomic checkpoint generations (store/atomic.py); fsync
        #: can be disabled for benchmark runs on throwaway dirs
        self._ckpt = CheckpointRoot(
            os.path.join(self.data_dir, "checkpoint"),
            fsync=bool(config.get("CHECKPOINT_FSYNC", True)),
        )
        self._ckpt_gen = 0
        self._ckpt_dir: str | None = None
        self._oldlayout_loaded = False

        self.indices: list[VectorIndex] = []
        # id <-> slot bookkeeping: native C++ registry when built
        # (wdbx_tpu/native), Python fallback otherwise.
        self.registries: list[Any] = []
        self._mutations_since_save = 0
        self._lock = threading.RLock()
        self._epoch = 0  # bumps on every mutation (optimistic searches)
        self._fanout_pool = None  # persistent multi-shard search executor
        # one search merges at a time: the merge is interpreter work that
        # could not run in parallel anyway, and concurrent searches then
        # queue here once instead of contending for the interpreter
        # through the whole merge (innermost: taken with no other lock
        # to follow)
        self._merge_gate = threading.Lock()
        self.metrics = LatencyRecorder()
        # Search-path snapshots, invalidated on mutation: per-shard
        # slot->id object tables and pre-filter mask cache.
        self._slot_ids_cache: list[np.ndarray | None] = []
        self._mask_cache: dict[tuple[str, int], np.ndarray] = {}
        #: shards whose recover() replaced live state and then FAILED:
        #: save() refuses to overwrite the last complete checkpoint
        #: generation while any shard is in this state (a successful
        #: recover() or an explicit clear() lifts it)
        self._poisoned: set[int] = set()

        index_type = config.get("INDEX_TYPE", "flat")
        # "orbax": one checkpoint file a mesh position (store/persist.py)
        persist_backend = str(config.get("PERSIST_BACKEND", "npz"))
        for _ in range(self.num_shards):
            index = create_index(index_type, self.dim, config, device=device)
            index.persist_backend = persist_backend
            self.indices.append(index)
            self.registries.append(_native.SlotRegistry())

        self._slot_ids_cache = [None] * len(self.indices)
        self._create_dirs()
        #: slot-aligned columnar metadata (host, typed numpy columns)
        self.meta = ColumnarMetadata(self.num_shards)
        #: slot-indexed raw-vector memmap (or a null store)
        self.raws = create_raw_store(
            config, self.data_dir, self.num_shards, self.dim
        )
        self._load()
        # set-up edge: the imports and what _load() built stop being
        # walked by every later full collection (utils/heap.py)
        heap.settle("init")

    # -- lifecycle --------------------------------------------------------
    def _create_dirs(self) -> None:
        for sub in ("metadata", "vectors", "indices"):
            os.makedirs(os.path.join(self.data_dir, sub), exist_ok=True)

    async def initialize(self) -> None:
        """Async init hook (device warm-up happens lazily)."""

    async def shutdown(self) -> None:
        await asyncio.to_thread(self.save)
        pool = self._fanout_pool
        if pool is not None:
            self._fanout_pool = None
            pool.shutdown(wait=False)

    # -- helpers ----------------------------------------------------------
    def _check_vector(self, vector: Any) -> np.ndarray:
        arr = np.asarray(vector, dtype=np.float32)
        if arr.ndim != 1 or arr.shape[0] != self.dim:
            raise ValueError(
                f"vector dimension {arr.shape} does not match store dimension "
                f"{self.dim}"
            )
        return arr

    def _shard_for(self, vector_id: str) -> int:
        return stable_shard(vector_id, self.num_shards)

    def _after_mutation(self, count: int = 1) -> None:
        self._invalidate_snapshots()
        self._mutations_since_save += count
        if self._poisoned:
            # autosave must not turn a failed recovery into a raised
            # exception inside an unrelated mutation call — skip (and
            # keep counting) until the shard is repaired or cleared
            logger.warning(
                "autosave skipped: shards %s in failed-recovery state",
                sorted(self._poisoned),
            )
            return
        if self.save_immediately:
            self.save()
        elif (
            self.autosave_interval
            and self._mutations_since_save >= self.autosave_interval
        ):
            self.save()

    # -- mutation ---------------------------------------------------------
    def store(
        self,
        vector_id: str,
        vector: Any,
        metadata: dict[str, Any] | None = None,
    ) -> bool:
        arr = self._check_vector(vector)
        if not vector_id:
            raise ValueError("vector ids must be non-empty strings")
        with self.metrics.timed("store"), self._lock:
            shard = self._shard_for(vector_id)
            existing = self.registries[shard].lookup(vector_id)
            if existing is not None:
                slot = int(existing)
                self.indices[shard].update_slots(
                    np.asarray([slot]), arr[None, :]
                )
            else:
                slot = int(self.indices[shard].add_batch(arr[None, :])[0])
                self.registries[shard].put([vector_id], [slot])
            self.meta.set(shard, slot, metadata or {})
            self.raws.write(shard, np.asarray([slot]), arr[None, :])
            self._after_mutation()
        return True

    def batch_store(
        self,
        vectors: dict[str, Any],
        metadata: dict[str, dict[str, Any]] | None = None,
    ) -> int:
        """Group by shard, one scatter per shard — the compiled-batch
        replacement for the reference's per-vector insert loop
        (reference wdbx/core/vector_store.py:720-763)."""
        metadata = metadata or {}
        by_shard: dict[int, tuple[list[str], list[np.ndarray]]] = {}
        updates: list[tuple[str, np.ndarray]] = []
        # id validation BEFORE any index mutation: a registry rejection
        # mid-loop would orphan already-inserted slab rows
        for vid in vectors:
            if not vid:
                raise ValueError("vector ids must be non-empty strings")
        with self.metrics.timed("batch_store"), self._lock:
            placed: dict[str, tuple[int, int]] = {}  # id -> (shard, slot)
            for vid, vec in vectors.items():
                arr = self._check_vector(vec)
                shard = self._shard_for(vid)
                if self.registries[shard].contains(vid):
                    updates.append((vid, arr))
                else:
                    ids, arrs = by_shard.setdefault(shard, ([], []))
                    ids.append(vid)
                    arrs.append(arr)
            for shard, (ids, arrs) in by_shard.items():
                rows = np.stack(arrs)
                slots = self.indices[shard].add_batch(rows)
                self.registries[shard].put(ids, [int(s) for s in slots])
                self.raws.write(shard, np.asarray(slots, np.int64), rows)
                for vid, slot in zip(ids, slots):
                    placed[vid] = (shard, int(slot))
            # updates group per shard too: one stacked update_slots +
            # raw write per shard, not a per-id device dispatch (30
            # rows/s vs thousands — the store_scale.py update stage)
            upd_by_shard: dict[int, tuple[list, list, list]] = {}
            for vid, arr in updates:
                shard = self._shard_for(vid)
                slot = int(self.registries[shard].lookup(vid))
                vids, ss, arrs = upd_by_shard.setdefault(
                    shard, ([], [], [])
                )
                vids.append(vid)
                ss.append(slot)
                arrs.append(arr)
            for shard, (vids, ss, arrs) in upd_by_shard.items():
                slots = np.asarray(ss, np.int64)
                rows = np.stack(arrs)
                self.indices[shard].update_slots(slots, rows)
                self.raws.write(shard, slots, rows)
                for vid, slot in zip(vids, ss):
                    placed[vid] = (shard, slot)
            for vid in vectors:
                shard, slot = placed[vid]
                self.meta.set(shard, slot, metadata.get(vid, {}))
            self._after_mutation(len(vectors))
        return len(vectors)

    def bulk_load(
        self,
        ids: list[str],
        vectors: np.ndarray,
        metadata_columns: dict[str, Any] | None = None,
    ) -> int:
        """Corpus-scale ingest: fresh ids only, vectorized bookkeeping.

        ``metadata_columns`` gives per-key value arrays aligned with
        ``ids`` (every row shares the key set — the columnar fast path).
        One index scatter / registry put / metadata column-set / raw
        write per shard; no per-row Python in the store layer beyond the
        shard hash. This is the 10M-row path ``batch_store``'s per-id
        dict walk cannot serve (SURVEY §3.2's hot-loop replacement at
        store level)."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(
                f"bulk_load expects (n, {self.dim}) vectors, "
                f"got {vectors.shape}"
            )
        if len(ids) != len(vectors):
            raise ValueError("ids and vectors length mismatch")
        if len(set(ids)) != len(ids):
            # a duplicate inside the batch would insert BOTH rows but
            # register only the last slot — the first becomes a ghost
            # row that fills candidate positions forever
            raise ValueError("bulk_load ids must be unique within the batch")
        with self.metrics.timed("bulk_load"), self._lock:
            if any(reg.size() for reg in self.registries):
                for vid in ids:  # fresh-only contract (updates: batch_store)
                    if self.registries[self._shard_for(vid)].contains(vid):
                        raise ValueError(
                            f"bulk_load is insert-only; id {vid!r} exists"
                        )
            if self.num_shards == 1:
                shard_of = np.zeros(len(ids), np.int64)
            else:
                shard_of = np.fromiter(
                    (stable_shard(v, self.num_shards) for v in ids),
                    np.int64, len(ids),
                )
            for shard in range(self.num_shards):
                sel = np.nonzero(shard_of == shard)[0]
                if len(sel) == 0:
                    continue
                rows = vectors[sel]
                slots = self.indices[shard].add_batch(rows)
                slots = np.asarray(slots, np.int64)
                self.registries[shard].put(
                    [ids[i] for i in sel], [int(s) for s in slots]
                )
                self.raws.write(shard, slots, rows)
                cols = {
                    k: v[sel] if isinstance(v, np.ndarray)
                    else [v[i] for i in sel]
                    for k, v in (metadata_columns or {}).items()
                }
                self.meta.set_columns(shard, slots, cols)
            self._after_mutation(len(ids))
        # set-up edge, outside the store lock: a corpus-scale ingest is
        # not a per-row write (those never settle)
        heap.settle("bulk_load")
        return len(ids)

    def delete(self, vector_id: str) -> bool:
        with self._lock:
            shard = self._shard_for(vector_id)
            slot = self.registries[shard].remove(vector_id)
            if slot is None:
                return False
            self.indices[shard].remove_slots(np.asarray([slot]))
            self.meta.drop(shard, int(slot))
            # The raw row is NOT dropped: every read path is gated on
            # registry/index liveness, and the last slab-external
            # checkpoint may still list this slot as valid — eagerly
            # clearing the row would turn a post-save delete + crash
            # into a failed slab restore (whole-shard loss) instead of
            # the intended lose-only-unacknowledged-mutations recovery.
            # The bytes are reclaimed when the slot is rewritten or the
            # shard compacts (raws.remap clears stale flags).
            self._after_mutation()
        return True

    def update_metadata(self, vector_id: str, metadata: dict[str, Any]) -> bool:
        with self._lock:
            shard = self._shard_for(vector_id)
            slot = self.registries[shard].lookup(vector_id)
            if slot is None:
                return False
            self.meta.set(shard, int(slot), metadata)
            self._after_mutation()
        return True

    # -- read -------------------------------------------------------------
    def get(self, vector_id: str) -> tuple[list[float], dict[str, Any]] | None:
        # Locked: optimize()'s compact+registry remap can reallocate slots
        # mid-lookup, so an unlocked read could fetch the wrong slab row.
        with self._lock:
            shard = self._shard_for(vector_id)
            slot = self.registries[shard].lookup(vector_id)
            if slot is None:
                return None
            rows, have = self.raws.read(shard, np.asarray([slot]))
            if have[0]:
                vec = rows[0]
            else:
                vec = self.indices[shard].get_vectors(np.asarray([slot]))[0]
            return vec.tolist(), self.meta.get(shard, int(slot)) or {}

    def count(self) -> int:
        return sum(reg.size() for reg in self.registries)

    # -- search -----------------------------------------------------------
    def search(
        self,
        query_vector: Any,
        limit: int = 10,
        threshold: float = 0.0,
        filter_metadata: dict[str, Any] | None = None,
    ) -> list[SearchHit]:
        return self.search_batch(
            np.asarray(query_vector, np.float32)[None, :],
            limit=limit,
            threshold=threshold,
            filter_metadata=filter_metadata,
        )[0]

    def search_batch(
        self,
        query_vectors: Any,
        limit: int = 10,
        threshold: float = 0.0,
        filter_metadata: dict[str, Any] | None = None,
    ) -> list[list[SearchHit]]:
        """Batched shard fan-out + merge.

        The store lock covers only host bookkeeping (filter-mask build,
        id-table snapshot); device compute runs lock-free so concurrent
        searches overlap — each index snapshots its immutable device
        arrays internally (index/base.py ``_mu``). The merge is
        vectorized numpy over the tiny (B, shards*k) candidate set and
        id resolution is one fancy-index per shard, replacing the
        per-candidate ``id_of`` loop that burned host ms under the lock.
        """
        queries = self._query_batch(query_vectors)
        b = len(queries)
        with self.metrics.timed(
            "search_batch" if b > 1 else "search", "store.search_batch",
            b=b, k=limit, shards=len(self.indices),
        ) as call:
            return self._search_passes(
                call, queries, b, limit, threshold, filter_metadata
            )

    def _search_passes(
        self, call, queries, b, limit, threshold, filter_metadata
    ) -> list[list[SearchHit]]:
        """``search_batch``'s work on validated queries, inside its span
        ``call``."""
        use_pre = self._use_prefilter(filter_metadata)
        rerank = self._rerank_enabled()
        fetch_k = self._fetch_k(limit, filter_metadata, use_pre, rerank)

        # Epoch-validated optimistic concurrency: device searches AND
        # the slot-keyed merge (id table, metadata, raw re-rank rows)
        # run lock-free, but a mutation anywhere in that window could
        # recycle a slot and pair an old id with another vector's
        # metadata or exact score. If the mutation epoch moved, retry
        # the whole pass; after two misses fall back to running it all
        # under the store lock (serialized but exact — mutations are
        # rarer than searches).
        for attempt in range(3):
            call.set(attempts=attempt + 1)
            hold_lock = attempt == 2
            waited = TRACER.clock()
            self._lock.acquire()
            held = True
            try:
                with self.metrics.timed("search_prep", "store.prep") as prep:
                    prep.set(lock_wait_ns=TRACER.clock() - waited)
                    indices, id_tables, epoch = self._snapshot_locked()
                    masks = [
                        self._filter_mask(shard, filter_metadata)
                        if use_pre else None
                        for shard in range(len(indices))
                    ]
                    if len(indices) > 1 and self._fanout_pool is None:
                        # created under the lock: a lock-free lazy init
                        # races concurrent first searches and leaks the
                        # losing executor's threads
                        import concurrent.futures as cf

                        self._fanout_pool = cf.ThreadPoolExecutor(
                            max_workers=len(indices),
                            thread_name_prefix="wdbx-fanout",
                        )
                if not hold_lock:
                    self._lock.release()
                    held = False
                pool = self._fanout_pool
                # indexes on a mesh spanning ranks (replicated or not)
                # search one after another: every rank must issue their
                # collectives in the same order
                spread = self._spans_ranks()
                if len(indices) > 1 and pool is not None and not spread:
                    # fan shards out on threads: each search holds only
                    # its index's read lock, so dispatch+transfer round
                    # trips overlap across shards (persistent pool; a
                    # LOCAL reference — shutdown() may null the attr
                    # while this search is in flight)
                    origin = TRACER.current()

                    def shard_search(si):
                        with TRACER.adopt(origin):
                            return si[1].search(
                                queries, fetch_k, slot_mask=masks[si[0]]
                            )

                    per_shard = list(
                        pool.map(shard_search, enumerate(indices))
                    )
                else:
                    # single shard, or the pool was torn down mid-shutdown
                    per_shard = [
                        index.search(queries, fetch_k, slot_mask=masks[s])
                        for s, index in enumerate(indices)
                    ]
                results = self._merge_hits(
                    per_shard, id_tables, queries, b, limit, threshold,
                    filter_metadata, use_pre, rerank,
                )
                if hold_lock or self._epoch == epoch:
                    break
            finally:
                if held:
                    self._lock.release()
        return results

    # -- pipelined serving (VERDICT r4 ask #4) ----------------------------
    # submit() dispatches the device work for a whole batch WITHOUT
    # blocking on the transfer; resolve() materializes and merges.
    # A serving loop (api/batching.QueryBatcher) keeps the next flush's
    # dispatch in flight while the previous one materializes — the
    # engine-level double-buffering (index.search_pipelined), carried
    # through the store's id/metadata/re-rank merge.
    def search_batch_submit(
        self,
        query_vectors: Any,
        limit: int = 10,
        threshold: float = 0.0,
        filter_metadata: dict[str, Any] | None = None,
    ):
        """Dispatch a query batch; returns an opaque handle for
        ``search_batch_resolve``. Falls back to a pre-resolved handle
        when the batch cannot pipeline (a metadata filter)."""
        queries = self._query_batch(query_vectors)
        if filter_metadata:
            return (
                "sync",
                self.search_batch(
                    queries, limit, threshold, filter_metadata
                ),
            )
        b = len(queries)
        rerank = self._rerank_enabled()
        fetch_k = self._fetch_k(limit, filter_metadata=None, use_pre=False,
                                rerank=rerank)
        with self._lock:
            indices, id_tables, epoch = self._snapshot_locked()
        # no power-of-two padding of the batch: nothing compiles per
        # batch width here
        handles = [
            index.search_pipelined(queries[None], fetch_k, materialize=False)
            for index in indices
        ]
        return (
            "pipelined", handles, indices, id_tables, queries, b,
            limit, threshold, rerank, epoch,
        )

    def search_batch_resolve(self, handle) -> list[list[SearchHit]]:
        """Materialize a ``search_batch_submit`` handle into ranked
        hits. Epoch-validated: if a mutation landed between submit and
        resolve, the merge re-runs synchronously (slots could have been
        recycled under the in-flight dispatch)."""
        if handle[0] == "sync":
            return handle[1]
        (_, handles, indices, id_tables, queries, b, limit, threshold,
         rerank, epoch) = handle
        per_shard = []
        for index, h in zip(indices, handles):
            scores, slots = index.resolve_pipelined(h)
            per_shard.append((scores[0][:b], slots[0][:b]))
        results = self._merge_hits(
            per_shard, id_tables, queries, b, limit, threshold,
            None, False, rerank,
        )
        if self._epoch != epoch:
            return self.search_batch(queries, limit, threshold)
        return results

    def _query_batch(self, query_vectors: Any) -> np.ndarray:
        """Queries as a float32 (B, d) batch; raises on a dimension
        mismatch."""
        queries = np.asarray(query_vectors, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.shape[-1] != self.dim:
            raise ValueError(
                f"query dimension {queries.shape[-1]} does not match store "
                f"dimension {self.dim}"
            )
        return queries

    def _fetch_k(self, limit: int, filter_metadata, use_pre: bool,
                 rerank: bool) -> int:
        """Candidates each shard returns: ``limit``, deeper for a
        post-filter and for the exact re-rank."""
        fetch_k = limit
        if filter_metadata and not use_pre:
            fetch_k = max(limit * 4, 50)
        if rerank:
            # headroom for re-ordering: int8's ranking is near-correct
            # (2x suffices); int4's raw ranking is noisy (~0.75 raw
            # recall@10), so the exact re-rank draws from a much deeper
            # candidate pool (VERDICT r2 ask #2: over-fetch + re-rank)
            fetch_k = max(fetch_k, limit * self._rerank_fetch_factor())
        return fetch_k

    def _snapshot_locked(self):
        """Under the store lock: the indexes, their slot -> id tables and
        the mutation epoch that validates a lock-free merge."""
        indices = list(self.indices)
        id_tables = [self._ids_for(s) for s in range(len(indices))]
        return indices, id_tables, self._epoch

    def _merge_hits(
        self, per_shard, id_tables, queries, b, limit, threshold,
        filter_metadata, use_pre, rerank,
    ) -> list[list[SearchHit]]:
        """Merge per-shard candidates into ranked hits: vectorized id
        resolution, optional exact re-rank from the raw store, metadata
        attach. Runs inside the caller's epoch-retry window — every
        slot-keyed read here is validated (or serialized) by it."""
        with self._merge_gate, \
                self.metrics.timed("merge", "store.merge") as merge:

            n_shards = len(per_shard)
            all_scores = np.concatenate([s for s, _ in per_shard], axis=1)
            all_slots = np.concatenate([sl for _, sl in per_shard], axis=1)
            all_shard = np.concatenate(
                [np.full_like(sl, i) for i, (_, sl) in enumerate(per_shard)],
                axis=1,
            )
            order = np.argsort(-all_scores, axis=1, kind="stable")
            all_scores = np.take_along_axis(all_scores, order, axis=1)
            all_slots = np.take_along_axis(all_slots, order, axis=1)
            all_shard = np.take_along_axis(all_shard, order, axis=1)

            # Vectorized slot -> id: one fancy-index per shard over the
            # cached object table.
            ids = np.full(all_slots.shape, None, dtype=object)
            for s in range(n_shards):
                table = id_tables[s]
                sel = (all_shard == s) & (all_slots >= 0)
                sel &= all_slots < len(table)
                if sel.any():
                    ids[sel] = table[all_slots[sel]]
            if rerank:
                # Exact re-scoring of the candidate set from the raw
                # store (the quantized slab ranked them; one host matmul
                # per shard fixes the ranking): SURVEY §7's int8/int4
                # recall protection. Vectorized: unique slots gather
                # once from the memmap, one (U, d) @ (d, B) matmul, and
                # fancy-index assignment — no per-candidate Python loop
                # and no per-id dict (the dict could not exist at 20M).
                metric = getattr(self.indices[0], "metric", "cosine")
                qn = queries
                if metric == "cosine":
                    qn = queries / np.maximum(
                        np.linalg.norm(queries, axis=-1, keepdims=True),
                        1e-12,
                    )
                for s in range(n_shards):
                    sel = (all_shard == s) & (all_slots >= 0)
                    if not sel.any():
                        continue
                    uniq, inv = np.unique(
                        all_slots[sel], return_inverse=True
                    )
                    qi_idx, ci_idx = np.nonzero(sel)
                    # The (U, d) @ (d, B) matmul scores EVERY unique
                    # candidate against EVERY query — U·d·B FLOPs. When
                    # candidate sets are mostly disjoint across queries
                    # (large corpora), that wastes ~B x; the per-pair
                    # gather scores exactly the (candidate, query) pairs
                    # present: |sel|·d FLOPs. Keep the matmul (BLAS) only
                    # while the overlap is high enough to pay for it.
                    if len(uniq) <= 4 * (sel.sum() // max(1, b)) or b == 1:
                        rows, have = self.raws.read(s, uniq)
                        if not have.any():
                            continue
                        if metric == "cosine":
                            rows = rows / np.maximum(
                                np.linalg.norm(
                                    rows, axis=-1, keepdims=True
                                ),
                                1e-12,
                            )
                        scores_u = rows @ qn.T  # (U, B)
                        ok = have[inv]
                        all_scores[qi_idx[ok], ci_idx[ok]] = scores_u[
                            inv[ok], qi_idx[ok]
                        ]
                    else:
                        rows, have = self.raws.read(
                            s, all_slots[sel]
                        )  # (P, d) pairs
                        if not have.any():
                            continue
                        if metric == "cosine":
                            rows = rows / np.maximum(
                                np.linalg.norm(
                                    rows, axis=-1, keepdims=True
                                ),
                                1e-12,
                            )
                        pair_scores = np.einsum(
                            "pd,pd->p", rows, qn[qi_idx]
                        )
                        all_scores[qi_idx[have], ci_idx[have]] = (
                            pair_scores[have]
                        )
                order = np.argsort(-all_scores, axis=1, kind="stable")
                all_scores = np.take_along_axis(all_scores, order, axis=1)
                all_slots = np.take_along_axis(all_slots, order, axis=1)
                all_shard = np.take_along_axis(all_shard, order, axis=1)
                ids = np.take_along_axis(ids, order, axis=1)

            keep = np.isfinite(all_scores)
            # the reference filters only when threshold > 0 (reference
            # wdbx/core/vector_store.py:332-334) — the 0.0 default must
            # NOT drop negative-similarity hits
            if threshold is not None and threshold > 0:
                keep &= all_scores >= threshold

            post = (
                compile_filter(filter_metadata)
                if (filter_metadata and not use_pre)
                else None
            )
            results: list[list[SearchHit]] = []
            if post is None:
                # Two-phase fast path: pick hit positions first (id
                # dedupe only — no metadata reads), then attach metadata
                # with ONE vectorized column gather per shard. The
                # per-hit ``meta.get`` walk was ~O(hits x columns)
                # Python scalar reads per batch — the next serving wall
                # after dispatch pipelining (VERDICT r4 ask #4). The
                # walks read Python lists: a numpy scalar read costs
                # several times a list item's, and the merge holds the
                # interpreter that every concurrent caller waits for.
                keep_l = keep.tolist()
                ids_l = ids.tolist()
                rows_ci: list[list[int]] = []
                hq: list[int] = []
                hc: list[int] = []
                for qi in range(b):
                    row: list[int] = []
                    seen: set[str] = set()  # indexes may yield an id twice
                    for ci, (kept, vid) in enumerate(zip(keep_l[qi],
                                                         ids_l[qi])):
                        if not kept or vid is None or vid in seen:
                            continue
                        seen.add(vid)
                        row.append(ci)
                        if len(row) >= limit:
                            break
                    rows_ci.append(row)
                    hq.extend([qi] * len(row))
                    hc.extend(row)
                hq_a = np.asarray(hq, np.int64)
                hc_a = np.asarray(hc, np.int64)
                metas: list[dict | None] = [None] * len(hq)
                for s in range(n_shards):
                    sel = (
                        all_shard[hq_a, hc_a] == s
                        if len(hq) else np.zeros(0, bool)
                    )
                    if not sel.any():
                        continue
                    where = np.nonzero(sel)[0]
                    got = self.meta.get_many(
                        s, all_slots[hq_a[where], hc_a[where]]
                    )
                    for w, m in zip(where, got):
                        metas[w] = m
                scores_l = all_scores.tolist()
                pos = 0
                for qi in range(b):
                    hits: list[SearchHit] = []
                    id_row, score_row = ids_l[qi], scores_l[qi]
                    for ci in rows_ci[qi]:
                        hits.append((
                            id_row[ci],
                            score_row[ci],
                            metas[pos] or {},
                        ))
                        pos += 1
                    results.append(hits)
                merge.set(hits=pos)
                return results
            for qi in range(b):
                hits: list[SearchHit] = []
                seen: set[str] = set()  # indexes may yield an id twice
                row_keep = keep[qi]
                for ci in np.nonzero(row_keep)[0]:
                    vid = ids[qi, ci]
                    if vid is None or vid in seen:
                        continue
                    meta = self.meta.get(
                        int(all_shard[qi, ci]), int(all_slots[qi, ci])
                    ) or {}
                    if post is not None and not post(meta):
                        continue
                    seen.add(vid)
                    hits.append((vid, float(all_scores[qi, ci]), meta))
                    if len(hits) >= limit:
                        break
                results.append(hits)
            merge.set(hits=sum(map(len, results)))
        return results

    def _ids_for(self, shard: int) -> np.ndarray:
        """Slot -> id object table for one shard, cached until the next
        mutation (vectorizes id resolution in the search merge)."""
        table = self._slot_ids_cache[shard]
        if table is None:
            reg = self.registries[shard]
            if hasattr(reg, "id_table"):
                # one C pass (native registry) or one dict walk (fallback)
                table = np.array(reg.id_table(), dtype=object)
            else:
                items = reg.items()
                n = 1 + max((int(slot) for _, slot in items), default=-1)
                table = np.full(n, None, dtype=object)
                for vid, slot in items:
                    table[int(slot)] = vid
            self._slot_ids_cache[shard] = table
        return table

    def _filter_mask(
        self, shard: int, flt: dict[str, Any] | None
    ) -> np.ndarray | None:
        """Per-shard pre-filter mask, cached by filter key and
        invalidated on mutation. The build is vectorized numpy over the
        metadata columns — O(N) in C per first-seen filter, not the
        per-slot Python walk (SURVEY §7 filter ABI)."""
        if not flt:
            return None
        key = (json.dumps(flt, sort_keys=True, default=str), shard)
        mask = self._mask_cache.get(key)
        if mask is None:
            index = self.indices[shard]
            mask = self.meta.mask(shard, flt, index.capacity)
            self._mask_cache[key] = mask
        return mask

    def _invalidate_snapshots(self) -> None:
        """Drop cached id tables + filter masks; call on any mutation
        that changes slots, registry contents, or metadata."""
        self._epoch += 1
        self._slot_ids_cache = [None] * len(self.indices)
        self._mask_cache.clear()

    def _rerank_enabled(self) -> bool:
        if self.rerank in (True, False):
            return bool(self.rerank)
        if not self.raws.enabled:
            return False
        return any(
            getattr(index, "dtype_name", "") in ("int8", "int4")
            for index in self.indices
        )

    def _rerank_fetch_factor(self) -> int:
        forced = getattr(self, "_fetch_factor_force", None)
        if forced:  # a tune() probe in flight pins the factor
            return forced
        configured = self.config.get("RERANK_FETCH_FACTOR")
        if configured:
            return max(1, int(configured))
        tuned = getattr(self, "_tuned_fetch_factor", None)
        if tuned:
            return tuned
        if any(
            getattr(index, "dtype_name", "") == "int4"
            for index in self.indices
        ):
            return 20
        return 2

    def _use_prefilter(self, flt: dict[str, Any] | None) -> bool:
        if not flt:
            return False
        if self.filter_mode == "pre":
            return True
        if self.filter_mode == "post":
            return False
        # auto: pre-filter always — the columnar mask build is vectorized
        # numpy (sub-second at 10M) and cached until the next mutation,
        # and pushdown keeps filtered queries returning a full `limit`
        # (the reference's host post-filter cannot — reference
        # wdbx/core/vector_store.py:414-463).
        return True

    # -- maintenance ------------------------------------------------------
    def clear(self) -> int:
        with self._lock:
            n = self.count()
            for index in self.indices:
                index.clear()
            self.registries = [_native.SlotRegistry() for _ in self.indices]
            self.meta.clear()
            self.raws.clear()
            self._poisoned.clear()  # explicit wipe: empty is the truth
            self._invalidate_snapshots()
            self.save()
        return n

    def optimize(self, background: bool | None = None) -> bool:
        """Compact fragmented shards (remapping the id registry) and run
        index-specific optimization (IVF retrain).

        The retrain phase runs OUTSIDE the store-wide lock — each
        index's own read/write locks guard its internals, and rebuilds
        keep external slots stable — so concurrent searches keep
        serving through it (otherwise the serve-through background
        rebuild would be moot: the store lock would block every reader
        for the full build anyway). ``background`` forces the
        clustered shards' COW serve-through rebuild on/off for this
        call without touching their configured ``background_rebuild``;
        ``None`` defers to config (``IVF_BACKGROUND_REBUILD``).
        """
        with self._lock:
            for shard, index in enumerate(self.indices):
                stats = index.get_stats()
                tombstones = stats.get("tombstones", 0)
                if tombstones > max(64, 0.2 * max(1, index.count())):
                    old, new = index.compact()
                    remap = {int(o): int(nw) for o, nw in zip(old, new)}
                    items = self.registries[shard].items()
                    reg = _native.SlotRegistry()
                    reg.put(
                        [vid for vid, _ in items],
                        [remap[int(slot)] for _, slot in items],
                    )
                    self.registries[shard] = reg
                    # slot-aligned sidecars follow the renumbering
                    self.meta.remap(shard, old, new)
                    self.raws.remap(shard, old, new)
            # compaction renumbered slots: drop caches before unlocking
            self._invalidate_snapshots()
            targets = list(self.indices)
        for index in targets:
            if background is not None and hasattr(index, "build_background"):
                index.optimize(background=background)
            else:
                index.optimize()
        with self._lock:
            self._invalidate_snapshots()
        return True

    def _sample_raw_rows(
        self, shard: int, n: int, rng: np.random.Generator | None = None
    ) -> tuple[np.ndarray, list[int], list[str]]:
        """Up to ``n`` stored rows of one shard for tuning probes
        (raw-store rows when kept, else dequantized slab reads).

        The sample is a uniform RANDOM subset of the registry — the
        first-n rows are insertion-ordered and bias the tuner toward
        whatever was loaded first (VERDICT r4 ask #6). Returns
        (rows, slots, ids) so callers can hold each query's own row out
        of its oracle set."""
        items = self.registries[shard].items()
        if rng is not None and len(items) > n:
            pick = rng.choice(len(items), size=n, replace=False)
            items = [items[int(i)] for i in pick]
        ids = [vid for vid, _ in items][:n]
        slots = [int(slot) for _, slot in items][:n]
        if not slots:
            return np.zeros((0, self.dim), np.float32), [], []
        rows, have = self.raws.read(shard, np.asarray(slots, np.int64))
        if not have.all():
            missing = np.nonzero(~have)[0]
            fetched = self.indices[shard].get_vectors(
                np.asarray([slots[i] for i in missing], np.int64)
            )
            rows[missing] = fetched
        return rows.astype(np.float32), slots, ids

    def tune(self, target_recall: float = 0.95, sample: int = 64,
             k: int = 10) -> dict[str, Any]:
        """Tune every ANN shard's nprobe to the smallest value hitting
        ``target_recall``, using stored vectors as the query sample (the
        binary-search tuner each index carries; SURVEY §7's recall
        loop, operator-facing). Returns per-shard achieved recall; flat
        shards report 1.0 (always exact).

        Sample hygiene (VERDICT r4 ask #6): queries are a RANDOM
        registry subset (seeded by ``TUNE_SEED``, default 0, for
        reproducible re-tunes) and evaluation is HELD-OUT — each
        query's own slot is dropped from both oracle and ANN sets."""
        report: dict[str, Any] = {"target": target_recall, "shards": []}
        # Snapshot the query samples under the store lock, then run the
        # sweep OUTSIDE it: each trial is several device searches (and a
        # possible rebuild), and holding the store-wide lock across that
        # blocked all reads and writes for minutes via POST /api/v1/tune.
        # Transiently observed nprobe values mid-sweep are benign (results
        # stay correct, only recall varies); each index's own read/write
        # locks guard its internal state.
        rng = np.random.default_rng(int(self.config.get("TUNE_SEED", 0)))
        with self._lock:
            shards = list(enumerate(self.indices))
            samples = [
                self._sample_raw_rows(shard, sample, rng=rng)
                for shard, _ in shards
            ]
        for (shard, index), (rows, slots, _ids) in zip(shards, samples):
            entry: dict[str, Any] = {"shard": shard, "type": index.kind}
            tune = getattr(index, "tune", None)
            if tune is None or index.count() == 0 or not len(rows):
                entry["recall"] = 1.0
            else:
                try:
                    entry["recall"] = float(
                        tune(rows, k=k, target_recall=target_recall,
                             exclude_slots=np.asarray(slots, np.int64))
                    )
                    entry["nprobe"] = getattr(index, "nprobe", None)
                except (ValueError, IndexError) as e:
                    # the snapshot can go stale under concurrent deletes;
                    # report the shard rather than failing the whole sweep
                    entry["error"] = str(e)
                    entry["recall"] = 0.0
            report["shards"].append(entry)
        report["achieved"] = min(
            (e["recall"] for e in report["shards"]), default=1.0
        )
        if self._rerank_enabled():
            report["fetch_factor"] = self._tune_fetch_factor(
                target_recall, sample, k
            )
        return report

    def _tune_fetch_factor(self, target: float, sample: int, k: int):
        """Pick the smallest re-rank over-fetch factor whose re-ranked
        top-k converges to the deep-pool (64x) re-ranked top-k — the
        exact quantity over-fetch controls: whether the true top-k made
        it into the candidate pool (VERDICT r2 ask #2's binary-search;
        the re-rank itself is already exact on whatever candidates
        arrive). Convergence-vs-deep needs no external f32 oracle and
        stays correct for int8 and int4 alike. The probe pins the
        factor store-wide; concurrent searches transiently see the
        probed factor (results stay correct, only recall varies — same
        contract as the nprobe sweep above).

        Sample hygiene matches tune(): random registry subset, and each
        query's own id is held out of both the probed and the deep id
        sets (a self-hit survives any fetch factor and flatters the
        convergence measure by ~1/k)."""
        rng = np.random.default_rng(int(self.config.get("TUNE_SEED", 0)))
        with self._lock:
            rows, _slots, own_ids = self._sample_raw_rows(
                0, sample, rng=rng
            )
        if not len(rows):
            return None
        queries = rows.astype(np.float32)

        def ids_at(factor: int) -> list[set]:
            self._fetch_factor_force = factor
            try:
                res = self.search_batch(queries, limit=k + 1)
            finally:
                self._fetch_factor_force = None
            return [
                set([h[0] for h in hits if h[0] != own][:k])
                for hits, own in zip(res, own_ids)
            ]

        with self._tune_ff_mu:
            try:
                deep = ids_at(64)
                chosen, achieved = 64, 1.0
                for factor in (2, 4, 8, 16, 32):
                    got = ids_at(factor)
                    rec = float(np.mean([
                        len(g & d) / max(1, len(d))
                        for g, d in zip(got, deep)
                    ]))
                    if rec >= target:
                        chosen, achieved = factor, rec
                        break
            except (ValueError, IndexError) as e:
                # the sample can go stale under concurrent deletes — keep
                # the nprobe results already in the report (same contract
                # as the per-shard sweep) instead of failing tune()
                return {"error": str(e)}
            self._tuned_fetch_factor = chosen
        return {"factor": chosen, "recall_vs_deep": round(achieved, 4)}

    def get_stats(self) -> dict[str, Any]:
        return {
            "latency": self.metrics.summary(),
            "vector_count": self.count(),
            "vector_dimension": self.dim,
            "num_shards": self.num_shards,
            "metadata_count": self.meta.count(),
            "raw_store": self.raws.dtype_name,
            "data_dir": self.data_dir,
            "indices": [index.get_stats() for index in self.indices],
        }

    # -- integrity / recovery ---------------------------------------------
    # The reference's failure story is skeleton-grade (static status flags,
    # no heartbeats, dead failover paths — SURVEY.md §5.3). Here recovery
    # is checkpoint-based: verify() detects registry/mask divergence and
    # recover() rebuilds a shard from its last persisted state.
    def _spans_ranks(self) -> bool:
        """Whether an index lies on a mesh spanning ranks (replicated or
        not): every rank then makes its calls in the same order."""
        return any(getattr(getattr(ix, "mesh", None), "is_global", False)
                   for ix in self.indices)

    def verify(self) -> dict[str, Any]:
        """Cross-check host bookkeeping against device validity masks.
        Returns a report; 'consistent' is False if any shard diverges.
        On a mesh spanning ranks the ranks agree: a shard is ok only
        where every rank found it so (one ``all_gather_object``), so
        every rank takes the same decision at each layer of ``heal``."""
        report: dict[str, Any] = {"shards": [], "consistent": True}
        orphans = 0
        with self._lock:
            for shard, index in enumerate(self.indices):
                reg = self.registries[shard]
                valid_count = index.valid_count()
                entry = {
                    "shard": shard,
                    "registry_ids": reg.size(),
                    "index_size": index.count(),
                    "valid_slots": valid_count,
                    "ok": reg.size() == index.count() == valid_count,
                }
                if not entry["ok"]:
                    report["consistent"] = False
                report["shards"].append(entry)
                # metadata present at slots the registry does not own
                present = np.asarray(self.meta.iter_present(shard), np.int64)
                if len(present):
                    reg_slots = np.asarray(
                        [int(s) for _, s in reg.items()], np.int64
                    )
                    orphans += int(
                        (~np.isin(present, reg_slots)).sum()
                    )
            report["orphan_metadata"] = orphans
        if self._spans_ranks():
            from wdbx_tpu_torch.parallel import collective

            verdicts = collective.all_gather_object(
                [entry["ok"] for entry in report["shards"]])
            for i, entry in enumerate(report["shards"]):
                entry["failing_ranks"] = [r for r, v in enumerate(verdicts)
                                          if not v[i]]
                entry["ok"] = not entry["failing_ranks"]
            report["consistent"] = all(e["ok"] for e in report["shards"])
        return report

    def recover(self, shard: int, clear_on_failure: bool = False) -> bool:
        """Rebuild one shard from the newest COMPLETE checkpoint
        generation (store/atomic.py — a torn save can never be picked:
        generations become visible only after their manifest + rename +
        CURRENT commit; heal() therefore always restores a consistent
        index+registry pair, at worst one save older). Returns
        False when no usable checkpoint exists — in-memory state is
        left UNTOUCHED when the failure precedes any state replacement,
        unless ``clear_on_failure`` is set (a flapping health check
        must never wipe live rows that were simply not yet saved;
        clearing is only for callers that know the state is already
        corrupt). If the checkpoint LOADED but a later step failed
        (e.g. slab restore with missing raw rows), the live state is
        already gone: the shard is cleared and poisoned — save()
        refuses to commit until a later recover() succeeds or clear()
        declares the empty state intentional."""
        with self._lock:
            index = self.indices[shard]
            # re-resolve the newest complete generation: heal() may run
            # long after load, and save()s since then moved the pointer
            cur = self._ckpt.current()
            if cur is not None:
                self._ckpt_gen, self._ckpt_dir = cur
            loaded = False
            try:
                if index.load(self._index_load_path(shard)):
                    loaded = True  # live state replaced by checkpoint
                    self._maybe_restore_slab(shard, index)
                    ids, slots = self._load_ids(
                        self._index_load_path(shard)
                    )
                    reg = _native.SlotRegistry()
                    reg.put(ids, slots)
                    self.registries[shard] = reg
                    self._poisoned.discard(shard)
                    self._invalidate_snapshots()
                    return True
            except (ValueError, OSError, KeyError) as e:
                logger.warning("recover(%d) failed: %s", shard, e)
            if loaded or clear_on_failure:
                # past index.load() the live state is GONE — a failure
                # after that (e.g. slab restore with missing raw rows)
                # must not leave the checkpoint/old-registry hybrid
                # serving garbage. Clear the shard and POISON it:
                # save() refuses to commit a generation over the last
                # complete one until a later recover()/load succeeds.
                index.clear()
                self.registries[shard] = _native.SlotRegistry()
                if loaded:
                    self._poisoned.add(shard)
                self._invalidate_snapshots()
            return False

    def warm(self, max_batch: int = 128, limit: int = 10) -> int:
        """Serve one batch of ``max_batch`` random queries, direct and
        pipelined, so that the first live request does not pay the
        one-time costs: the kernels' nvcc build at first use and the
        device libraries' set-up. Nothing is compiled per batch width
        (no padding, no traced programs), so one width suffices, and
        then settles the heap (utils/heap.py). Returns the number of
        widths served (1); no-op on an empty store."""
        if self.count() == 0:
            return 0
        rng = np.random.default_rng(0)
        q = rng.standard_normal((max(1, int(max_batch)), self.dim))
        q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(
            np.float32
        )
        self.search_batch(q, limit=limit)
        self.search_batch_resolve(self.search_batch_submit(q, limit=limit))
        heap.settle("warm")
        return 1

    # -- persistence ------------------------------------------------------
    # Checkpoints are crash-atomic generation directories
    # (store/atomic.py): save() stages everything under
    # checkpoint/g{N}.tmp, fsyncs, renames, then flips CURRENT.json —
    # a SIGKILL in any window leaves the previous complete generation
    # serving (the reference tears its in-place files and falls back to
    # a FRESH index, reference wdbx/core/indexing.py:309-315). The raw
    # memmap sits OUTSIDE the generations: it is written in place at
    # mutation time, slot-granular, so a crash loses only rows whose
    # writes were in flight (those mutations were unacknowledged).
    def _legacy_index_path(self, shard: int) -> str:
        return os.path.join(self.data_dir, "indices", f"shard_{shard}")

    def _index_load_path(self, shard: int) -> str:
        if self._ckpt_dir:
            return os.path.join(self._ckpt_dir, "indices", f"shard_{shard}")
        return self._legacy_index_path(shard)

    def save(self) -> None:
        with self._lock:
            if self._poisoned:
                raise RuntimeError(
                    f"shards {sorted(self._poisoned)} are in a failed-"
                    "recovery state (checkpoint loaded but its slab "
                    "restore failed); refusing to commit a checkpoint "
                    "generation over the last complete one. Repair the "
                    "raw store and recover() again, or clear() to "
                    "discard."
                )
            gen = self._ckpt_gen + 1
            stage = self._ckpt.stage(gen)
            meta_dir = os.path.join(stage, "metadata")
            self.meta.save(meta_dir)
            if self._tuned_fetch_factor:
                # persist alongside the nprobe the same tune() learned
                # (that one rides the index checkpoint) — a restart must
                # not silently revert to the static over-fetch default
                with open(os.path.join(meta_dir, "tuned.json"), "w") as f:
                    json.dump(
                        {"fetch_factor": self._tuned_fetch_factor}, f
                    )
            idx_dir = os.path.join(stage, "indices")
            for shard, index in enumerate(self.indices):
                path = os.path.join(idx_dir, f"shard_{shard}")
                if self._slab_external_ok(shard, index):
                    # Persist everything EXCEPT the slab; load rebuilds
                    # it from the raw store by H2D + device re-quantize,
                    # so save() never copies the slab back to the host.
                    index.save(path, skip_slab=True)
                else:
                    index.save(path)
                self._save_ids(path, self.registries[shard].items())
            # the raw memmap IS the on-disk format — flush dirty pages
            # (before commit: slab-external generations depend on it)
            self.raws.flush()
            self._ckpt_dir = self._ckpt.commit(gen, stage)
            self._ckpt_gen = gen
            # A committed generation supersedes every pre-generation
            # file this process ingested at load; leaving them would
            # resurrect stale rows on a later load. Only files we
            # actually READ are deleted — a blob we failed (or were
            # configured not) to read may be the only copy.
            legacy = os.path.join(self.data_dir, "metadata", "metadata.json")
            if self._legacy_meta_ingested and os.path.exists(legacy):
                os.remove(legacy)
            legacy_raw = os.path.join(self.data_dir, "vectors", "raw.npz")
            if self._legacy_raw_ingested and os.path.exists(legacy_raw):
                os.remove(legacy_raw)
            if self._oldlayout_loaded:
                self._remove_old_layout()
                self._oldlayout_loaded = False
            self._mutations_since_save = 0

    @staticmethod
    def _save_ids(path: str, items) -> None:
        """Binary id<->slot sidecar (``.ids.npz``: unicode id array +
        int64 slot array). A 10M-entry JSON object is slow to parse at
        load; the npz pair loads in C."""
        ids = np.array([k for k, _ in items])
        slots = np.fromiter(
            (int(s) for _, s in items), np.int64, len(items)
        )
        np.savez(path + ".ids.npz", ids=ids, slots=slots)

    @staticmethod
    def _load_ids(path: str) -> tuple[list, list]:
        """Read the id<->slot sidecar; falls back to the pre-r5
        ``.ids.json`` spelling for old checkpoints."""
        if os.path.exists(path + ".ids.npz"):
            data = np.load(path + ".ids.npz", allow_pickle=False)
            return data["ids"].tolist(), data["slots"].tolist()
        with open(path + ".ids.json") as f:
            id_map = json.load(f)
        return list(id_map.keys()), [int(s) for s in id_map.values()]

    def _maybe_restore_slab(self, shard: int, index: Any) -> None:
        """Rebuild a slab-external checkpoint's device slab from the
        raw store (chunked host read -> H2D -> device re-quantize).
        int8 raw stores ship their codes natively (4x fewer wire
        bytes, no host f32 temporaries) through reused scratch
        buffers; other precisions read dequantized f32. Raises
        ValueError when the raw store lost rows the checkpoint depends
        on — the caller's corrupt-checkpoint handling applies."""
        if not getattr(index, "_slab_restore_pending", False):
            return
        chunk = 262_144
        scratch: dict[str, np.ndarray] = {}

        def reader(slots: np.ndarray):
            if "q" not in scratch:
                scratch["q"] = np.empty((chunk, self.dim), np.int8)
                scratch["s"] = np.empty(chunk, np.float32)
            native = self.raws.read_native(
                shard, slots, out_q=scratch["q"], out_s=scratch["s"]
            )
            if native is not None:
                return native
            rows, have = self.raws.read(shard, slots)
            return rows, None, have

        index.restore_slab(reader, chunk=chunk)

    def _slab_external_ok(self, shard: int, index: Any) -> bool:
        """True when this shard's checkpoint may omit the device slab:
        quantized dtype (re-quantization from raw rows is within the
        slab's own quantization noise), the index supports positional
        restore, the raw store is live, and EVERY live slot has a raw
        row (gap -> full slab persists; a checkpoint must never depend
        on rows it cannot get back). ``CHECKPOINT_SLAB=full`` forces
        the full slab; ``auto`` (default) applies the gate."""
        mode = str(self.config.get("CHECKPOINT_SLAB", "auto")).lower()
        if mode == "full":
            return False
        if not (
            getattr(index, "supports_slab_external", False)
            and getattr(index, "dtype_name", "") in ("int8", "int4")
            and self.raws.enabled
        ):
            return False
        table = self._ids_for(shard)
        live_slots = np.nonzero(table != None)[0]  # noqa: E711
        if not len(live_slots):
            return True
        return bool(self.raws.has(shard, live_slots).all())

    def _remove_old_layout(self) -> None:
        """Drop pre-generation (r4-layout) checkpoint files this process
        loaded from, now superseded by a committed generation."""
        import glob
        import shutil

        for shard in range(self.num_shards):
            base = self._legacy_index_path(shard)
            for path in glob.glob(base + ".*"):
                try:
                    if os.path.isdir(path):  # orbax checkpoint dir
                        shutil.rmtree(path)
                    else:
                        os.remove(path)
                except OSError as e:
                    logger.warning("old-layout cleanup of %s: %s", path, e)
        meta_dir = os.path.join(self.data_dir, "metadata")
        for pattern in ("columns_shard*", "tuned.json"):
            for path in glob.glob(os.path.join(meta_dir, pattern)):
                try:
                    os.remove(path)
                except OSError as e:
                    logger.warning("old-layout cleanup of %s: %s", path, e)

    def _load(self) -> None:
        # ingestion provenance for save()'s legacy-blob cleanup: only a
        # blob THIS process read (into the columnar store / memmap) is
        # safe to delete
        self._legacy_meta_ingested = False
        self._legacy_raw_ingested = False
        # Resolve the newest complete checkpoint generation; absent one,
        # fall back to the pre-generation (r4) in-place layout so older
        # data_dirs keep loading.
        cur = self._ckpt.current()
        if cur is not None:
            self._ckpt_gen, self._ckpt_dir = cur
        # indices + registries FIRST: legacy metadata/raw ingestion keys
        # on id -> (shard, slot), which the registries supply
        for shard, index in enumerate(self.indices):
            try:
                if index.load(self._index_load_path(shard)):
                    self._maybe_restore_slab(shard, index)
                    ids, slots = self._load_ids(
                        self._index_load_path(shard)
                    )
                    reg = _native.SlotRegistry()
                    reg.put(ids, slots)
                    self.registries[shard] = reg
                    if self._ckpt_dir is None:
                        self._oldlayout_loaded = True
            except ValueError as e:
                if "persisted index dim" in str(e):
                    # A dimension mismatch is a CONFIG error, not corrupt
                    # state: serving an empty store here would hide it.
                    # Refuse to start instead.
                    raise ValueError(
                        f"data_dir {self.data_dir!r} holds a "
                        f"different-dimension index ({e}); pass the "
                        "matching vector_dimension / --dimension / "
                        "WDBX_VECTOR_DIMENSION"
                    ) from e
                logger.warning("failed to load shard %d: %s", shard, e)
                index.clear()
                self.registries[shard] = _native.SlotRegistry()
                if self._ckpt_dir is not None:
                    # a complete generation EXISTS but could not be
                    # served (e.g. raw store lost rows under a slab-
                    # external checkpoint): start empty, but protect
                    # the generation from being GC'd by a later save
                    self._poisoned.add(shard)
            except (OSError, KeyError) as e:
                # Corrupt index state → fresh index, matching the
                # reference's fallback (reference wdbx/core/indexing.py:309-315).
                logger.warning("failed to load shard %d: %s", shard, e)
                index.clear()
                self.registries[shard] = _native.SlotRegistry()
                if self._ckpt_dir is not None:
                    self._poisoned.add(shard)

        def resolve(vid: str):
            shard = self._shard_for(vid)
            slot = self.registries[shard].lookup(vid)
            return None if slot is None else (shard, int(slot))

        legacy_meta_dir = os.path.join(self.data_dir, "metadata")
        if self._ckpt_dir is not None:
            meta_dir = os.path.join(self._ckpt_dir, "metadata")
            loaded = False
            try:
                loaded = self.meta.load(meta_dir)
            except (ValueError, OSError, KeyError) as e:
                logger.warning("failed to load metadata: %s", e)
            # the generation's columnar metadata supersedes any legacy
            # one-blob metadata.json (which save() deletes once
            # ingested); only when the generation carried NO metadata at
            # all does a blob copied in alongside still resume — a stale
            # blob must never overwrite newer columnar rows
            if not loaded:
                blob = os.path.join(legacy_meta_dir, "metadata.json")
                if os.path.exists(blob):
                    try:
                        self.meta.load_legacy(blob, resolve)
                        self._legacy_meta_ingested = True
                    except (ValueError, OSError, KeyError) as e:
                        logger.warning(
                            "failed to load legacy metadata: %s", e
                        )
        else:
            meta_dir = legacy_meta_dir
            try:
                if self.meta.load(meta_dir):
                    self._legacy_meta_ingested = True  # superseded on disk
                    self._oldlayout_loaded = True
                else:
                    # reference-format one-blob fallback (restart-resume
                    # from an older data_dir keeps working)
                    self.meta.load_legacy(
                        os.path.join(meta_dir, "metadata.json"), resolve
                    )
                    self._legacy_meta_ingested = True
            except (ValueError, OSError, KeyError) as e:
                logger.warning("failed to load metadata: %s", e)

        tuned_path = os.path.join(meta_dir, "tuned.json")
        if os.path.exists(tuned_path):
            try:
                with open(tuned_path) as f:
                    ff = json.load(f).get("fetch_factor")
                if ff:
                    self._tuned_fetch_factor = max(1, int(ff))
            except (ValueError, OSError) as e:
                logger.warning("failed to load tuned state: %s", e)

        # legacy dict-format raw vectors -> memmap ingestion
        raw_path = os.path.join(self.data_dir, "vectors", "raw.npz")
        if self.raws.enabled and os.path.exists(raw_path):
            try:
                # allow_pickle stays False (default): object arrays in a
                # tampered file would execute code on load
                data = np.load(raw_path)
                by_shard: dict[int, tuple[list[int], list[int]]] = {}
                rows = np.asarray(data["vectors"], np.float32)
                for i, vid in enumerate(data["ids"]):
                    loc = resolve(str(vid))
                    if loc is not None:
                        slots, srcs = by_shard.setdefault(loc[0], ([], []))
                        slots.append(loc[1])
                        srcs.append(i)
                for shard, (slots, srcs) in by_shard.items():
                    self.raws.write(
                        shard, np.asarray(slots, np.int64), rows[srcs]
                    )
                self._legacy_raw_ingested = True
            except (ValueError, OSError) as e:
                # Unreadable (e.g. a legacy object-id checkpoint): move it
                # aside rather than deleting the only f32 copy.
                logger.warning(
                    "failed to load raw vectors (%s); preserving the file "
                    "as raw.npz.unreadable", e,
                )
                try:
                    os.replace(raw_path, raw_path + ".unreadable")
                except OSError:
                    pass
        self._invalidate_snapshots()

    # -- async twins ------------------------------------------------------
    async def store_async(self, vector_id, vector, metadata=None) -> bool:
        return await asyncio.to_thread(self.store, vector_id, vector, metadata)

    async def batch_store_async(self, vectors, metadata=None) -> int:
        return await asyncio.to_thread(self.batch_store, vectors, metadata)

    async def search_async(
        self, query_vector, limit=10, threshold=0.0, filter_metadata=None
    ) -> list[SearchHit]:
        return await asyncio.to_thread(
            self.search, query_vector, limit, threshold, filter_metadata
        )

    async def search_batch_async(
        self, query_vectors, limit=10, threshold=0.0, filter_metadata=None
    ) -> list[list[SearchHit]]:
        return await asyncio.to_thread(
            self.search_batch, query_vectors, limit, threshold, filter_metadata
        )

    async def get_async(self, vector_id):
        return await asyncio.to_thread(self.get, vector_id)

    async def delete_async(self, vector_id) -> bool:
        return await asyncio.to_thread(self.delete, vector_id)

    async def update_metadata_async(self, vector_id, metadata) -> bool:
        return await asyncio.to_thread(self.update_metadata, vector_id, metadata)

    async def clear_async(self) -> int:
        return await asyncio.to_thread(self.clear)

    async def optimize_async(self, background: bool | None = None) -> bool:
        return await asyncio.to_thread(self.optimize, background)

    async def tune_async(self, target_recall: float = 0.95,
                         sample: int = 64, k: int = 10):
        return await asyncio.to_thread(self.tune, target_recall, sample, k)
