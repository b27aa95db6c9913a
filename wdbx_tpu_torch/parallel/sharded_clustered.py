"""Mesh-sharded cluster-ordered IVF: the bucket layout striped over the
shards of a mesh.

Torch port of ``wdbx_tpu/parallel/sharded_clustered.py``. The layout is
the JAX engine's: every bucket's rows stripe round-robin over the shards
(row r of bucket b lives on shard ``r % n_dev`` at that shard's next
local position in its copy of b), so each shard holds about 1/n of every
bucket, contiguously, in a locally cluster-ordered slab with its own
extents. Global positions are ``ShardedFlatIndex``'s striped ones
(``pos = local_row * n_dev + shard``): the sharded writes, tombstones and
slot-order checkpoints work unchanged, and fresh rows allocated past the
uniform local boundary land round-robin over the shards.

A search takes the probe top-k once against the replicated centroids.
Then, per shard on its position: ``_dedup_blocks`` over the shard's
LOCAL extents, stage 1 of the clustered block scan (K3, or K4 with
``kernel_version="v1"``; ``kernels/clustered_scan.py``, the plain
version on CPU tensors) on the shard's slab, local rows mapped to global
positions on the device, and the shard's fresh (residual) rows scored as
one more part. ONE stage-2 merge (``merge_partials``) joins every
shard's partials, as ``ShardedFlatIndex`` joins its K1 / K2 partials.
Small batches take the exact-bucket-range scan per shard (each shard
takes its probes itself there), and ``ivf_kernel="lax"`` the portable
block scan, each with the same one merge. Replica groups split the
query batch.

The disjointness invariant of the single-device engine carries over in
global position space (freed positions quarantine until the next build,
updates move the row, fresh rows start above the block-aligned local
boundary), so no scan path masks rows by bucket.

Differences from the JAX engine, all deliberate: one merge over every
shard's partials instead of a local top-k per device, an ``all_gather``
and a global top-k (the same sets except at ties); query batches are not
padded (``pad_b``, rounded up to the replica count, still picks the
route and sizes the dedup); residual lists are sliced to their live
entries (no pad positions one past the slab); the portable scan selects
exactly (``torch.topk`` for ``approx_max_k``); no compiled-program cache
(``_cluster_cache``): the per-position extents are tensors on each
position's device. The on-disk format (the slot-order ``ShardedFlatIndex``
checkpoint with ``.ivfsc.npz`` + ``.ivfsc.json`` beside it) is the JAX
package's, so checkpoints move between the packages and between shard
counts.

Global mesh (``ShardedFlatIndex``'s module docstring): a build reads
the training sample's rows from their owners onto rank 0, which trains
and broadcasts the centroids (``index_add_`` sums with float atomics on
CUDA, so centroids trained on each rank could differ in the last bits
and the ranks would disagree on the layout); each rank assigns the rows
it holds and the ranks all-gather the assignments, so the striped
layout is computed alike everywhere; then the rows move to their new
(shard, row) ``_CHUNK`` at a time, each to every rank holding a copy
of its new shard (``collective.all_to_all``). A search runs K3 and the
fresh rows on the rank's shards of each replica group it holds a
position of, merges them, and the ranks' ``(B_g, k')`` cross in one
``all_gather`` and merge once more for each group
(``ShardedFlatIndex._serve``); the probe top-k and the block dedup stay
per rank, on identical inputs. Where every rank holds whole copies
(``make_mesh2(2)`` on 2 ranks), rank 0 still trains (and assigns,
reading its own copy) and broadcasts, and no row moves between ranks.

``build_background`` on a global mesh: every rank calls it in a thread
of its own while its foreground goes on calling the index. The rows of
the new layout cross on the background group (``collective``), whose
lock is not the foreground's. The snapshot and the swap touch the
index's state, so they fall at the same foreground call on every rank:
each foreground call (search, write, tombstone) passes a gate that
counts it; the background threads agree on the call of the snapshot,
which the foreground takes at that gate; from then on each gate starts
with one all-gather of every rank's step-(2) flag, and at the first
where every flag is set every rank swaps (or takes the blocking build,
or releases the window where a rank failed) before the call. The cost:
one small all-gather a foreground call while a window is open. A
remesh, clear or load in the window first waits for the background
step to end, then abandons the snapshot, at the same call on every
rank.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import threading
import time

import numpy as np
import torch

from wdbx_tpu_torch.index.clustered import (
    ClusteredSlotMixin,
    _assign_blocked,
    _block_rows,
    _clustered_search_ranges,
    _dedup_blocks,
)
from wdbx_tpu_torch.index.base import Pending, Plan, VectorIndex
from wdbx_tpu_torch.index.flat import _next_pow2, to_tensor
from wdbx_tpu_torch.index.ivf import (
    IVFIndex,
    _probes,
    _residual_merge,
    _scores_of,
)
from wdbx_tpu_torch.kernels.clustered_scan import (
    clustered_block_partial,
    clustered_block_topk_plain,
)
from wdbx_tpu_torch.kernels.fused_topk import merge_partials
from wdbx_tpu_torch.kernels.quant import prep_query_block, unpack_int4
from wdbx_tpu_torch.ops.normalize import l2_normalize
from wdbx_tpu_torch.parallel import collective
from wdbx_tpu_torch.parallel.sharded_flat import _CHUNK, ShardedFlatIndex

logger = logging.getLogger("wdbx_tpu_torch.parallel")


#: a rank's background build, as its flag in the agreement all-gather:
#: step (2) running, done, done but the striping overflows (the blocking
#: build), failed
_RUNNING, _READY, _OVERFLOW, _FAILED = 0, 1, 2, 3


class _Window:
    """One background build's window on a global mesh: the call its
    snapshot falls before, the snapshot, this rank's step (2) and its
    outcome."""

    def __init__(self):
        self.open_at: int | None = None
        self.snap: dict | None = None
        self.layout = None
        self.flag = _RUNNING
        self.error: BaseException | None = None
        self.outcome: str | None = None
        self.agreements = 0
        self.t_open = 0.0
        self.phase2_s = 0.0
        self.opened = threading.Event()
        self.phase2_done = threading.Event()
        self.closed = threading.Event()


def _gated(method):
    """A foreground call of the index: on a global mesh the outermost
    call of a thread passes the gate (``_fg_gate``) first."""

    @functools.wraps(method)
    def call(self, *args, **kwargs):
        tl = self._fg_tl
        if not self.mesh.is_global or getattr(tl, "inside", False):
            return method(self, *args, **kwargs)
        tl.inside = True
        try:
            self._fg_gate()
            return method(self, *args, **kwargs)
        finally:
            tl.inside = False

    return call


def _striped_layout(assign, nlist, n_dev):
    """Pure-numpy striped cluster layout: rows of bucket b, in stable
    order, go to shard (rank % n_dev) at local rank (rank // n_dev); a
    shard's local layout is bucket-contiguous over its subset. Returns
    ``(order, dest, local_counts, local_starts)``."""
    n_live = len(assign)
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    counts = np.bincount(assign, minlength=nlist)
    starts = np.zeros(nlist + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rank_in_bucket = np.arange(n_live) - starts[sorted_assign]
    dev = (rank_in_bucket % n_dev).astype(np.int64)
    local_rank = rank_in_bucket // n_dev
    # per-(shard, bucket) counts and local starts
    local_counts = np.zeros((n_dev, nlist), np.int64)
    np.add.at(local_counts, (dev, sorted_assign), 1)
    local_starts = np.zeros((n_dev, nlist + 1), np.int64)
    np.cumsum(local_counts, axis=1, out=local_starts[:, 1:])
    local_row = local_starts[dev, sorted_assign] + local_rank
    dest = (local_row * n_dev + dev).astype(np.int64)  # global striped
    return order, dest, local_counts, local_starts


class ShardedClusteredIndex(ClusteredSlotMixin, IVFIndex, ShardedFlatIndex):
    """Cluster-ordered IVF striped over a mesh (see the module docstring).

    MRO as the JAX class: IVF triggers and tuners above
    ``ShardedFlatIndex``'s per-position storage. Memory a shard: its
    1/n of the corpus plus ~9 bytes a row of host bookkeeping."""

    kind = "sharded_clustered"
    #: K3 unpacks int4 nibbles per tile: the capacity tier scales over
    #: the mesh here
    _INT4_OK = True

    def __init__(self, dim, metric="cosine", dtype="float32",
                 capacity=1024, mesh=None, axis="shard", nlist=128,
                 nprobe=8, train_threshold=4096, rebuild_fraction=0.2,
                 kmeans_iters=15, train_sample=262_144, replicas=1,
                 device=None):
        ShardedFlatIndex.__init__(
            self, dim, metric=metric, dtype=dtype, capacity=capacity,
            mesh=mesh, axis=axis, replicas=replicas, device=device,
        )
        self.nlist = nlist
        self.nprobe = nprobe
        self.assignments = 1
        self.train_threshold = train_threshold
        self.rebuild_fraction = rebuild_fraction
        self.kmeans_iters = kmeans_iters
        self.train_sample = train_sample
        self.batch_flat_fallback = True
        self.topk_method = "auto"
        self.block_bytes_target = 786_432
        #: "auto" (K3 on the CUDA device, the portable scan elsewhere),
        #: "pallas" (the kernel path; its plain version on the CPU) or
        #: "lax" (the portable scan)
        self.ivf_kernel = "auto"
        #: batches at or below this may take the exact-bucket-range scan
        self.small_batch_threshold = 4
        self.latency_path = "auto"
        #: optimize() uses build_background() (serving keeps the old
        #: layout during the rebuild); IVF_BACKGROUND_REBUILD. Needs
        #: room for a second slab on the device.
        self.background_rebuild = False
        self._filter_boosts: dict[int, int] = {}
        self._reset_overlay()
        # the foreground gate of a global mesh (``_fg_gate``)
        self._gate = threading.Condition()
        self._fg_calls = 0
        self._fg_freeze = False
        self._bg_win: _Window | None = None
        self._fg_tl = threading.local()

    # -- overlay state --------------------------------------------------------
    def _reset_overlay(self) -> None:
        self._centroids = None  # (nlist, d) float32 on self.device
        self._centroids_np = None
        self._centroids_at: dict = {}  # device -> centroids there
        # per-position (nlist,) int64 extents on each position's device
        self._blk_lo = None
        self._blk_hi = None
        self._row_lo = None
        self._row_cnt = None
        self._range_L = 1
        self._local_counts: np.ndarray | None = None  # (n_dev, nlist)
        self._local_starts: np.ndarray | None = None  # (n_dev, nlist+1)
        self._m = 1
        self._c = 1
        self._u_prefix: np.ndarray | None = None
        self._nonempty = 0
        self._avg_blocks = 1.0
        self._residual: list[int] = []  # GLOBAL striped positions
        self._residual_base = 0
        self._built_size = 0
        # bucket -> quarantined positions in that bucket's extent (-1:
        # bucket unknown; see ClusteredSlotMixin)
        self._quar: dict[int, list[int]] = {}
        self._quar_n = 0
        self._fresh_base = 0  # positions >= this are residual-region
        self._slot_of = np.full(self._cap, -1, np.int32)
        self._pos_of = np.full(self._cap, -1, np.int32)
        self._free_slots: list[int] = []
        self._next_ext_slot = 0

    def _grow(self, need: int) -> None:
        super()._grow(need)
        self._check_blocks()

    def _check_blocks(self) -> None:
        """K3 takes a shard's slab only in whole c-row blocks."""
        if self.is_trained and self.rows_per_device % self._c:
            raise RuntimeError(
                f"{self.rows_per_device} rows a shard are not whole "
                f"{self._c}-row blocks"
            )

    # foreground calls: the gate of a global mesh first
    add_batch = _gated(ClusteredSlotMixin.add_batch)
    update_slots = _gated(ClusteredSlotMixin.update_slots)
    remove_slots = _gated(ClusteredSlotMixin.remove_slots)

    def clear(self) -> None:
        with self._mu.write():
            self._bg_quiesce()
            ShardedFlatIndex.clear(self)
            self._reset_overlay()
            # storage replaced wholesale: abandon any in-flight
            # background build's snapshot at swap time
            self._invalidate_bg_window()

    def _invalidate_bg_window(self) -> None:
        """Kill any in-flight background rebuild (write lock held).
        Bumping the layout generation makes that rebuild abandon its
        snapshot at swap time; the copy-on-write window is released here
        so that a caller's blocking ``build()`` right after (``remesh``)
        is not skipped by ``_build_locked``'s in-flight guard."""
        self._layout_gen = getattr(self, "_layout_gen", 0) + 1
        self._cow_writes = False
        self._bg_journal = {}

    def compact(self):
        """A rebuild is the compaction; external slots are stable, so
        the returned remap is the identity."""
        with self._mu.write():
            self._build_locked()
            live = np.nonzero(self._slot_of >= 0)[0]
            slots = np.sort(self._slot_of[live].astype(np.int64))
            return slots, slots

    # -- build ----------------------------------------------------------------
    def build_from(self, chunks_factory, *, train_chunks: int = 1):
        """Chunked bulk load, then one build (the signature of
        ``ClusteredIVFIndex.build_from``). Each chunk lands once through
        the striped writes (device tensors stay on the device) and
        ``build()`` permutes into stripes at the end; ``train_chunks`` is
        accepted and ignored (training samples ``train_sample`` rows of
        the loaded slab). Returns ``(n_total,)`` slot ids in source
        order."""
        if self._size:
            raise ValueError("build_from requires an empty index")
        slots = [np.empty(0, np.int64)]
        for rows in chunks_factory():
            slots.append(np.asarray(self.add_batch(rows), np.int64))
        self.build()
        return np.concatenate(slots)

    def build(self) -> None:
        with self._mu.write():
            self._build_locked()

    def _build_locked(self) -> None:
        if self._cow_writes:
            # a background rebuild is in flight and swaps in shortly: a
            # blocking build here would clobber its snapshot
            return
        hwm = self._next_slot
        if self._size == 0 or hwm == 0:
            self._reset_overlay()
            return
        n_dev = self.n_devices
        live_pos = np.nonzero(self._host_valid_np()[:hwm])[0].astype(np.int64)
        centroids, assign = self._plan_clusters(
            self._slabs, self._row_scales, live_pos, n_dev
        )
        order, dest, local_counts, local_starts = _striped_layout(
            assign, len(centroids), n_dev
        )
        # round-robin striping can hand the low shards one extra row a
        # bucket, past rows_per_device at high occupancy: grow first
        # (striped global positions survive a grow)
        need_local = int(local_starts[:, -1].max()) if len(live_pos) else 0
        if need_local > self.rows_per_device:
            self._grow(need_local * n_dev)
        src_global = live_pos[order]
        slabs_n, valids_n, scales_n = self._permute_striped(
            self._slabs, self._row_scales, src_global, dest, self._cap, n_dev
        )
        self._install_striped(
            src_global, dest, local_counts, local_starts, centroids,
            slabs_n, valids_n, scales_n,
        )

    def _plan_clusters(self, slabs, scales, live_pos, n_dev):
        """Train centroids and assign every live row, reading only the
        explicit per-position lists (so the background build runs it off
        the lock against a snapshot). Returns ``(centroids, assign)``
        numpy."""
        n_live = len(live_pos)
        nlist = min(self.nlist, n_live)
        sample = live_pos
        if n_live > self.train_sample:
            sel = np.random.default_rng(0).choice(
                n_live, self.train_sample, replace=False
            )
            sample = live_pos[np.sort(sel)]
        centroids = self._train_centroids(slabs, scales, sample, nlist)
        mine = self._build_rows(live_pos)
        assign = np.empty(len(mine), np.int32)
        for i in range(0, len(mine), _CHUNK):
            rows = self._gather_unit_of(slabs, scales, mine[i:i + _CHUNK],
                                        n_dev)
            assign[i:i + _CHUNK] = _assign_blocked(rows, centroids)
            del rows
        return (centroids.cpu().numpy(),
                self._share_by_owner(live_pos, assign))

    def _permute_striped(self, slabs, scales, src_global, dest, cap, n_dev):
        """Move the live rows of the explicit (snapshot-safe) source
        lists into fresh per-position tensors at ``cap``, in striped
        cluster order, ``_CHUNK`` rows at a time. Device peak: old slabs
        + new slabs + one chunk. On a global mesh a rank reads the rows
        it holds, keeps those bound for its own shards and sends the
        rest to their ranks."""
        rpd = cap // n_dev
        slabs_n = self._held(lambda p, d: torch.zeros(
            (rpd, self._row_width), dtype=self._dtype, device=d))
        valids_n = self._held(
            lambda p, d: torch.zeros((rpd,), dtype=torch.bool, device=d))
        scales_n = self._held(
            lambda p, d: torch.zeros((rpd,), dtype=torch.float32, device=d)
            if self._is_quantized else None)
        for i in range(0, len(src_global), _CHUNK):
            dst = dest[i:i + _CHUNK]
            self._move_rows(
                slabs, scales, src_global[i:i + _CHUNK], dst % n_dev,
                lambda at, rows, sc, dst=dst: self._put_rows(
                    slabs_n, valids_n, scales_n, dst[at], rows, sc))
        return slabs_n, valids_n, scales_n

    def _install_striped(
        self, src_global, dest, local_counts, local_starts, centroids,
        slabs_n, valids_n, scales_n, slot_src=None, prebuilt=None,
    ) -> None:
        """Swap the permuted tensors in and rebuild the maps and overlay
        (write lock held). ``slot_src`` labels the destination rows
        instead of the live ``_slot_of``; ``prebuilt`` = (slot_of,
        pos_of) computed off the lock by ``_prepare_bg_swap``."""
        n_dev = self.n_devices
        self._slabs, self._valids, self._row_scales = (
            slabs_n, valids_n, scales_n)
        self._gen += 1
        if prebuilt is not None:
            self._slot_of, self._pos_of = prebuilt
        else:
            slot_at_dest = (
                self._slot_of if slot_src is None else slot_src
            )[src_global]
            self._slot_of[:] = -1
            self._slot_of[dest] = slot_at_dest
            self._pos_of[:] = -1
            keep = slot_at_dest >= 0
            self._pos_of[slot_at_dest[keep]] = dest[keep].astype(np.int32)
        self._install_layout(np.asarray(centroids), local_counts)
        self._free = []
        self._quar = {}
        self._quar_n = 0
        # uniform local boundary: the largest local clustered end, rounded
        # up to a block
        max_local = int(local_starts[:, -1].max()) if len(src_global) else 0
        boundary = -(-max_local // self._c) * self._c
        self._next_slot = min(self._cap, boundary * n_dev)
        self._fresh_base = self._next_slot
        self._residual = []
        self._residual_base = 0
        self._built_size = self._size

    def build_background(self) -> None:
        """Rebuild the striped layout without blocking searches: (1) a
        brief write lock snapshots the per-position tensors and turns the
        mutators to copy-on-write; (2) off the lock, train / assign /
        permute the snapshot into fresh tensors while searches and
        mutations go on; (3) a brief write lock drops the journaled rows
        from the new layout, swaps it in and replays the mutated slots
        into the fresh region.

        Falls back to the blocking build at swap time when the capacity
        or the shard count changed in the window, or when the striping
        would overflow rows_per_device (growth cannot happen off the
        lock). A ``remesh`` / ``clear`` / ``load`` in the window bumps
        ``_layout_gen`` and the snapshot is abandoned. Device peak: two
        slabs (+ a clone per copy-on-write mutation batch).

        On a global mesh every rank calls it (in a thread of its own,
        beside a foreground that keeps calling the index), and steps (1)
        and (3) fall at the same foreground call on every rank
        (``_build_background_global``); it returns once the swap has
        happened."""
        if self.mesh.is_global:
            self._build_background_global()
            return
        with self._mu.write():
            if self._cow_writes:
                return  # already rebuilding
            snap = self._bg_snapshot()
            if snap is None:
                return
        try:
            layout = self._bg_layout(snap)
            merged = staged = prep = None
            if layout is not None:
                # drain the window's journal off the lock and pre-build
                # the post-swap slot maps: the swap pays only the delta
                merged, staged = self._prestage_bg_journal(
                    lambda p: ShardedFlatIndex.get_vectors(self, p),
                    snap["gen"],
                )
                prep = self._prepare_bg_swap(
                    snap["slot_of"], layout[0], layout[1], merged,
                    snap["cap"])
        except Exception:
            # a concurrent remesh / clear / load can break the off-lock
            # gather or permute: that failure belongs to a dead
            # generation, abandoned quietly. A same-generation failure is
            # real: release this window (only this one) and raise.
            with self._mu.write():
                stale = getattr(self, "_layout_gen", 0) != snap["gen"]
                if not stale:
                    self._cow_writes = False
            if stale:
                return
            raise
        with self._mu.write():
            self._bg_install(snap, layout, merged, staged, prep)

    def _bg_snapshot(self) -> dict | None:
        """Step (1) under the write lock: the snapshot, and the mutators
        turned to copy-on-write (None, with the overlay reset, on an
        empty index)."""
        hwm = self._next_slot
        if self._size == 0 or hwm == 0:
            self._reset_overlay()
            return None
        self._cow_writes = True
        self._bg_journal: dict[int, str] = {}
        # list copies: copy-on-write replaces list entries, never the
        # snapshot's tensors
        return {"slabs": list(self._slabs), "scales": list(self._row_scales),
                "valid": self._host_valid_np()[:hwm],
                "slot_of": self._slot_of.copy(), "cap": self._cap,
                "gen": getattr(self, "_layout_gen", 0),
                "n_dev": self.n_devices}

    def _bg_layout(self, snap: dict):
        """Step (2), off the lock: the snapshot's new striped layout,
        ``(src_global, dest, local_counts, local_starts, centroids,
        slabs_n, valids_n, scales_n)``, or None when the striping would
        overflow rows_per_device."""
        n_dev = snap["n_dev"]
        live_pos = np.nonzero(snap["valid"])[0].astype(np.int64)
        centroids, assign = self._plan_clusters(
            snap["slabs"], snap["scales"], live_pos, n_dev
        )
        order, dest, local_counts, local_starts = _striped_layout(
            assign, len(centroids), n_dev
        )
        src_global = live_pos[order]
        need_local = int(local_starts[:, -1].max()) if len(live_pos) else 0
        if need_local > snap["cap"] // n_dev:
            return None  # growth cannot happen off the lock
        new = self._permute_striped(snap["slabs"], snap["scales"],
                                    src_global, dest, snap["cap"], n_dev)
        return (src_global, dest, local_counts, local_starts, centroids,
                *new)

    def _bg_install(self, snap, layout, merged, staged, prep) -> None:
        """Step (3) under the write lock: abandon the snapshot (storage
        replaced in the window), the blocking build (the capacity or
        shard count changed, or the striping overflowed: ``layout`` is
        None), or the swap of the new layout with the journaled slots
        dropped and replayed. ``merged`` / ``staged`` / ``prep``: the
        off-lock journal drain and slot maps (``prep`` None: build them
        here from the whole journal)."""
        try:
            if getattr(self, "_layout_gen", 0) != snap["gen"]:
                return  # storage replaced in the window: abandon
            n_dev = snap["n_dev"]
            if (self._cap != snap["cap"] or layout is None
                    or self.n_devices != n_dev):
                self._cow_writes = False
                self._build_locked()
                return
            (src_global, dest, local_counts, local_starts, centroids,
             slabs_n, valids_n, scales_n) = layout
            delta = self._bg_journal
            self._bg_journal = {}
            if prep is None:
                merged = {}
                prep = self._prepare_bg_swap(snap["slot_of"], src_global,
                                             dest, delta, snap["cap"])
            merged.update(delta)
            new_slot_of, new_pos_of, pre_dead = prep
            dirty, rows = self._bg_dirty_rows(
                merged, lambda p: ShardedFlatIndex.get_vectors(self, p),
                staged=staged, refetch=delta,
            )
            extra_dead = self._bg_delta_fixup(delta, new_slot_of, new_pos_of)
            dead_dest = (np.concatenate([pre_dead, extra_dead])
                         if len(extra_dead) else pre_dead)
            if len(dead_dest):
                dshard, drow = dead_dest % n_dev, dead_dest // n_dev
                for p, v in enumerate(valids_n):
                    r = drow[dshard == p % n_dev]
                    if v is not None and len(r):
                        v[torch.as_tensor(r, device=v.device)] = False
            self._cow_writes = False
            self._install_striped(
                src_global, dest, local_counts, local_starts, centroids,
                slabs_n, valids_n, scales_n,
                prebuilt=(new_slot_of, new_pos_of),
            )
            if rows is not None and len(dirty):
                self._replay_bg_dirty(dirty, rows)
        finally:
            # release only this window: on the abandon path the
            # invalidation already closed it, and a new build may own the
            # flag by now
            if getattr(self, "_layout_gen", 0) == snap["gen"]:
                self._cow_writes = False

    # -- the background build across ranks -------------------------------
    # A foreground call of the index (search, write, tombstone) passes the
    # gate (``_gated``): a rank counts its calls there. The steps of a
    # background build that touch the index's state fall at gates, so at
    # the same call on every rank: the snapshot at the call the ranks'
    # background threads agree on, the swap at the first call where every
    # rank's step (2) is done, which every gate of the window asks with
    # one small all-gather. Step (2) runs in the background thread on the
    # background group (``collective.using``).

    def _fg_gate(self) -> None:
        """The gate of one foreground call on a global mesh: wait while
        a background build agrees on its snapshot's call, count the
        call, then take the snapshot or ask whether to swap."""
        with self._gate:
            while self._fg_freeze:
                self._gate.wait()
            call = self._fg_calls
            self._fg_calls += 1
            win = self._bg_win
        if win is None:
            return
        if call == win.open_at:
            self._bg_open(win, call)
        elif win.snap is not None:
            self._bg_agree(win, call)

    def _build_background_global(self) -> None:
        group = collective.background_group()
        if group is None:
            raise RuntimeError(
                "build_background on a mesh spanning ranks needs the "
                "background group (ShardEngine.join opens it on every "
                "rank)")
        win = _Window()
        with self._gate:
            if self._bg_win is not None:
                return  # already rebuilding
            # no call starts here until the ranks agree on the snapshot's
            # call
            self._fg_freeze = True
            self._bg_win = win
            mine = self._fg_calls
        calls = None
        try:
            with collective.using(group):
                calls = collective.all_gather(torch.tensor([mine]))
        finally:
            with self._gate:
                if calls is None:
                    self._bg_win = None
                else:
                    win.open_at = int(calls.max())
                self._fg_freeze = False
                self._gate.notify_all()
        win.opened.wait()
        if win.snap is None:  # an empty index: nothing to rebuild
            return
        t0 = time.perf_counter()
        try:
            with collective.using(group):
                win.layout = self._bg_layout(win.snap)
            win.flag = _READY if win.layout is not None else _OVERFLOW
        except Exception as e:
            win.error = e
            win.flag = _FAILED
        finally:
            win.phase2_s = time.perf_counter() - t0
            win.phase2_done.set()
        win.closed.wait()
        if win.outcome == "failed":
            if win.error is not None:
                raise win.error
            raise RuntimeError("build_background failed on another rank")

    def _bg_open(self, win: "_Window", call: int) -> None:
        """Step (1) at the agreed call, in the foreground."""
        with self._mu.write():
            snap = self._bg_snapshot()
        win.snap = snap
        win.t_open = time.perf_counter()
        if snap is None:
            self._bg_close(win, "empty", call)
        win.opened.set()

    def _bg_agree(self, win: "_Window", call: int) -> None:
        """At each foreground call of the window: the ranks' step (2)
        states in one all-gather; when every rank is done, every rank
        swaps here, takes the blocking build (a striping overflow), or,
        where a rank failed, releases the window."""
        flags = collective.all_gather(
            torch.tensor([win.flag], dtype=torch.int64)).flatten().tolist()
        win.agreements += 1
        if min(flags) == _RUNNING:
            return
        with self._mu.write():
            if max(flags) == _FAILED:
                outcome = "failed"
                if getattr(self, "_layout_gen", 0) == win.snap["gen"]:
                    self._cow_writes = False
            else:
                outcome = ("swap" if max(flags) == _READY
                           else "blocking build")
                self._bg_install(win.snap, win.layout, None, None, None)
        win.layout = None
        self._bg_close(win, outcome, call)

    def _bg_close(self, win: "_Window", outcome: str, call: int) -> None:
        win.outcome = outcome
        self.last_background = {
            "outcome": outcome, "open_call": win.open_at,
            "swap_call": call, "agreements": win.agreements,
            "window_s": (time.perf_counter() - win.t_open
                         if win.t_open else 0.0),
            "phase2_s": win.phase2_s,
        }
        with self._gate:
            if self._bg_win is win:
                self._bg_win = None
        win.closed.set()

    def _bg_quiesce(self) -> None:
        """Before a remesh / clear / load replaces storage (write lock
        held): on a global mesh, wait until an open window's step (2)
        has ended on this rank (it ends on every rank: it needs only the
        other ranks' background threads), then close the window, which
        the caller's invalidation abandons on every rank alike."""
        win = self._bg_win if self.mesh.is_global else None
        if win is not None and win.snap is not None:
            win.phase2_done.wait()
            win.layout = None
            self._bg_close(win, "abandoned", self._fg_calls)

    def _install_layout(
        self, centroids: np.ndarray, local_counts: np.ndarray,
        c: int | None = None,
    ) -> None:
        """Centroids and per-shard extents from ``(n_dev, nlist)`` local
        bucket counts. ``c`` must be the build-time block size when
        restoring persisted state (a recomputed one could move the fresh
        boundary inside a scanned block)."""
        n_dev, nlist = local_counts.shape
        rpd = self.rows_per_device
        if c is None:
            # row bytes of the STORAGE width (int4 packs two dims a byte)
            c = _block_rows(
                self._row_width, self._elsize(), rpd,
                target=self.block_bytes_target,
            )
        self._c = c
        local_starts = np.zeros((n_dev, nlist + 1), np.int64)
        np.cumsum(local_counts, axis=1, out=local_starts[:, 1:])
        blk_lo = local_starts[:, :-1] // c
        blk_hi = -(-local_starts[:, 1:] // c)
        blk_n = blk_hi - blk_lo
        nonempty = local_counts > 0
        self._m = _next_pow2(
            max(1, int(blk_n[nonempty].max()) if nonempty.any() else 1)
        )
        self._nonempty = int(nonempty.any(axis=0).sum())
        self._avg_blocks = (
            float(blk_n[nonempty].mean()) if nonempty.any() else 1.0
        )
        # worst-case prefix over the per-bucket largest block counts
        per_bucket_max = blk_n.max(axis=0)
        self._u_prefix = np.cumsum(
            np.sort(per_bucket_max[per_bucket_max > 0])[::-1]
        )
        self._local_counts = local_counts
        self._local_starts = local_starts
        self._centroids = torch.from_numpy(
            np.array(centroids, np.float32)).to(self.device)
        self._centroids_np = np.asarray(centroids, np.float32)
        self._centroids_at = {self.device: self._centroids}

        def per_position(table):
            return self._held(
                lambda p, d: torch.as_tensor(table[p % n_dev], device=d))

        self._blk_lo = per_position(blk_lo)
        self._blk_hi = per_position(blk_hi)
        # exact per-(shard, bucket) row ranges for the ranges scan; L is
        # its static slice length (the largest local bucket, + a 512-row
        # margin: slice starts round down to a 512 boundary)
        self._row_lo = per_position(local_starts[:, :-1])
        self._row_cnt = per_position(local_counts)
        maxc = int(local_counts.max()) if local_counts.size else 1
        self._range_L = int(
            max(1, min(rpd, -(-max(1, maxc) // 512) * 512 + 512))
        )
        self._check_blocks()

    def _bucket_of_pos(self, pos: np.ndarray) -> np.ndarray:
        """Bucket whose local extent covers each clustered-region
        position (shard ``pos % n_dev``, local row ``pos // n_dev``); -1
        when the layout is unknown."""
        pos = np.asarray(pos, np.int64)
        starts = self._local_starts
        if starts is None:
            return np.full(len(pos), -1, np.int64)
        dev, row = pos % self.n_devices, pos // self.n_devices
        out = np.full(len(pos), -1, np.int64)
        for d in np.unique(dev):
            m = dev == d
            out[m] = np.searchsorted(starts[d], row[m], side="right") - 1
        return out

    # -- query ----------------------------------------------------------------
    def _scan_rows(self) -> int:
        return self.rows_per_device

    def _residual_rows(self) -> list[np.ndarray]:
        """Each shard's fresh rows, as local rows (the live entries)."""
        n_dev = self.n_devices
        res = np.asarray(self._residual, np.int64)
        return [res[res % n_dev == s] // n_dev for s in range(n_dev)]

    def _use_ranges(self, pad_b: int, nprobe: int) -> bool:
        """The exact-bucket-range scan for small batches whose probes'
        read (each slice is the static max-bucket length L) stays within
        8 MB a shard."""
        lp = getattr(self, "latency_path", "auto")
        if lp in ("narrow", "wide") or self._row_lo is None:
            return False
        if lp == "ranges":
            return True
        nlist = int(self._local_counts.shape[1])
        bytes_per_row = self._row_width * self._elsize()
        read = self._range_L * min(nprobe, nlist)
        return (
            pad_b <= self.small_batch_threshold
            and read * bytes_per_row <= 1 << 23
        )

    def _route_of(self, pad_b: int, nprobe: int, k: int) -> str:
        """The path a batch of (JAX) width ``pad_b`` takes."""
        if self._use_ranges(pad_b, nprobe):
            return "ranges"
        return "kernel" if self._use_kernel(k) else "lax"

    def _centroids_on(self, dev) -> torch.Tensor:
        cent = self._centroids_at.get(dev)
        if cent is None:
            cent = self._centroids_at[dev] = self._centroids.to(dev)
        return cent

    def _qprec(self) -> str:
        """The query type of the kernel path (v1 takes bf16 queries)."""
        if self._kernel_gen() == "v1":
            return "bf16"
        return getattr(self, "kernel_qprec", "bf16")

    def _shard_blocks(self, p: int, probe: torch.Tensor, u: int,
                      pad_g: int, valid: torch.Tensor):
        """Position ``p``'s deduplicated block list ``(uniq, ok)`` for
        the probes of its group's queries: ``_dedup_blocks`` over the
        shard's local extents, ``u`` bounded as a batch of (JAX) width
        ``pad_g`` bounds it."""
        u = min(u, pad_g * probe.shape[1] * self._m)
        return _dedup_blocks(
            probe, self._blk_lo[p], self._blk_hi[p],
            self.rows_per_device // self._c, u, self._m, valid=valid,
            c=self._c,
        )

    def _residual_part(self, p, res, q, valid, k_part):
        """Scores and local rows of position ``p``'s fresh rows ``res``
        for queries ``q``, as ``(B, parts, k_part)`` partials (-inf / -1
        in the padding and on dead rows)."""
        slab, scales = self._slabs[p], self._row_scales[p]
        rows = slab[res]
        if self._is_int4:
            rows = unpack_int4(rows)
        s = _scores_of(rows, q, self._precision, self._is_quantized)
        if self._is_quantized:
            s = s * scales[res][None, :]
        live = valid[res]
        s = torch.where(live[None, :], s, float("-inf"))
        idx = torch.where(live, res, -1)[None, :].expand_as(s)
        pad = -s.shape[1] % k_part
        s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
        b = s.shape[0]
        return s.reshape(b, -1, k_part), idx.reshape(b, -1, k_part)

    def _shard_partials(self, p, route, q, probe, k, nprobe, u, pad_g, valid,
                        res, qk):
        """``(B, parts, k')`` scores and LOCAL rows of position ``p``:
        its block scan (or ranges scan) and its fresh rows. ``qk`` holds
        the kernel's prepared queries of this device."""
        slab, scales = self._slabs[p], self._row_scales[p]
        quant = self._is_quantized
        common = dict(precision=self._precision, int8=self._is_int8,
                      int4=self._is_int4)
        if route == "ranges":
            v, i = _clustered_search_ranges(
                slab, valid, scales, self._centroids_on(slab.device),
                self._row_lo[p], self._row_cnt[p], res, q, k=k,
                nprobe=nprobe, L=self._range_L, normalize=False, **common,
            )
            return [(v[:, None], i[:, None])]
        uniq, ok = self._shard_blocks(p, probe, u, pad_g, valid)
        sc = scales if quant else None
        if route == "lax":
            v, i = clustered_block_topk_plain(
                slab, valid, sc, uniq, ok, q, k, self._c, int4=self._is_int4,
            )
            v, i = _residual_merge(slab, valid, res, scales, v, i, q, k=k,
                                   **common)
            return [(v[:, None], i[:, None])]
        k_part = min(k, self.rows_per_device)
        if slab.is_cuda:
            qq, qs = qk
            pv, pi = clustered_block_partial(
                slab, valid, sc, uniq, ok, qq, qs, k_part, self._c,
                int4=self._is_int4, gen=self._kernel_gen(),
            )
        else:
            v, i = clustered_block_topk_plain(
                slab, valid, sc, uniq, ok, q, k_part, self._c,
                int4=self._is_int4, qprec=self._qprec(),
            )
            pv, pi = v[:, None], i[:, None]
        parts = [(pv, pi)]
        if res.numel():
            parts.append(self._residual_part(p, res, q, valid, k_part))
        return parts

    def _group_topk_clustered(self, g, q, probe, k, nprobe, route, u, pad_g,
                              valids, res_rows):
        """Sorted scores and global positions of queries ``q``
        (normalized) over the shards of replica group ``g`` this process
        holds: every shard's partials on its position, local rows ->
        global positions (``row * n_dev + shard``, -1 stays -1) on the
        device, one merge (``_merge_own``: ``(B, k)``, or ``(B, k')`` on
        a global mesh, which ``_serve`` gathers and merges)."""
        n_dev = self.n_devices
        on_dev = {}  # the queries (and the kernel's prep) once a device
        parts_v, parts_i = [], []
        for s in range(n_dev):
            p = g * n_dev + s
            if p not in self._local:
                continue
            slab = self._slabs[p]
            dev = slab.device
            if dev not in on_dev:
                qd = q.to(dev)
                qk = None
                if route == "kernel" and slab.is_cuda:
                    qq, qs, _ = prep_query_block(
                        qd, slab.dtype, self._is_quantized, self._qprec())
                    qk = (qq, qs)
                on_dev[dev] = (qd, None if probe is None else probe.to(dev),
                               qk)
            qd, probe_d, qk = on_dev[dev]
            res = torch.as_tensor(res_rows[s], device=dev)
            for pv, pi in self._shard_partials(p, route, qd, probe_d, k,
                                               nprobe, u, pad_g, valids[p],
                                               res, qk):
                gi = torch.where(pi >= 0, pi * n_dev + s, -1)
                parts_v.append(pv.to(self.device))
                parts_i.append(gi.to(torch.int32).to(self.device))
        part_v, part_i = torch.cat(parts_v, 1), torch.cat(parts_i, 1)
        return self._merge_own(part_v, part_i, min(k, self._cap),
                               merge_partials)

    def _query(self, q, k, nprobe, pad_b, valids):
        """One batch ``q`` (B, d) through the route of a batch of (JAX)
        width ``pad_b``: device ``(B, min(k, cap))`` scores and int64
        global positions."""
        if self.metric == "cosine":
            q = l2_normalize(q)
        route = self._route_of(pad_b, nprobe, k)
        probe = u = None
        if route != "ranges":
            probe = _probes(q, self._centroids, nprobe, self._precision)
            u = self._scan_u(pad_b, nprobe)
        res_rows = self._residual_rows()
        pad_g = pad_b // self.replicas
        args = (k, nprobe, route, u, pad_g, valids, res_rows)
        return self._serve(q.shape[0], min(k, self._cap), lambda g, lo, hi:
                           self._group_topk_clustered(
                               g, q[lo:hi], None if probe is None
                               else probe[lo:hi], *args), merge_partials)

    def _pad_b(self, b: int, stack: bool = False) -> int:
        """JAX's batch width: the next power of two, rounded up to a
        multiple of the replica count (routing and the dedup length
        only; the queries are not padded)."""
        pad_b = _next_pow2(max(b, 1))
        return -(-pad_b // self.replicas) * self.replicas

    def _scan_reads(self, plan: Plan) -> int:
        return (self._scan_u(plan.pad_b, plan.nprobe) * self._c
                * self.n_devices)

    def _enqueue(self, queries, k: int, plan: Plan) -> Pending:
        if plan.exact:
            return super()._enqueue(queries, k, plan)
        # filter pushdown: the position mask, striped like the slab,
        # ANDs into each position's validity; the block scan and the
        # residual rows then drop filtered rows on the device
        valids = (self._valids if plan.mask is None
                  else self._masked_valids(plan.mask))
        q = to_tensor(queries, self.device, torch.float32)
        v, i = self._query(q, k, plan.nprobe, plan.pad_b, valids)
        return Pending(v, i, k, self._finish)

    search = _gated(VectorIndex.search)
    search_pipelined = _gated(VectorIndex.search_pipelined)

    def get_vectors(self, slots: np.ndarray) -> np.ndarray:
        return ShardedFlatIndex.get_vectors(self, self._positions_of(slots))

    # -- topology -------------------------------------------------------------
    def adopt_mesh(self, mesh) -> None:
        """Cold re-host: empty storage on the new topology (the caller
        reloads from a checkpoint); the cluster overlay resets with it."""
        with self._mu.write():
            self._bg_quiesce()
        ShardedFlatIndex.adopt_mesh(self, mesh)
        with self._mu.write():
            self._reset_overlay()
            self._invalidate_bg_window()

    def remesh(self, mesh) -> None:
        """Re-stripe onto a new mesh and rebuild the cluster layout there
        (the extents are per shard, so the topology invalidates them)."""
        was_trained = self.is_trained
        with self._mu.write():
            self._bg_quiesce()
        ShardedFlatIndex.remesh(self, mesh)
        with self._mu.write():
            # re-striping breaks an in-flight background build's position
            # math: abandon its snapshot and release the window, so the
            # build() below runs
            self._invalidate_bg_window()
            # global positions survive; only the overlay and the mapping
            # arrays' length change
            slot_of, pos_of = self._slot_of, self._pos_of
            resid, quar = self._residual, self._quar_flat()
            free_s, next_ext = self._free_slots, self._next_ext_slot
            self._reset_overlay()
            n = min(len(slot_of), self._cap)
            self._slot_of[:n] = slot_of[:n]
            self._pos_of[:n] = pos_of[:n]
            self._residual = [p for p in resid if p < self._cap]
            # the per-shard extents are stale on the new topology: the
            # holes land under bucket -1 (counted, never recycled) until
            # the build below clears them
            self._quarantine_positions(np.asarray(
                [p for p in quar if p < self._cap], np.int64
            ))
            self._free_slots = free_s
            self._next_ext_slot = next_ext
        if was_trained and self._size:
            self.build()

    # -- persistence ----------------------------------------------------------
    def save(self, path: str) -> None:
        with self._mu.read():
            # the slot-order npz, or one file a position (orbax)
            ShardedFlatIndex._save_locked(self, path)
            hwm = self._next_slot
            arrays = dict(
                slot_of=self._slot_of[:hwm],
                residual=np.asarray(self._residual, np.int64),
            )
            if self.is_trained:
                arrays["centroids"] = self._centroids_np
                arrays["local_counts"] = self._local_counts
            if self._is_lead():
                np.savez(path + ".ivfsc.npz", **arrays)
                with open(path + ".ivfsc.json", "w") as f:
                    json.dump(self._sidecar_meta(), f)
            self._barrier()

    def _sidecar_meta(self) -> dict:
        return {
            "nlist": self.nlist,
            "nprobe": self.nprobe,
            "trained": self.is_trained,
            "built_size": self._built_size,
            "residual_base": self._residual_base,
            "next_ext_slot": self._next_ext_slot,
            "free_slots": self._free_slots,
            "pos_quarantine": self._quar_flat(),
            "next_slot": self._next_slot,
            "block_rows": self._c,
            "fresh_base": self._fresh_base,
        }

    def load(self, path: str) -> bool:
        with self._mu.write():
            self._bg_quiesce()
            if not ShardedFlatIndex._load_locked(self, path):
                return False
            self._invalidate_bg_window()
            self._reset_overlay()
            if not os.path.exists(path + ".ivfsc.json"):
                return self._adopt_foreign_checkpoint(path)
            with open(path + ".ivfsc.json") as f:
                meta = json.load(f)
            with np.load(path + ".ivfsc.npz") as data:
                arrays = {key: data[key] for key in data.files}
            self._restore_sidecar(arrays, meta,
                                  getattr(self, "_loaded_valid_np", None))
            return True

    def _restore_sidecar(self, arrays: dict, meta: dict,
                         live: np.ndarray | None) -> None:
        """Install the clustered state of a ``.ivfsc`` sidecar (arrays
        ``slot_of``, ``residual`` and, when trained, ``centroids`` and
        ``local_counts``) over the sharded flat
        state already in place. ``live`` is the slot-order host validity
        of ``[0, next_slot)``. A layout from another shard count is
        rebuilt here."""
        self.nlist = meta["nlist"]
        self.nprobe = meta["nprobe"]
        self._built_size = int(meta.get("built_size", 0))
        self._residual_base = int(meta.get("residual_base", 0))
        self._next_ext_slot = int(meta.get("next_ext_slot", 0))
        self._free_slots = [int(s) for s in meta.get("free_slots", [])]
        self._next_slot = int(meta.get("next_slot", self._next_slot))
        # legacy default: the high-water mark (quarantine conservatively)
        self._fresh_base = int(meta.get("fresh_base", self._next_slot))
        hwm = min(len(arrays["slot_of"]), self._cap)
        slot_of = np.asarray(arrays["slot_of"], np.int32)[:hwm]
        if live is None or len(live) < hwm:
            live = self._host_valid_np()[:hwm]
        # drop labels on dead rows (moved-from labels of older
        # checkpoints)
        slot_of = np.where(live[:hwm], slot_of, -1)
        self._slot_of[:hwm] = slot_of
        keep = slot_of >= 0
        self._pos_of[slot_of[keep]] = np.arange(hwm, dtype=np.int32)[keep]
        self._residual = [int(p) for p in arrays["residual"]]
        rebuilt = False
        if meta.get("trained") and "centroids" in arrays:
            local_counts = np.asarray(arrays["local_counts"], np.int64)
            c = int(meta.get("block_rows", 0)) or None
            if local_counts.shape[0] != self.n_devices or (
                    c and self.rows_per_device % c):
                # another shard count (or block geometry): the base
                # loader re-striped the rows, and the persisted extents
                # mean nothing here
                logger.info(
                    "checkpoint built on %d shards, mesh has %d: "
                    "rebuilding the cluster layout",
                    local_counts.shape[0], self.n_devices,
                )
                self._build_locked()
                rebuilt = True
            else:
                self._install_layout(np.asarray(arrays["centroids"]),
                                     local_counts, c=c)
        # after the layout install, so the holes re-key to their buckets;
        # a rebuild repacked the rows and made them meaningless
        if not rebuilt:
            self._quarantine_positions(np.asarray(
                [int(p) for p in meta.get("pos_quarantine", [])
                 if int(p) < self._cap], np.int64,
            ))
        self._gen += 1

    def get_stats(self) -> dict:
        stats = ShardedFlatIndex.get_stats(self)
        stats.update(
            nlist=self.nlist,
            nprobe=self.nprobe,
            trained=self.is_trained,
            residual=len(self._residual),
            layout="sharded_clustered",
            tombstones=len(self._free) + self._quar_len(),
        )
        return stats
