"""Device-sharded flat index: the corpus striped over the positions of a
mesh.

Torch port of ``wdbx_tpu/parallel/sharded_flat.py``. The JAX index runs
a search as one ``shard_map``: every device scores its local slab with
the fused kernel, takes a local top-k, all-gathers the ``(B, k)``
candidates and merges. Here one process drives the mesh: each shard runs
its own stage 1 (``fused_topk_partial``, K1 / K2, on its position's
device; the plain version on the CPU), its local row indices become
global slots on the device, and the partials of all shards go through
ONE stage-2 merge (``topk_merge_partials``), which takes any part count.

Layout: slot ``s`` lives at row ``s // n_dev`` of shard ``s % n_dev``,
held as one ``(rows_per_device, width)`` tensor per mesh position with
its validity and (int8 / int4) scales. Sequential slots round-robin over
the shards, and a slot's shard never changes when capacity grows. With
a replica axis (``make_mesh2``) each replica group holds a copy of every
shard: a query batch splits over the groups and every write reaches
every copy.

Differences from the JAX index, all deliberate: one merge over the
concatenated partials instead of ``all_gather`` + ``top_k``; selection
is exact where JAX's sharded path may take ``approx_max_k``; no
power-of-two padding of batches; slots past the slab are dropped before
a write (JAX's scatter drops them); checkpoints: the npz slot-order
layout of the JAX index (so checkpoints move between device counts and
between the packages), or one file a position with
``persist_backend="orbax"`` (``store/persist.py``).

Global mesh (``make_mesh`` / ``make_mesh2`` in a group of several
ranks): every rank makes the same calls with the same arguments and
holds tensors only for its own positions (``None`` at the others'), so
a method that reaches a remote position fails instead of reading
garbage. The ranks own contiguous, ordered blocks of positions, of equal
size or not (a degraded mesh of 7 on 2 ranks is 4 + 3), or none (a rank
left out of ``make_mesh(3)`` on 4 ranks, or whose positions all failed
their probe): such a rank holds no tensor, runs no stage 1, keeps its
queries and answers on its own device, and joins every collective with
an empty block. Every branch that decides whether a rank takes part in
a collective reads the mesh and the capacity, which every rank shares,
never what the rank holds. Slot routing is host arithmetic, identical
on every rank; a write lands on every copy the writer holds, and is a
no-op on a rank holding none.

A search splits the batch over the replica groups (``_cuts``). For each
group it holds a position of, a rank runs stage 1 on its shards of that
group for the group's slice and merges them to ``(B_g, k')``; ONE
``all_gather`` then carries every rank's slices, and every rank merges,
for each group, the blocks of that group's ranks (``_serve``): JAX's
local top-k, ``all_gather`` and ``top_k``, ``B_g * k' * 8`` bytes a
rank a group. k' is the same on every rank, ``min(k, rows of the most
shards one rank holds of one group)``, from the mesh and the capacity,
with -inf / -1 past a rank's own candidates. A group within one rank
(``make_mesh2(2)`` on 2 ranks of 4) is taken as its rank sent it; a
group spanning ranks (``make_mesh2(2)`` on 4 ranks of 2) merges the
blocks of its ranks.

Host reads of the slab (checkpoints, ``get_vectors``, the validity
behind builds) read the copy of one replica group. Where every rank
holds a whole copy, each reads its lowest whole group alone and nothing
crosses; otherwise (``_spans``: the unreplicated global mesh, groups
spanning ranks, a rank without a position) every rank reads group 0's
copy, the ranks gathering their shards of it, padded to the largest
rank's shard count, as JAX's ``_host_replicated`` does. A build's rows
are read by group 0's owners and travel to every rank holding a copy of
their new shard. Checkpoints: one file a shard (``persist_backend=
"orbax"``), written by the lowest rank holding a copy among those that
share the path (group 0's owners on a shared path), and read by every
rank holding a copy, into each of its copies; or the gathered npz. The
shared files (npz, metadata, sidecars) are written once a path: by rank
0 where the ranks share the path, by every rank where each has its own
(its own data directory, as every JAX process writes its own copy); the
ranks meet at a barrier.

A live remesh moves rows, never a host copy of the slab: each rank reads
the live rows of the old shards it reads for the others, keeps those
whose new shard it holds and sends each other row to every rank holding
a copy of its new shard through ``collective.all_to_all`` (``_CHUNK``
slots at a time, the slot id beside each row). The ranks first agree
that every rank could read its old positions, so a dead device makes
every rank raise together. A remesh between a global mesh and a
single-process one is refused (``ValueError``).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any

import numpy as np
import torch

from wdbx_tpu_torch.index.base import Pending, Plan, VectorIndex
from wdbx_tpu_torch.index.flat import (
    FlatIndex,
    _next_pow2,
    slab_from_numpy,
    slab_to_numpy,
    to_tensor,
)
from wdbx_tpu_torch.kernels.fused_topk import (
    _prep_queries,
    fused_topk_local,
    fused_topk_plain,
    merge_partials,
    merge_partials_plain,
)
from wdbx_tpu_torch.kernels.quant import (
    quantize_rows,
    quantize_rows_int4,
    unpack_int4,
)
from wdbx_tpu_torch.ops.kmeans import kmeans
from wdbx_tpu_torch.ops.normalize import l2_normalize
from wdbx_tpu_torch.parallel import collective
from wdbx_tpu_torch.parallel.mesh import (
    Mesh,
    _canon,
    make_mesh,
    make_mesh2,
)

logger = logging.getLogger("wdbx_tpu_torch.parallel")

#: rows a build gathers, assigns or moves at once
_CHUNK = 131_072


class ShardedFlatIndex(FlatIndex):
    kind = "sharded_flat"
    #: sharded slabs keep their own save path (no slab-external
    #: reconstruction for mesh-striped layouts)
    supports_slab_external = False
    #: packed int4 stays packed on every shard: K2 unpacks per tile
    _INT4_OK = True

    def __init__(
        self,
        dim: int,
        metric: str = "cosine",
        dtype: str = "float32",
        capacity: int = 1024,
        mesh: Mesh | None = None,
        axis: str = "shard",
        replicas: int = 1,
        device: Any = None,
    ):
        if dtype == "int4" and not self._INT4_OK:
            raise ValueError(
                "int4 is supported by 'flat', 'sharded_flat', "
                "'ivf_clustered' and 'sharded_clustered' — the "
                "dense-table IVF's bucket tables have no nibble unpack"
            )
        if mesh is None:
            mesh = (make_mesh2(replicas, axes=("replica", axis), device=device)
                    if replicas > 1 else make_mesh(axis=axis, device=device))
        self.axis = axis
        #: the caller's device: where a rank holding no position keeps
        #: its queries and answers
        self._device_arg = device
        self._set_mesh(mesh)
        super().__init__(dim, metric=metric, dtype=dtype, capacity=capacity,
                         device=self.device)

    # -- topology -----------------------------------------------------------
    def _set_mesh(self, mesh: Mesh) -> None:
        if self.axis not in mesh.axis_names:
            raise ValueError(
                f"new mesh lacks axis {self.axis!r}: {mesh.axis_names}"
            )
        if mesh.axis_names[-1] != self.axis:
            raise ValueError(f"the shard axis {self.axis!r} must be the "
                             f"mesh's last: {mesh.axis_names}")
        n_dev = int(mesh.shape[self.axis])
        self.mesh = mesh
        self.replica_axis = (
            "replica" if "replica" in mesh.axis_names else None
        )
        #: number of corpus shards (slot striping runs over these)
        self.n_devices = n_dev
        self.replicas = mesh.size // self.n_devices
        #: the positions this process holds tensors for, and the replica
        #: groups with one of them
        self._local = frozenset(mesh.local_positions)
        self._groups = mesh.local_groups
        #: this process's row in the tables below (0 outside a global
        #: mesh)
        self._me = mesh.rank if mesh.is_global else 0
        ranks = (np.asarray(mesh.owners) if mesh.is_global
                 else np.zeros(mesh.size, np.int64))
        at = np.arange(mesh.size)
        #: shards of each replica group on each rank, ``(world, replicas)``
        self._group_shards = np.zeros((mesh.world, self.replicas), np.int64)
        np.add.at(self._group_shards, (ranks, at // n_dev), 1)
        #: whether each rank holds a copy of each shard, ``(world, n_dev)``
        self._has = np.zeros((mesh.world, n_dev), bool)
        self._has[ranks, at % n_dev] = True
        whole = self._group_shards == n_dev
        #: whether host reads gather across ranks: some rank (one
        #: without a position, too) holds no whole copy of the corpus.
        #: Reads then take group 0's copy wherever its shards lie;
        #: otherwise each rank reads its lowest whole group alone.
        self._spans = not whole.any(axis=1).all()
        #: the replica group whose copies host reads take
        self._read_group = (0 if self._spans
                            else int(np.argmax(whole[self._me])))
        #: group 0's shards of each rank, in rank order: the blocks host
        #: reads gather where they span ranks
        self._rank_shards = self._group_shards[:, 0]
        #: whether this rank writes a checkpoint's shared files, how many
        #: ranks do, and the ranks sharing its path (``_choose_writer``)
        self._lead, self._writers = mesh.rank == mesh.owners[0], 1
        self._peers = [self._me]
        #: queries, results and merges live on the first own position's
        #: device; a rank holding none keeps them on its own device
        self.device = (mesh.devices[mesh.local_positions[0]]
                       if mesh.local_positions else self._home())

    def _home(self) -> torch.device:
        """The device of a rank that holds no position: the caller's,
        else this process's own device of the mesh's kind (its current
        card on a CUDA mesh; the CPU only on a CPU mesh)."""
        if self._device_arg is not None:
            return _canon(self._device_arg)
        return _canon(self.mesh.devices[0].type)

    # -- sharded storage ------------------------------------------------------
    def _round_cap(self, need: int) -> int:
        per_need = max(128, -(-need // self.n_devices))
        if per_need <= self._CAP_CHUNK:
            per_dev = _next_pow2(per_need)
        else:  # 1M-row-per-device granularity past the pow2 regime
            per_dev = -(-per_need // self._CAP_CHUNK) * self._CAP_CHUNK
        cap = per_dev * self.n_devices
        if cap >= 2**31:  # slots stay int32 through the merge
            raise ValueError(f"capacity {cap} needs slots past int32")
        return cap

    @property
    def rows_per_device(self) -> int:
        return self._cap // self.n_devices

    def _held(self, make) -> list:
        """``make(p, device)`` at each position this process holds, None
        at the others' (the positions of other ranks)."""
        return [make(p, d) if p in self._local else None
                for p, d in enumerate(self.mesh.devices)]

    def _read_pos(self, s: int) -> int:
        """The position of shard ``s``'s copy that host reads take."""
        return self._read_group * self.n_devices + s

    def _own_shards(self) -> list[int]:
        """The shards of the read group this process holds (every shard
        where host reads gather nothing)."""
        return [s for s in range(self.n_devices)
                if self._read_pos(s) in self._local]

    def _first_copy(self, s: int) -> int:
        """This process's lowest position holding shard ``s``."""
        return min(p for p in range(s, self.mesh.size, self.n_devices)
                   if p in self._local)

    def _rank_k(self, k: int) -> int:
        """k' of a rank's merge on a global mesh: the same on every
        rank, from the mesh and the capacity (the most shards one rank
        holds of one group, times their rows)."""
        return min(k, int(self._group_shards.max()) * self.rows_per_device)

    def _merge_own(self, part_v, part_i, k: int, merge):
        """The rank's ``(B, parts, k'')`` partials of one group merged to
        ``(B, k)``; on a global mesh to ``(B, k')`` (``_rank_k``), -inf
        / -1 past the rank's own candidates."""
        if not self.mesh.is_global:
            return merge(part_v, part_i, k)
        kr = self._rank_k(k)
        v, i = merge(part_v, part_i,
                     min(kr, part_v.shape[1] * part_v.shape[2]))
        pad = kr - v.shape[1]
        if pad:
            v = torch.nn.functional.pad(v, (0, pad), value=float("-inf"))
            i = torch.nn.functional.pad(i, (0, pad), value=-1)
        return v, i

    # -- row reads --------------------------------------------------------------
    def _elsize(self) -> int:
        """Bytes of one stored element."""
        return torch.empty((), dtype=self._dtype).element_size()

    def _gather_raw_of(self, slabs, scales, pos, n_dev, positions=None):
        """Stored rows (raw codes) and scales at global positions ``pos``
        of the explicit per-position lists (a snapshot in the background
        build, the old mesh's in a remesh), read from the read group's
        copies (``positions``: shard -> the position to read, where the
        lists are another mesh's), on the index's device in the order of
        ``pos``."""
        pos = np.asarray(pos, np.int64)
        shard, row = pos % n_dev, pos // n_dev
        dev = self.device
        rows = torch.empty((len(pos), self._row_width), dtype=self._dtype,
                           device=dev)
        sc = (torch.empty((len(pos),), dtype=torch.float32, device=dev)
              if self._is_quantized else None)
        for s in np.unique(shard).tolist():
            p = self._read_pos(s) if positions is None else positions[s]
            at = np.nonzero(shard == s)[0]
            r = torch.as_tensor(row[at], device=slabs[p].device)
            at_t = torch.as_tensor(at, device=dev)
            rows[at_t] = slabs[p][r].to(dev)
            if sc is not None:
                sc[at_t] = scales[p][r].to(dev)
        return rows, sc

    def _gather_unit_of(self, slabs, scales, pos, n_dev) -> torch.Tensor:
        """Float32 rows at global positions (dequantized; unit norm for
        cosine)."""
        return self._unit(*self._gather_raw_of(slabs, scales, pos, n_dev))

    def _unit(self, rows, sc) -> torch.Tensor:
        """Stored rows and scales -> float32 rows (unit norm for
        cosine)."""
        if self._is_int4:
            rows = unpack_int4(rows)
        rows = rows.to(torch.float32)
        if sc is not None:
            rows = rows * sc[:, None]
        if self.metric == "cosine":
            rows = rows / torch.clamp_min(
                torch.linalg.norm(rows, dim=-1, keepdim=True), 1e-12
            )
        return rows

    def _owner_of(self, pos: np.ndarray) -> np.ndarray:
        """The rank that reads each global position's shard for the
        others: the owner of its copy in group 0."""
        return np.asarray(self.mesh.owners, np.int64)[
            np.asarray(pos, np.int64) % self.n_devices]

    def _pack(self, rows, sc) -> torch.Tensor:
        """Stored rows (and scales) as one ``(n, bytes)`` uint8 block."""
        out = rows.contiguous().view(torch.uint8)
        if sc is not None:
            out = torch.cat([out, sc[:, None].contiguous().view(torch.uint8)],
                            1)
        return out

    def _unpack(self, buf):
        """Inverse of ``_pack``."""
        wb = self._row_width * self._elsize()
        rows = buf[:, :wb].contiguous().view(self._dtype)
        sc = (buf[:, wb:].contiguous().view(torch.float32)[:, 0]
              if self._is_quantized else None)
        return rows, sc

    def _to_lead(self, slabs, scales, pos, n_dev):
        """Stored rows and scales at global positions ``pos``, read by
        their owners and assembled on rank 0 in the order of ``pos``
        (None on the other ranks)."""
        rank, world = self.mesh.rank, self.mesh.world
        owner = self._owner_of(pos)
        mine = self._pack(*self._gather_raw_of(
            slabs, scales, pos[owner == rank], n_dev))
        got = collective.all_to_all(
            [mine if r == 0 and rank != 0 else mine[:0]
             for r in range(world)])
        if rank != 0:
            return None
        buf = torch.empty((len(pos), mine.shape[1]), dtype=torch.uint8,
                          device=self.device)
        for r in range(world):
            at = torch.as_tensor(np.nonzero(owner == r)[0],
                                 device=self.device)
            buf[at] = mine if r == 0 else got[r]
        return self._unpack(buf)

    # -- a build's steps across ranks -------------------------------------------
    def _train_centroids(self, slabs, scales, sample, nlist) -> torch.Tensor:
        """k-means centroids (float32, on ``self.device``) of the rows at
        global positions ``sample``. On a global mesh rank 0 trains on
        the rows read from their owners and broadcasts: ``index_add_``
        sums with float atomics on CUDA, so centroids trained on each
        rank could differ in the last bits and the ranks would disagree
        on the layout."""
        n_dev = self.n_devices
        if not self.mesh.is_global:
            return kmeans(self._gather_unit_of(slabs, scales, sample, n_dev),
                          num_clusters=nlist, iters=self.kmeans_iters)[0]
        train = self._to_lead(slabs, scales, sample, n_dev)
        if self.mesh.rank == 0:
            centroids, _ = kmeans(self._unit(*train), num_clusters=nlist,
                                  iters=self.kmeans_iters)
        else:
            centroids = torch.empty((nlist, self.dim), dtype=torch.float32,
                                    device=self.device)
        del train
        return collective.broadcast(centroids, 0)

    def _build_rows(self, pos: np.ndarray) -> np.ndarray:
        """The global positions among ``pos`` whose rows this rank reads
        for a build: all of them outside a global mesh, those of the
        shards it reads for the others on one (``_owner_of``)."""
        if not self.mesh.is_global:
            return pos
        return pos[self._owner_of(pos) == self.mesh.rank]

    def _share_by_owner(self, pos: np.ndarray, mine: np.ndarray
                        ) -> np.ndarray:
        """Per-row results of ``_build_rows(pos)`` (``mine``, one entry
        a row) -> those of every position of ``pos``, in its order,
        exchanged between the ranks on a global mesh."""
        if not self.mesh.is_global:
            return mine
        owner = self._owner_of(pos)
        got = collective.all_to_all([torch.from_numpy(mine)]
                                    * self.mesh.world)
        out = np.empty((len(pos),) + mine.shape[1:], mine.dtype)
        for r, block in enumerate(got):
            out[owner == r] = block.numpy()
        return out

    def _move_rows(self, slabs, scales, src, shard, put) -> None:
        """Deliver the stored rows at global positions ``src`` (read from
        the explicit per-position lists) to every rank holding a copy of
        their new shards ``shard``: ``put(at, rows, scales)`` writes the
        rows of entries ``at`` (indices into ``src``) that land on this
        rank. Where host reads span ranks a rank reads only the rows of
        group 0's shards it holds, keeps those bound for its own copies
        and sends each other to every rank holding a copy through the
        all-to-all; otherwise every row is here."""
        n_dev = self.n_devices
        if not self._spans:
            put(np.arange(len(src)), *self._gather_raw_of(slabs, scales, src,
                                                          n_dev))
            return
        rank, world = self._me, self.mesh.world
        owner = self._owner_of(src)
        mine = np.nonzero(owner == rank)[0]
        rows, sc = self._gather_raw_of(slabs, scales, src[mine], n_dev)
        to = self._has[:, np.asarray(shard, np.int64)]  # (world, len(src))

        def pick(m):
            return torch.as_tensor(np.nonzero(m)[0], device=rows.device)

        here = pick(to[rank, mine])
        put(mine[to[rank, mine]], rows[here],
            None if sc is None else sc[here])
        packed = self._pack(rows, sc)
        got = collective.all_to_all([packed[pick(to[r, mine])] if r != rank
                                     else packed[:0] for r in range(world)])
        for r in range(world):
            if r != rank:
                put(np.nonzero((owner == r) & to[rank])[0],
                    *self._unpack(got[r]))

    def _alloc(self, cap: int) -> None:
        self._gen += 1
        rpd = cap // self.n_devices
        self._slabs = self._held(lambda p, d: torch.zeros(
            (rpd, self._row_width), dtype=self._dtype, device=d))
        self._valids = self._held(
            lambda p, d: torch.zeros((rpd,), dtype=torch.bool, device=d))
        self._row_scales = self._held(
            lambda p, d: torch.zeros((rpd,), dtype=torch.float32, device=d)
            if self._is_quantized else None)

    def _grow(self, need: int) -> None:
        new_cap = self._round_cap(max(need, int(self._cap * 1.5)))
        rpd = new_cap // self.n_devices
        self._slabs = [None if t is None else self._grown(t, rpd)
                       for t in self._slabs]
        self._valids = [None if t is None else self._grown(t, rpd)
                        for t in self._valids]
        self._row_scales = [None if t is None else self._grown(t, rpd)
                            for t in self._row_scales]
        self._cap = new_cap
        self._gen += 1

    def _slot_tensor(self, slots) -> torch.Tensor:
        # slots route to their shards on the host
        return torch.as_tensor(np.asarray(slots, np.int64))

    def _route(self, slots: torch.Tensor):
        """``(shard, at, rows)`` for each shard that host ``slots`` touch:
        ``at`` indexes ``slots``, ``rows`` are the shard's local rows.
        Slots outside the slab are dropped, as JAX's scatter drops them."""
        n_dev = self.n_devices
        inside = (slots >= 0) & (slots < self._cap)
        shard = torch.where(inside, slots % n_dev, -1)
        for s in range(n_dev):
            at = (shard == s).nonzero().flatten()
            if at.numel():
                yield s, at, slots[at] // n_dev

    def _copies(self, s: int):
        """Mesh positions holding shard ``s`` (one per replica group)
        that this process holds."""
        return [p for p in range(s, self.mesh.size, self.n_devices)
                if p in self._local]

    def _write_rows(self, slots: torch.Tensor, vecs: torch.Tensor,
                    flag: bool) -> None:
        """Write rows (quantizing once for int8 / int4) into every copy
        of their shards, in place or on clones while ``_cow_writes``."""
        cow = self._cow_writes
        if self._is_quantized:
            quant = quantize_rows_int4 if self._is_int4 else quantize_rows
            q, sc = quant(vecs)
        else:
            q, sc = vecs.to(self._dtype), None
        for s, at, rows in self._route(slots):
            at = at.to(q.device)
            q_s = q[at]
            sc_s = sc[at] if sc is not None else None
            for p in self._copies(s):
                dev = self.mesh.devices[p]
                r = rows.to(dev)
                slab = self._slabs[p].clone() if cow else self._slabs[p]
                valid = self._valids[p].clone() if cow else self._valids[p]
                slab[r] = q_s.to(dev)
                valid[r] = flag
                self._slabs[p], self._valids[p] = slab, valid
                if sc_s is not None:
                    scales = (self._row_scales[p].clone() if cow
                              else self._row_scales[p])
                    scales[r] = sc_s.to(dev)
                    self._row_scales[p] = scales
        self._gen += 1

    def _tombstone(self, slots: torch.Tensor) -> None:
        cow = self._cow_writes
        for s, _, rows in self._route(slots):
            for p in self._copies(s):
                valid = self._valids[p].clone() if cow else self._valids[p]
                valid[rows.to(valid.device)] = False
                self._valids[p] = valid
        self._gen += 1

    def _place(
        self,
        slab_np: np.ndarray,
        valid_np: np.ndarray,
        scales_np: np.ndarray | None = None,
    ) -> None:
        """Slot-order ``(cap, width)`` host arrays -> striped positions."""
        n_dev = self.n_devices
        self._slabs = self._held(lambda p, d: slab_from_numpy(
            slab_np[p % n_dev::n_dev], self._dtype).to(d))
        self._valids = self._held(lambda p, d: torch.from_numpy(np.require(
            valid_np[p % n_dev::n_dev], bool, ["C", "W", "O"])).to(d))
        if self._is_quantized and scales_np is None:
            scales_np = np.zeros(self._cap, np.float32)
        self._row_scales = self._held(
            lambda p, d: torch.from_numpy(np.require(
                scales_np[p % n_dev::n_dev], np.float32,
                ["C", "W", "O"])).to(d)
            if self._is_quantized else None)
        self._gen += 1

    def _install_loaded(self, slab_hwm, valid_np, scales_np) -> None:
        n_dev, rpd = self.n_devices, self.rows_per_device

        def slab_at(p, dev):
            slab = torch.zeros((rpd, self._row_width), dtype=self._dtype,
                               device=dev)
            part = slab_hwm[p % n_dev::n_dev] if slab_hwm is not None else []
            if len(part):
                slab[: len(part)] = slab_from_numpy(part, self._dtype).to(dev)
            return slab

        self._slabs = self._held(slab_at)
        # owned copies: replica positions must not share host storage
        self._valids = self._held(lambda p, d: torch.from_numpy(np.require(
            valid_np[p % n_dev::n_dev], bool, ["C", "W", "O"])).to(d))
        self._row_scales = self._held(
            lambda p, d: torch.from_numpy(np.require(
                scales_np[p % n_dev::n_dev], np.float32,
                ["C", "W", "O"])).to(d)
            if scales_np is not None else None)

    def _is_lead(self) -> bool:
        return self._lead

    def _choose_writer(self, path: str) -> None:
        """Decide which ranks write the shared files of a checkpoint at
        ``path`` (every rank calls this as a save begins): each rank
        whose path no lower rank shares. Rank 0 alone where the ranks
        share the path; every rank where each has its own."""
        if not self.mesh.is_global:
            return
        paths = collective.all_gather_object(os.path.abspath(path))
        mine = paths[self.mesh.rank]
        self._peers = [r for r, p in enumerate(paths) if p == mine]
        self._lead = self._peers[0] == self.mesh.rank
        self._writers = len(set(paths))

    def _save_locked(self, path: str, skip_slab: bool = False) -> None:
        self._choose_writer(path)
        FlatIndex._save_locked(self, path, skip_slab=skip_slab)

    def _barrier(self) -> None:
        if self.mesh.is_global:
            collective.barrier()

    def _split_positions(self) -> bool:
        return self.mesh.is_global

    def _positions_held(self, writing: bool = True
                        ) -> tuple[list[int], int]:
        """One file a shard, of ``n_devices``. A rank reads the file of
        every shard it holds a copy of, and writes each of those that no
        lower rank sharing its path holds (``_choose_writer``): on a
        shared path the owners of group 0's copies write every file
        once; where each rank has its own path, each writes all it will
        read. A rank without a position reads and writes none."""
        held = [s for s in range(self.n_devices) if self._has[self._me, s]]
        if writing:
            lower = [r for r in self._peers if r < self._me]
            held = [s for s in held if not self._has[lower, s].any()]
        return held, self.n_devices

    def _position_arrays(self) -> dict[str, list[torch.Tensor]]:
        at = [self._first_copy(s) for s in self._positions_held()[0]]
        arrays = {"slab": [self._slabs[p] for p in at],
                  "valid": [self._valids[p] for p in at]}
        if self._is_quantized:
            arrays["scales"] = [self._row_scales[p] for p in at]
        return arrays

    def _position_devices(self) -> list[torch.device]:
        return [self.mesh.devices[self._first_copy(s)]
                for s in self._positions_held(writing=False)[0]]

    def _install_positions(self, arrays: dict[str, list]) -> None:
        n_dev, devs = self.n_devices, self.mesh.devices
        read = self._positions_held(writing=False)[0]

        def spread(parts):
            at = dict(zip(read, parts))
            return self._held(
                lambda p, d: at[p % n_dev] if p == self._first_copy(p % n_dev)
                else at[p % n_dev].to(d, copy=True))

        self._slabs = spread(arrays["slab"])
        self._valids = spread(arrays["valid"])
        self._row_scales = (spread(arrays["scales"]) if self._is_quantized
                            else [None] * len(devs))

    def _per_position(self, name: str):
        """The per-position tensors ``name`` (``"slab"``, ``"valid"``,
        ``"scales"``), with the shape and dtype of each."""
        rpd = self.rows_per_device
        return {"slab": (self._slabs, (rpd, self._row_width), self._dtype),
                "valid": (self._valids, (rpd,), torch.bool),
                "scales": (self._row_scales, (rpd,), torch.float32)}[name]

    def _interleave(self, name: str) -> np.ndarray:
        """Slot-order host array of the per-position tensors ``name``
        (checkpoint encoding: bf16 as uint16 bits), read from the read
        group's copies. When those span ranks the ranks gather their
        shards' host copies."""
        n_dev = self.n_devices
        tensors, tail, dtype = self._per_position(name)
        parts = [tensors[self._read_pos(s)].cpu() for s in self._own_shards()]
        if self._spans:
            parts = list(self._shard_stack(parts, tail, dtype))
        host = [slab_to_numpy(t) for t in parts]
        out = np.empty((self._cap,) + host[0].shape[1:], host[0].dtype)
        for s, h in enumerate(host):
            out[s::n_dev] = h
        return out

    def _shard_stack(self, parts: list, tail, dtype, everywhere=True):
        """This rank's host tensors of its read-group shards (each of
        shape ``tail`` and ``dtype``, maybe none) -> every rank's,
        ``(n_devices, *tail)`` in shard order (the blocks lie in rank
        order), on every rank, or on rank 0 only (None elsewhere). The
        stacks cross padded to the largest rank's shard count."""
        counts = self._rank_shards
        mine = torch.zeros((int(counts.max()),) + tuple(tail), dtype=dtype)
        if parts:
            mine[:len(parts)] = torch.stack(parts)
        every = (collective.all_gather(mine) if everywhere
                 else collective.gather(mine))
        if every is None:
            return None
        return torch.cat([every[r, :c] for r, c in enumerate(counts)])

    def _host_slot_view(self):
        """Slot-order host copies of the slab (checkpoint encoding), the
        validity and the scales (None for float slabs)."""
        scales = (self._interleave("scales")
                  if self._is_quantized else None)
        return (self._interleave("slab"), self._interleave("valid"),
                scales)

    def _host_valid_np(self) -> np.ndarray:
        return self._interleave("valid")

    def valid_count(self) -> int:
        mine = sum(int(self._valids[self._read_pos(s)].sum())
                   for s in self._own_shards())
        return collective.all_sum(mine) if self._spans else mine

    def _npz_arrays(self, hwm: int) -> dict[str, np.ndarray]:
        slab, valid, scales = self._host_slot_view()
        arrays = {"slab": slab[:hwm], "valid": valid[:hwm]}
        if scales is not None:
            arrays["scales"] = scales[:hwm]
        return arrays

    # -- sharded search -------------------------------------------------------
    def _masked_valids(self, mask_np) -> list[torch.Tensor]:
        """Per-position validity ANDed with a host filter mask, cached by
        the mask object's identity and the write generation."""
        cache = getattr(self, "_maskdev_cache", None)
        if cache is None:
            cache = self._maskdev_cache = {}
        key = (id(mask_np), self._gen)
        hit = cache.get(key)
        if hit is not None:
            return hit[1]
        full = np.zeros(self._cap, bool)
        n = min(len(mask_np), self._cap)
        full[:n] = mask_np[:n]
        n_dev = self.n_devices
        out = [None if v is None else torch.logical_and(
            v, torch.from_numpy(np.ascontiguousarray(
                full[p % n_dev::n_dev])).to(v.device))
            for p, v in enumerate(self._valids)]
        while len(cache) >= 4:
            cache.pop(next(iter(cache)))
        cache[key] = (mask_np, out)
        return out

    def _group_topk(self, group: int, q: torch.Tensor, k: int, valids,
                    kernels: bool):
        """Sorted scores and int64 slots of queries ``q`` over the shards
        of replica group ``group`` this process holds: each shard's
        stage 1 on its position, local rows -> slots (``row * n_dev +
        shard``, -1 stays -1) on the device, then one merge over their
        partials (``_merge_own``: ``(B, k)``, or ``(B, k')`` on a global
        mesh)."""
        if self.metric == "cosine":
            q = l2_normalize(q)
        part_v, part_i = self._shard_parts(group, q, k, valids, kernels)
        merge = merge_partials if kernels else merge_partials_plain
        return self._merge_own(part_v, part_i, k, merge)

    def _shard_parts(self, group: int, q: torch.Tensor, k: int, valids,
                     kernels: bool):
        """Stage 1 of each shard of replica group ``group`` that this
        process holds, on normalized queries ``q``: ``(B, parts, k')``
        scores and int32 slots on ``self.device``."""
        n_dev = self.n_devices
        k_local = min(k, self.rows_per_device)
        parts_v, parts_i = [], []
        prepped = {}  # the kernel's query type, once a device
        for s in range(n_dev):
            p = group * n_dev + s
            if p not in self._local:
                continue
            slab, sc = self._slabs[p], self._row_scales[p]
            qk = prepped.get(slab.device)
            if qk is None:
                qk = prepped[slab.device] = _prep_queries(
                    slab, q.to(slab.device), sc, False)
            if kernels:
                pv, pi = fused_topk_local(slab, qk, valids[p], k_local,
                                          scales=sc, int4=self._is_int4)
            else:
                v, i = fused_topk_plain(slab, qk, valids[p], k_local,
                                        scales=sc, int4=self._is_int4)
                pv, pi = v[:, None, :], i.to(torch.int32)[:, None, :]
            gi = torch.where(pi >= 0, pi * n_dev + s, -1)
            parts_v.append(pv.to(self.device))
            parts_i.append(gi.to(self.device))
        return torch.cat(parts_v, 1), torch.cat(parts_i, 1)

    def _mesh_search(self, qstack: torch.Tensor, k: int, valids):
        """``(NB, B, min(k, cap))`` device scores and slots of a query
        stack: the batch axis splits over the replica groups, each group
        serves its slice of every batch (``_serve``)."""
        nb, b, d = qstack.shape
        kk = min(k, self._cap)
        kernels = self._resolve_topk() == "fused"

        def run(g, lo, hi):
            q = qstack[:, lo:hi].reshape(-1, d)
            v, i = self._group_topk(g, q, kk, valids, kernels)
            return v.reshape(nb, hi - lo, -1), i.reshape(nb, hi - lo, -1)

        return self._serve(b, kk, run, merge_partials if kernels
                           else merge_partials_plain, lead=(nb,))

    def _cuts(self, b: int) -> list[int]:
        """Batch bounds of the replica groups: group g serves queries
        ``[cuts[g], cuts[g+1])``."""
        r = self.replicas
        return [b * g // r for g in range(r + 1)]

    def _serve(self, b: int, kk: int, run, merge, lead=()):
        """The sorted ``(*lead, b, kk)`` scores and int64 slots of a
        batch whose rows split over the replica groups (``_cuts``):
        ``run(g, lo, hi)`` gives group g's slice, ``(*lead, hi - lo,
        k')``, merged over this process's shards of g (``_merge_own``).

        On a global mesh every rank packs the slices of the groups it
        holds a position of into one int32 block (score bits beside
        slots), padded to the widest rank's; ONE ``all_gather`` carries
        every rank's block, and every rank merges, for each group, the
        blocks of that group's ranks (in rank order; a group within one
        rank is taken as it is). Every rank returns the whole batch. A
        rank holding no rows (a B=1 batch over two groups, a rank
        without a position) joins with an empty block: whether a rank
        takes part never depends on what it holds."""
        cuts = self._cuts(b)
        dev = self.device
        out_v = torch.full(lead + (b, kk), float("-inf"), device=dev)
        out_i = torch.full(lead + (b, kk), -1, dtype=torch.int64, device=dev)
        if not self.mesh.is_global:
            for g in range(self.replicas):
                lo, hi = cuts[g], cuts[g + 1]
                if hi > lo:
                    out_v[..., lo:hi, :], out_i[..., lo:hi, :] = run(g, lo, hi)
            return out_v, out_i
        kr = self._rank_k(kk)
        # rows[r, g]: the rows rank r sends for group g; at: their offset
        rows = (self._group_shards > 0) * np.diff(cuts)[None, :]
        at = np.cumsum(rows, axis=1) - rows
        mine = torch.zeros(lead + (int(rows.sum(axis=1).max()), 2 * kr),
                           dtype=torch.int32, device=dev)
        for g in range(self.replicas):
            lo, hi, o = cuts[g], cuts[g + 1], int(at[self._me, g])
            if rows[self._me, g]:
                v, i = run(g, lo, hi)
                mine[..., o:o + hi - lo, :kr] = v.contiguous().view(
                    torch.int32)
                mine[..., o:o + hi - lo, kr:] = i.to(torch.int32)
        every = collective.all_gather(mine)  # (world, *lead, width, 2k')
        for g in range(self.replicas):
            lo, hi = cuts[g], cuts[g + 1]
            ranks = np.nonzero(rows[:, g])[0]
            if hi == lo:
                continue
            part = torch.stack([every[r][..., at[r, g]:at[r, g] + hi - lo, :]
                                for r in ranks], -2)  # (*lead, n, ranks, 2k')
            v = part[..., :kr].contiguous().view(torch.float32)
            i = part[..., kr:].contiguous()
            if len(ranks) == 1:  # the group lies within one rank: k' = kk
                out_v[..., lo:hi, :], out_i[..., lo:hi, :] = v[..., 0, :], \
                    i[..., 0, :].to(torch.int64)
                continue
            mv, mi = merge(v.reshape(-1, len(ranks), kr),
                           i.reshape(-1, len(ranks), kr), kk)
            out_v[..., lo:hi, :] = mv.reshape(v.shape[:-2] + (kk,))
            out_i[..., lo:hi, :] = mi.reshape(v.shape[:-2] + (kk,))
        return out_v, out_i

    def _enqueue(self, queries, k: int, plan: Plan) -> Pending:
        """The flat route over the mesh (``_mesh_search``), under
        ``plan.mask``."""
        valids = (self._valids if plan.mask is None
                  else self._masked_valids(plan.mask))
        v, i = self._mesh_search(to_tensor(queries, self.device)[None], k,
                                 valids)
        return Pending(v[0], i[0], k, self._finish)

    def _enqueue_stack(self, q: torch.Tensor, k: int, plan: Plan) -> Pending:
        """The flat route's stack: on the card one stage-1 launch a shard
        over all NB*B queries and one merge; k columns."""
        if not plan.exact:
            return super()._enqueue_stack(q, k, plan)
        v, i = self._mesh_search(q, k, self._valids)
        return Pending(v, i, k, self._finish)

    # -- live re-meshing --------------------------------------------------------
    def _check_topology(self, mesh: Mesh) -> None:
        if self.axis not in mesh.axis_names:
            raise ValueError(
                f"new mesh lacks axis {self.axis!r}: {mesh.axis_names}"
            )
        if mesh.is_global != self.mesh.is_global:
            raise ValueError(
                "a remesh moves an index between two meshes spanning the "
                "same ranks, or within one process: not from one to the "
                "other")

    def adopt_mesh(self, mesh: Mesh) -> None:
        """Install a new topology with EMPTY storage (cold re-host): the
        old mesh may be unreachable, so nothing is read from it; the
        caller reloads from a checkpoint (``load`` / ``store.recover``).
        On a global mesh every rank calls it, and each then holds only
        its own positions' empty tensors."""
        self._check_topology(mesh)
        with self._mu.write():
            self._set_mesh(mesh)
            self._cap = self._round_cap(max(self._next_slot, 1024))
            self._alloc(self._cap)
            self._size = 0
            self._free = []
            self._next_slot = 0

    def remesh(self, mesh: Mesh) -> None:
        """Re-host the index on another mesh IN PLACE (a lost device, or
        more devices). Slot ids are mesh-independent, so the store's
        registries survive; slot ``s`` moves from ``(s % n_old, s //
        n_old)`` to ``(s % n_new, s // n_new)``. Each rank reads the live
        rows of the old shards it holds and keeps or sends each to the
        rank of its new shard (``_move_to_mesh``). Reads every old
        position held here: a dead device makes this raise, on every
        rank of a global mesh together (``WDBX.heal`` then cold
        re-hosts). ``last_remesh`` reports the seconds, and the rows and
        bytes this rank sent to other ranks."""
        self._check_topology(mesh)
        with self._mu.write():
            t0 = time.perf_counter()
            self._check_readable()
            old_ndev = self.n_devices
            old = (self._slabs, self._valids, self._row_scales, old_ndev,
                   {s: self._read_pos(s) for s in self._own_shards()},
                   self._spans)
            hwm = self._next_slot
            self._set_mesh(mesh)
            self._cap = self._round_cap(max(hwm, 1024))
            self._alloc(self._cap)
            rows, sent = self._move_to_mesh(old, hwm)
            self._free = [s for s in self._free if s < self._cap]
            self.last_remesh = {
                "seconds": time.perf_counter() - t0, "from": old_ndev,
                "to": self.n_devices, "rows_sent": rows, "bytes_sent": sent}
            logger.info(
                "remeshed %d -> %d shards (cap %d, %d live rows)",
                old_ndev, self.n_devices, self._cap, self._size,
            )

    def _check_readable(self) -> None:
        """Read every position held here (a dead device raises); on a
        global mesh the ranks then agree, so all raise or none does."""
        err = None
        try:
            for p in sorted(self._local):
                float(self._valids[p][:1].sum())
        except Exception as e:  # a lost device raises what CUDA raises
            err = f"{type(e).__name__}: {e}"
        errs = (collective.all_gather_object(err) if self.mesh.is_global
                else [err])
        bad = {r: e for r, e in enumerate(errs) if e is not None}
        if bad:
            raise RuntimeError(f"remesh: ranks cannot read their "
                               f"positions: {bad}")

    def _move_to_mesh(self, old, hwm: int) -> tuple[int, int]:
        """Write the live rows of the old per-position lists ``old``
        (slabs, validity, scales, shard count, the old shards this rank
        reads -> their positions, whether those spanned ranks) below
        ``hwm`` into every copy of their new shards held here, ``_CHUNK``
        slots at a time. Where the old shards spanned ranks, the rows
        bound for another rank cross in one ``all_to_all`` a chunk, each
        with its slot id; otherwise every rank holds every row. Returns
        the rows and bytes this rank sent."""
        slabs, valids, scales, old_n, held, spans = old
        n_new, rank, has = self.n_devices, self._me, self._has
        world = self.mesh.world if spans else 1
        rows_sent = bytes_sent = 0
        for lo in range(0, hwm, _CHUNK):
            hi = min(hwm, lo + _CHUNK)
            slots = []
            for s, p in held.items():
                r_lo, r_hi = -(-(lo - s) // old_n), -(-(hi - s) // old_n)
                live = torch.nonzero(valids[p][r_lo:r_hi]).flatten().cpu()
                slots.append((live.numpy() + r_lo) * old_n + s)
            slots = np.concatenate(slots) if slots else np.empty(0, np.int64)
            raw, sc = self._gather_raw_of(slabs, scales, slots, old_n,
                                          positions=held)
            new_shard = slots % n_new
            mine = has[rank, new_shard]
            at = torch.as_tensor(np.nonzero(mine)[0], device=raw.device)
            self._put_rows(self._slabs, self._valids, self._row_scales,
                           slots[mine], raw[at], None if sc is None
                           else sc[at])
            if world == 1:
                continue
            packed = torch.cat([self._pack(raw, sc), torch.from_numpy(
                slots).to(raw.device)[:, None].view(torch.uint8)], 1)
            blocks = []
            for r in range(world):
                m = has[r, new_shard] if r != rank else np.zeros(
                    len(slots), bool)
                blocks.append(packed[torch.as_tensor(np.nonzero(m)[0],
                                                     device=raw.device)])
                if r != rank:
                    rows_sent += int(m.sum())
                    bytes_sent += int(m.sum()) * packed.shape[1]
            for r, got in enumerate(collective.all_to_all(blocks)):
                if r != rank and len(got):
                    self._put_rows(
                        self._slabs, self._valids, self._row_scales,
                        got[:, -8:].contiguous().view(torch.int64)[:, 0]
                        .cpu().numpy(), *self._unpack(got[:, :-8]))
        return rows_sent, bytes_sent

    def _put_rows(self, slabs_n, valids_n, scales_n, dst, rows, sc):
        """Write stored rows (and scales) at global positions ``dst`` of
        the per-position tensors ``slabs_n`` / ``valids_n`` /
        ``scales_n`` (this mesh's), into every copy held here, marked
        live."""
        n_dev = self.n_devices
        dshard, drow = dst % n_dev, dst // n_dev
        for s in np.unique(dshard).tolist():
            at = torch.as_tensor(np.nonzero(dshard == s)[0],
                                 device=rows.device)
            r_np = drow[dshard == s]
            for p in self._copies(s):
                dev = self.mesh.devices[p]
                r = torch.as_tensor(r_np, device=dev)
                slabs_n[p][r] = rows[at].to(dev)
                valids_n[p][r] = True
                if sc is not None:
                    scales_n[p][r] = sc[at].to(dev)

    def get_vectors(self, slots: np.ndarray) -> np.ndarray:
        slots = np.asarray(slots, np.int64)
        if len(slots) and (slots.min() < 0 or slots.max() >= self._cap):
            raise IndexError(f"slots outside the slab of {self._cap}")
        out = np.zeros((len(slots), self.dim), np.float32)
        with self._mu.read():
            for s, at, rows in self._route(torch.as_tensor(slots)):
                p = self._read_pos(s)
                if p not in self._local:
                    continue
                r = rows.to(self._slabs[p].device)
                got = self._slabs[p][r]
                if self._is_int4:
                    got = unpack_int4(got)
                got = got.to(torch.float32)
                if self._is_quantized:
                    got = got * self._row_scales[p][r][:, None]
                out[at.numpy()] = got.cpu().numpy()
        if self._spans:
            # every rank filled its own shards' rows: take each row from
            # the rank owning its shard
            every = collective.all_gather(torch.from_numpy(out)).numpy()
            owner = np.asarray(self.mesh.owners)[slots % self.n_devices]
            out = every[owner, np.arange(len(slots))]
        return out

    def get_stats(self) -> dict:
        stats = VectorIndex.get_stats(self)
        stats.update(
            dtype=self.dtype_name,
            tombstones=len(self._free),
            hbm_bytes=sum(t.numel() * t.element_size()
                          for t in self._slabs if t is not None),
            device=str(self.device),
            devices=self.n_devices,
            mesh_axis=self.axis,
            replicas=self.replicas,
            rows_per_device=self.rows_per_device,
            positions=list(self.mesh.names),
        )
        return stats
