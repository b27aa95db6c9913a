"""The port's ShardedClusteredIndex (wdbx_tpu_torch.parallel.sharded_clustered)
on 8 logical CPU shards.

The 27 cases of ``tests/test_sharded_clustered.py`` run on the port with
``device="cpu"`` (``WDBX_TORCH_MESH_SIZE=8``, the port's counterpart of
the JAX suite's 8 faked CPU devices). Where the JAX case drives the
Pallas kernel in interpret mode, the port's kernel path
(``ivf_kernel="pallas"``) runs K3 / K4's plain version, as every kernel
wrapper does on a CPU tensor. Parity with the JAX engine is in
``tests/test_torch_sharded_clustered_parity.py``.
"""

import os

import numpy as np
import pytest
import torch

from wdbx_tpu_torch.index import create_index
from wdbx_tpu_torch.parallel import ShardedClusteredIndex, make_mesh
from wdbx_tpu_torch.parallel.mesh import MESH_SIZE_ENV

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def eight_shards(monkeypatch):
    monkeypatch.setenv(MESH_SIZE_ENV, "8")


def _normed(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _make(dim=32, **kw):
    kw.setdefault("nlist", 16)
    kw.setdefault("nprobe", 16)
    kw.setdefault("train_threshold", 256)
    idx = ShardedClusteredIndex(dim, device="cpu", **kw)
    idx.batch_flat_fallback = False
    return idx


def _cpu_mesh(n):
    return make_mesh(n, device="cpu")


class TestShardedClustered:
    def test_full_probe_matches_exact(self, rng):
        d, n = 32, 3000
        db = _normed(rng, n, d)
        idx = _make(d)
        slots = idx.add_batch(db)
        idx.build()
        assert idx.is_trained and idx.n_devices == 8
        q = _normed(rng, 8, d)
        _, got = idx.search(q, 10)
        exact = slots[np.argsort(-(q @ db.T), axis=-1)[:, :10]]
        recall = np.mean(
            [len(set(a.tolist()) & set(b.tolist())) / 10
             for a, b in zip(got, exact)]
        )
        assert recall >= 0.99, recall
        _, selfq = idx.search(db[:8], 1)
        assert (selfq.ravel() == slots[:8]).all()

    def test_build_from_streaming(self, rng):
        d, n_chunks, rows = 32, 5, 400

        def chunks():
            r = np.random.default_rng(11)
            for _ in range(n_chunks):
                yield r.standard_normal((rows, d)).astype(np.float32)

        idx = _make(d)
        slots = idx.build_from(chunks, train_chunks=2)
        n = n_chunks * rows
        assert len(slots) == n and idx.count() == n and idx.is_trained
        with pytest.raises(ValueError):
            idx.build_from(chunks)
        all_rows = np.concatenate(list(chunks()))
        all_rows /= np.linalg.norm(all_rows, axis=-1, keepdims=True)
        q = _normed(rng, 4, d)
        _, got = idx.search(q, 10)
        inv = np.empty(n, np.int64)
        inv[slots] = np.arange(n)
        got_src = np.where(got >= 0, inv[np.clip(got, 0, n - 1)], -1)
        exp = np.argsort(-(q @ all_rows.T), axis=-1)[:, :10]
        recall = np.mean(
            [len(set(a.tolist()) & set(b.tolist())) / 10
             for a, b in zip(got_src, exp)]
        )
        assert recall >= 0.99, recall

    def test_load_balanced_striping(self, rng):
        """Every shard holds ~1/n of every nonempty bucket."""
        idx = _make(32, nlist=8)
        idx.add_batch(_normed(rng, 2048, 32))
        idx.build()
        counts = idx._local_counts  # (n_dev, nlist)
        spread = counts.max(axis=0) - counts.min(axis=0)
        assert (spread[counts.sum(axis=0) > 0] <= 1).all()

    def test_mutations(self, rng):
        d = 32
        idx = _make(d)
        db = _normed(rng, 2000, d)
        slots = idx.add_batch(db)
        idx.build()
        idx.remove_slots(slots[:50])
        _, gd = idx.search(db[:50], 1)
        dead = set(slots[:50].tolist())
        assert not any(int(g) in dead for g in gd.ravel() if g >= 0)
        fresh = _normed(rng, 20, d)
        fs = idx.add_batch(fresh)
        _, gf = idx.search(fresh, 1)
        assert (gf.ravel() == fs).all()
        # fresh rows surface exactly once (disjointness invariant)
        _, g10 = idx.search(fresh, 10)
        for row in g10:
            ids = [int(g) for g in row if g >= 0]
            assert len(ids) == len(set(ids)), row

    def test_update_moves_row(self, rng):
        d = 32
        idx = _make(d)
        db = _normed(rng, 1500, d)
        slots = idx.add_batch(db)
        idx.build()
        target = _normed(rng, 1, d)
        idx.update_slots(slots[7:8], target)
        _, got = idx.search(target, 10)
        assert int(got.ravel()[0]) == int(slots[7])
        ids = [int(g) for g in got.ravel() if g >= 0]
        assert len(ids) == len(set(ids))

    def test_rebuild_slot_stability(self, rng):
        d = 32
        idx = _make(d)
        db = _normed(rng, 1500, d)
        idx.add_batch(db)
        idx.build()
        fresh = _normed(rng, 30, d)
        idx.add_batch(fresh)
        _, pre = idx.search(fresh, 3)
        idx.build()
        _, post = idx.search(fresh, 3)
        assert (pre == post).all()

    def test_pipelined_matches_search(self, rng):
        d = 32
        idx = _make(d)
        idx.add_batch(_normed(rng, 2000, d))
        idx.build()
        qs = rng.standard_normal((2, 4, d)).astype(np.float32)
        sp, gp = idx.search_pipelined(qs, 5)
        assert sp.shape == (2, 4, 5)
        for i in range(2):
            _, gi = idx.search(qs[i], 5)
            assert (gp[i] == gi).all()

    def test_inflight_pipelined_matches_blocking(self, rng):
        """materialize=False handles resolve to the blocking output
        (slots mapped at resolve time), trained and untrained."""
        d = 32
        idx = _make(d)
        idx.add_batch(_normed(rng, 2000, d))
        idx.build()
        qs = rng.standard_normal((2, 4, d)).astype(np.float32)
        want = idx.search_pipelined(qs, 5)
        handles = [
            idx.search_pipelined(qs, 5, materialize=False)
            for _ in range(2)
        ]
        for h in handles:
            ss, gg = idx.resolve_pipelined(h)
            assert (gg == want[1]).all() and (ss == want[0]).all()
        cold = _make(d, train_threshold=10_000)
        cold.add_batch(_normed(rng, 64, d))
        want_c = cold.search_pipelined(qs, 3)
        got_c = cold.resolve_pipelined(
            cold.search_pipelined(qs, 3, materialize=False)
        )
        assert (got_c[1] == want_c[1]).all()

    def test_int4_capacity_tier(self, rng, temp_dir):
        """int4 on the mesh: packed (rpd, d/2) uint8 slabs a position,
        K3 unpacks per tile; CRUD, recall, persistence and remesh behave
        like int8 with coarser codes."""
        d, n, k = 64, 3000, 10
        db = _normed(rng, n, d)
        q = _normed(rng, 8, d)
        idx = _make(d, dtype="int4")
        slots = idx.add_batch(db)
        idx.build()
        assert all(s.shape[-1] == d // 2 for s in idx._slabs)
        assert all(s.dtype == torch.uint8 for s in idx._slabs)
        _, got = idx.search(db[:8], 1)
        assert (got.ravel() == slots[:8]).all()
        exact = np.argsort(-(q @ db.T), axis=-1)[:, :k]
        _, gk = idx.search(q, k)
        recall = np.mean([
            len(set(int(x) for x in a) & set(slots[b_].tolist())) / k
            for a, b_ in zip(gk, exact)
        ])
        assert recall >= 0.25, recall
        back = idx.get_vectors(slots[:5])
        cos = np.mean(np.sum(back * db[:5], axis=1)
                      / np.linalg.norm(back, axis=1))
        assert cos > 0.98, cos
        idx.remove_slots(slots[:4])
        fresh = _normed(rng, 4, d)
        fslots = idx.add_batch(fresh)
        _, gf = idx.search(fresh, 1)
        assert (gf.ravel() == fslots).all()
        qs = q.reshape(2, 4, d)
        want = idx.search_pipelined(qs, 5)
        got_h = idx.resolve_pipelined(
            idx.search_pipelined(qs, 5, materialize=False)
        )
        assert (got_h[1] == want[1]).all()
        path = os.path.join(temp_dir, "si4")
        idx.save(path)
        idx2 = _make(d, dtype="int4")
        assert idx2.load(path)
        _, g2 = idx2.search(fresh, 1)
        assert (g2.ravel() == fslots).all()
        idx.remesh(_cpu_mesh(4))
        _, g3 = idx.search(fresh, 1)
        assert (g3.ravel() == fslots).all()

    def test_sharded_flat_int4(self, rng):
        """Packed int4 on the flat mesh scan: self-queries and slot
        bookkeeping behave like int8 with coarser codes."""
        from wdbx_tpu_torch.parallel import ShardedFlatIndex

        d = 64
        idx = ShardedFlatIndex(d, dtype="int4", capacity=1024, device="cpu")
        db = _normed(rng, 300, d)
        slots = idx.add_batch(db)
        assert idx._slabs[0].shape[-1] == d // 2
        assert idx._slabs[0].dtype == torch.uint8
        _, got = idx.search(db[:8], 1)
        assert (got.ravel() == slots[:8]).all()
        idx.remove_slots(slots[:2])
        _, g2 = idx.search(db[:2], 1)
        assert slots[0] not in g2 and slots[1] not in g2
        qs = db[:8].reshape(2, 4, d)
        _, gp = idx.search_pipelined(qs, 1)
        assert (gp.reshape(-1)[2:] == slots[2:8]).all()

    def test_sharded_ivf_rejects_int4(self):
        from wdbx_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

        with pytest.raises(ValueError, match="int4"):
            ShardedIVFIndex(32, dtype="int4", device="cpu")

    def test_persistence_roundtrip(self, rng, temp_dir):
        d = 32
        idx = _make(d)
        db = _normed(rng, 1500, d)
        slots = idx.add_batch(db)
        idx.build()
        idx.remove_slots(slots[:10])
        fresh = _normed(rng, 5, d)
        idx.add_batch(fresh)
        path = os.path.join(temp_dir, "sc")
        idx.save(path)
        idx2 = _make(d)
        assert idx2.load(path)
        assert idx2.count() == idx.count() and idx2.is_trained
        _, a = idx.search(fresh, 3)
        _, b = idx2.search(fresh, 3)
        assert (a == b).all()

    def test_remesh_rebuilds(self, rng):
        d = 32
        idx = _make(d)
        db = _normed(rng, 1500, d)
        idx.add_batch(db)
        idx.build()
        _, pre = idx.search(db[:5], 3)
        idx.remesh(_cpu_mesh(4))
        assert idx.n_devices == 4 and idx.is_trained
        _, post = idx.search(db[:5], 3)
        assert (pre == post).all()

    def test_int8(self, rng):
        d = 64
        db = _normed(rng, 3000, d)
        idx = _make(d, dtype="int8")
        idx.add_batch(db)
        idx.build()
        q = _normed(rng, 4, d)
        _, got = idx.search(q, 10)
        exact = np.argsort(-(q @ db.T), axis=-1)[:, :10]
        recall = np.mean(
            [len(set(int(x) for x in a) & set(b.tolist())) / 10
             for a, b in zip(got, exact)]
        )
        assert recall >= 0.9, recall

    def test_untrained_falls_back(self, rng):
        idx = _make(16, train_threshold=10_000)
        db = _normed(rng, 64, 16)
        slots = idx.add_batch(db)
        _, got = idx.search(db[:3], 1)
        assert (got.ravel() == slots[:3]).all()

    def test_slot_mask_routes_exact(self, rng):
        idx = _make(32)
        idx.add_batch(_normed(rng, 1024, 32))
        idx.build()
        mask = np.zeros(1024, bool)
        mask[::2] = True
        _, got = idx.search(_normed(rng, 4, 32), 10, slot_mask=mask)
        assert all(int(g) % 2 == 0 for g in got.ravel() if g >= 0)

    def test_factory(self):
        idx = create_index("sharded_clustered", 8, device="cpu")
        assert isinstance(idx, ShardedClusteredIndex)

    def test_tune(self, rng):
        d = 32
        idx = _make(d, nlist=16, nprobe=1)
        idx.add_batch(_normed(rng, 4000, d))
        idx.build()
        achieved = idx.tune(_normed(rng, 16, d), k=10, target_recall=0.9)
        assert achieved >= 0.9

    def test_replica_mesh_serving(self, rng):
        """A (replica, shard) mesh: slabs and extents on both groups, the
        query batch split over the groups; the same answers as 1-D."""
        d = 16
        idx = _make(d, nlist=8, nprobe=8, replicas=2)
        assert idx.replicas == 2 and idx.n_devices == 4
        db = _normed(rng, 600, d)
        slots = idx.add_batch(db)
        idx.build()
        _, got = idx.search(db[:8], 3)
        assert (got[:, 0] == slots[:8]).all()
        # odd batch sizes round the routing width to the replica multiple
        _, g1 = idx.search(db[:1], 3)
        assert g1.shape == (1, 3) and g1[0, 0] == slots[0]
        qs = rng.standard_normal((2, 6, d)).astype(np.float32)
        sp, gp = idx.search_pipelined(qs, 3)
        assert sp.shape == (2, 6, 3)
        for i in range(2):
            _, gi = idx.search(qs[i], 3)
            assert (gp[i] == gi).all()

    def test_kernel_path_interpret(self, rng):
        """The kernel path (K3's plain version on the CPU) and K4 (v1)
        give the portable scan's answers."""
        d = 32
        idx = _make(d, nlist=8, nprobe=8)
        db = _normed(rng, 1024, d)
        idx.add_batch(db)
        idx.build()
        idx.ivf_kernel = "lax"
        _, g_lax = idx.search(db[:4], 5)
        idx.ivf_kernel = "pallas"
        _, g_k = idx.search(db[:4], 5)
        assert (g_lax == g_k).all()
        idx.kernel_version = "v1"
        _, g_v1 = idx.search(db[:4], 5)
        assert (g_lax == g_v1).all()


class TestShardedHoleRecycling:
    """Bucket-matched hole reuse on the striped layout: a hole on shard
    s in bucket b is reusable by any row assigning to b; capacity stays
    bounded under delete churn."""

    def test_delete_insert_churn_bounded(self, rng):
        d = 32
        idx = _make(d, nlist=8, nprobe=8)
        db = _normed(rng, 2048, d)
        slots = idx.add_batch(db)
        idx.build()
        ns0 = idx._next_slot
        idx.remove_slots(slots[:200])
        assert idx._quar_len() == 200
        near = 0.95 * db[:200] + 0.05 * _normed(rng, 200, d)
        near /= np.linalg.norm(near, axis=-1, keepdims=True)
        new_slots = idx.add_batch(near)
        assert idx._quar_len() <= 20
        assert idx._next_slot - ns0 == idx._quar_len()
        assert idx.count() == 2048
        # recycled rows are served by the per-shard block scan
        pos = idx._positions_of(new_slots)
        in_cluster = pos < idx._fresh_base
        probe = np.asarray(
            idx.get_vectors(new_slots[in_cluster][:8]), np.float32
        )
        _, got = idx.search(probe, 1)
        assert (got[:, 0] == new_slots[in_cluster][:8]).all()

    def test_persist_rekeys_and_remesh_clears(self, rng, temp_dir):
        d = 32
        idx = _make(d, nlist=8, nprobe=8)
        db = _normed(rng, 2048, d)
        slots = idx.add_batch(db)
        idx.build()
        idx.remove_slots(slots[:100])
        path = os.path.join(temp_dir, "ck")
        idx.save(path)
        idx2 = _make(d, nlist=8, nprobe=8)
        assert idx2.load(path)
        assert sorted(idx2._quar_flat()) == sorted(idx._quar_flat())
        assert all(b >= 0 for b in idx2._quar)
        # remesh triggers a rebuild, which absorbs the holes
        idx2.remesh(_cpu_mesh(4))
        assert idx2._quar_len() == 0
        assert idx2.count() == 2048 - 100


def _spy_exact(monkeypatch):
    from wdbx_tpu_torch.parallel.sharded_flat import ShardedFlatIndex

    called = []
    orig = ShardedFlatIndex._enqueue

    def spy(self_, q, k, plan):
        called.append(1)
        return orig(self_, q, k, plan)

    monkeypatch.setattr(ShardedFlatIndex, "_enqueue", spy)
    return called


class TestFilterPushdown:
    """slot_mask above the selectivity threshold stays on the ANN index:
    the position mask stripes into row validity and nprobe boosts."""

    def test_pushdown_used_above_threshold(self, rng, monkeypatch):
        d, n = 32, 4096
        db = _normed(rng, n, d)
        idx = _make(d, nlist=16, nprobe=4)
        slots = idx.add_batch(db)
        idx.build()
        called = _spy_exact(monkeypatch)
        mask = np.zeros(n, bool)
        mask[: n // 2] = True  # 50% selectivity
        q = _normed(rng, 8, d)
        _, got = idx.search(q, 10, slot_mask=mask)
        assert not called, "50% filter must use pushdown, not exact"
        live = got[got >= 0]
        assert len(live) and (live < n // 2).all()
        sub = np.where(mask)[0]
        exact = slots[sub[np.argsort(-(q @ db[sub].T), axis=-1)[:, :10]]]
        recall = np.mean(
            [len(set(a.tolist()) & set(b.tolist())) / 10
             for a, b in zip(got, exact)]
        )
        assert recall >= 0.8, recall

    def test_sparse_filter_routes_exact(self, rng, monkeypatch):
        d, n = 32, 4096
        db = _normed(rng, n, d)
        idx = _make(d, nlist=16, nprobe=4)
        idx.add_batch(db)
        idx.build()
        called = _spy_exact(monkeypatch)
        sparse = np.zeros(n, bool)
        sparse[:16] = True  # 0.4%: below the 2% threshold
        _, got = idx.search(_normed(rng, 4, d), 5, slot_mask=sparse)
        assert called, "sparse filter must route to the exact scan"
        live = got[got >= 0]
        assert (live < 16).all()

    def test_filtered_matches_unsharded(self, rng):
        """Sharded filtered results agree with the single-device
        clustered engine's (same corpus, full probe)."""
        from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex

        d, n = 32, 2048
        db = _normed(rng, n, d)
        sh = _make(d, nlist=8, nprobe=8)
        sh.add_batch(db)
        sh.build()
        si = ClusteredIVFIndex(d, nlist=8, nprobe=8, train_threshold=256,
                               device="cpu")
        si.batch_flat_fallback = False
        si.add_batch(db)
        si.build()
        mask = rng.random(n) < 0.3
        q = _normed(rng, 8, d)
        _, got_sh = sh.search(q, 10, slot_mask=mask)
        _, got_si = si.search(q, 10, slot_mask=mask)
        agree = np.mean(
            [len(set(a.tolist()) & set(b.tolist())) / 10
             for a, b in zip(got_sh, got_si)]
        )
        assert agree >= 0.95, agree


class TestShardedFilteredTuning:
    """tune_filtered on the striped engine: the recall-closed loop works
    where the filtered scan runs per shard."""

    def test_tune_filtered_meets_bar(self, rng):
        d = 32
        idx = _make(d, nlist=64, nprobe=2)
        db = _normed(rng, 16384, d)
        slots = np.asarray(idx.add_batch(db))
        idx.build()
        mask = np.zeros(int(slots.max()) + 1, bool)
        mask[slots[rng.random(len(slots)) < 0.10]] = True
        q = _normed(rng, 16, d)
        achieved = idx.tune_filtered(q, mask, k=10, target_recall=0.95)
        assert achieved >= 0.95, achieved
        _, got = idx.search(_normed(rng, 8, d), 10, slot_mask=mask)
        assert all(mask[int(g)] for g in got.ravel() if g >= 0)

    def test_sharded_ivf_tune_filtered(self, rng):
        from wdbx_tpu_torch.parallel import ShardedIVFIndex

        d = 32
        idx = ShardedIVFIndex(d, nlist=64, nprobe=2, train_threshold=256,
                              device="cpu")
        idx.batch_flat_fallback = False
        db = _normed(rng, 16384, d)
        slots = np.asarray(idx.add_batch(db))
        idx.build()
        mask = np.zeros(int(slots.max()) + 1, bool)
        mask[slots[rng.random(len(slots)) < 0.10]] = True
        achieved = idx.tune_filtered(
            _normed(rng, 16, d), mask, k=10, target_recall=0.95
        )
        assert achieved >= 0.95, achieved
