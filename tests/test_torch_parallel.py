"""The mesh layer of the port (wdbx_tpu_torch.parallel) on the CPU.

The cases of ``tests/test_parallel.py`` run on the port, with every
index on 8 logical CPU shards (``WDBX_TORCH_MESH_SIZE=8``, the port's
counterpart of the JAX suite's 8 faked CPU devices). Then parity with
the JAX ``ShardedFlatIndex`` on the same seeded inputs: every slab type,
growth past a capacity step, masks, replicas (2 x 4) and remeshes to 4
and 7 shards. Scores agree within 1e-5 (float32) or 2e-2 (bf16 / int8 /
int4), slot sets agree except at ties, and -inf / -1 sit in the same
places (``assert_topk_match``).

Cases of ``tests/test_parallel.py`` that live elsewhere or are left out:
  * ``TestShardedIVF``, ``test_sharded_ivf_int8_tables``,
    ``TestShardedPipelined.test_sharded_ivf_pipelined`` and
    ``TestRemesh.test_sharded_ivf_remesh_rebuilds``:
    ``tests/test_torch_sharded_ivf.py``;
  * ``TestFailover.test_heal_recovers_from_checkpoint``,
    ``TestRemesh.test_heal_cold_rehosts_when_remesh_fails`` and
    ``TestRemesh.test_heal_escalates_to_remesh`` (the facade):
    ``tests/test_torch_heal.py``;
  * ``TestMultiHost.test_two_process_shard_engine`` and
    ``test_two_process_data_plane``: their gloo counterparts are in
    ``tests/test_torch_multihost.py``.

``TestRemesh.test_sharded_clustered_load_on_different_mesh`` runs here
too, and ``.ivfsc`` checkpoints of 8 shards load on 4 across the
packages, both ways.
"""

import asyncio
import os

import numpy as np
import pytest
import torch

from test_torch_ops import TOL, assert_topk_match
from wdbx_tpu.parallel import ShardedFlatIndex as JSharded
from wdbx_tpu.parallel import make_mesh as jmesh
from wdbx_tpu_torch.core.config import WDBXConfig
from wdbx_tpu_torch.parallel import (
    ShardedFlatIndex,
    ShardEngine,
    make_mesh,
    make_mesh2,
)
from wdbx_tpu_torch.parallel.mesh import MESH_SIZE_ENV

torch.set_num_threads(2)

DTYPES = ["float32", "bfloat16", "int8", "int4"]


@pytest.fixture(autouse=True)
def eight_shards(monkeypatch):
    monkeypatch.setenv(MESH_SIZE_ENV, "8")


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def TIndex(*args, **kw):  # noqa: N802 - the port's index on the CPU
    return ShardedFlatIndex(*args, device="cpu", **kw)


def cpu_mesh(n=None):
    return make_mesh(n, device="cpu")


class TestMesh:
    def test_eight_devices(self):
        mesh = cpu_mesh()
        assert mesh.size == 8
        assert mesh.axis_names == ("shard",)

    def test_subset(self):
        assert cpu_mesh(4).size == 4

    def test_positions_names_and_sizes(self, monkeypatch):
        mesh = cpu_mesh(8)
        assert mesh.names == tuple(f"cpu#{i}" for i in range(8))
        assert all(d == torch.device("cpu") for d in mesh.devices)
        two = make_mesh2(2, device="cpu")
        assert two.shape == {"replica": 2, "shard": 4} and two.size == 8
        assert make_mesh2(2, 3, device="cpu").size == 6
        with pytest.raises(ValueError):
            make_mesh2(3, device="cpu")  # 8 positions over 3 replicas
        monkeypatch.delenv(MESH_SIZE_ENV)
        assert cpu_mesh().size == 1  # one position a visible device
        monkeypatch.setenv(MESH_SIZE_ENV, "0")
        with pytest.raises(ValueError):
            cpu_mesh()


class TestShardedFlatIndex:
    def test_matches_exact_oracle(self, rng):
        idx = TIndex(dim=32, capacity=2048)
        db = _normed(rng, 1500, 32)
        slots = idx.add_batch(db)
        q = _normed(rng, 8, 32)
        scores, got = idx.search(q, k=10)
        ref = np.argsort(-(q @ db.T), axis=-1)[:, :10]
        ref_slots = slots[ref]
        for a, b in zip(got, ref_slots):
            assert set(a.tolist()) == set(b.tolist())

    def test_capacity_is_device_aligned(self):
        idx = TIndex(dim=8, capacity=100)
        assert idx.capacity % 8 == 0

    def test_capacity_and_mesh_are_checked(self):
        # slots stay int32 through the merge; the shard axis is the last
        with pytest.raises(ValueError, match="int32"):
            TIndex(dim=8, capacity=2**31)
        with pytest.raises(ValueError, match="axis"):
            TIndex(dim=8, mesh=make_mesh2(2, 4, axes=("shard", "replica"),
                                          device="cpu"))
        idx = TIndex(dim=8)
        with pytest.raises(ValueError, match="lacks axis"):
            idx.adopt_mesh(make_mesh(4, axis="x", device="cpu"))
        assert idx.n_devices == 8

    def test_growth(self, rng):
        idx = TIndex(dim=8, capacity=8)
        vecs = _normed(rng, 5000, 8)
        idx.add_batch(vecs)
        assert idx.count() == 5000
        _, got = idx.search(vecs[4321], k=1)
        assert got[0, 0] == 4321

    def test_remove_and_mask(self, rng):
        idx = TIndex(dim=8)
        vecs = _normed(rng, 40, 8)
        slots = idx.add_batch(vecs)
        idx.remove_slots(slots[:10])
        _, got = idx.search(vecs[0], k=5)
        assert slots[0] not in got[0]
        mask = np.zeros(idx.capacity, bool)
        mask[slots[20:]] = True
        _, got = idx.search(vecs[25], k=3, slot_mask=mask)
        assert got[0, 0] == slots[25]

    def test_persistence(self, rng, temp_dir):
        idx = TIndex(dim=8)
        vecs = _normed(rng, 30, 8)
        slots = idx.add_batch(vecs)
        idx.save(f"{temp_dir}/sharded")
        idx2 = TIndex(dim=8)
        assert idx2.load(f"{temp_dir}/sharded")
        _, got = idx2.search(vecs[:3], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[:3])

    def test_stats(self):
        idx = TIndex(dim=8)
        s = idx.get_stats()
        assert s["devices"] == 8
        assert s["type"] == "sharded_flat"
        assert len(set(s["positions"])) == 8

    def test_store_integration(self, rng, temp_dir):
        from wdbx_tpu_torch.store.vector_store import VectorStore

        cfg = WDBXConfig(
            {
                "VECTOR_DIMENSION": 8,
                "NUM_SHARDS": 1,
                "DATA_DIR": temp_dir,
                "INDEX_TYPE": "sharded_flat",
            }
        )
        store = VectorStore(cfg, device="cpu")
        vecs = {f"v{i}": rng.standard_normal(8).astype(np.float32)
                for i in range(64)}
        store.batch_store(vecs)
        hits = store.search(vecs["v33"], limit=1)
        assert hits[0][0] == "v33"
        assert store.verify()["consistent"]


class TestShardEngine:
    def test_initialize_and_allocation(self, temp_dir):
        cfg = WDBXConfig(
            {"DATA_DIR": temp_dir, "DISTRIBUTED_REPLICATION_FACTOR": 2}
        )
        engine = ShardEngine(cfg, device="cpu")
        asyncio.run(engine.initialize())
        alloc = engine.allocation()
        assert len(alloc["shards"]) == 8
        shard0 = alloc["shards"]["0"]
        assert len(shard0["replicas"]) == 1
        assert shard0["replicas"][0] != shard0["primary"]
        assert os.path.exists(f"{temp_dir}/shard_allocation.json")
        stats = engine.get_stats()
        assert stats["initialized"] and len(stats["devices"]) == 8
        assert engine.is_local_shard(0)
        assert alloc["process_count"] == 1


class TestReplicatedMesh:
    def test_replica_groups_serve_batch_slices(self, rng):
        idx = TIndex(dim=16, replicas=2)  # 2 replicas x 4 shards
        assert idx.replicas == 2 and idx.n_devices == 4
        vecs = _normed(rng, 200, 16)
        slots = idx.add_batch(vecs)
        scores, got = idx.search(vecs[:8], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[:8])
        np.testing.assert_allclose(scores[:, 0], 1.0, rtol=1e-4)

    def test_replicated_deletes_and_growth(self, rng):
        idx = TIndex(dim=8, replicas=4, capacity=8)  # 4x2 mesh
        vecs = _normed(rng, 600, 8)
        slots = idx.add_batch(vecs)
        idx.remove_slots(slots[:10])
        _, got = idx.search(vecs[0], k=5)
        assert slots[0] not in got[0]
        _, got = idx.search(vecs[500:503], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[500:503])
        # every replica group holds the same rows
        for p in range(idx.n_devices, idx.mesh.size):
            torch.testing.assert_close(idx._slabs[p],
                                       idx._slabs[p % idx.n_devices])
            assert torch.equal(idx._valids[p], idx._valids[p % idx.n_devices])

    def test_stats_report_replicas(self):
        idx = TIndex(dim=8, replicas=2)
        s = idx.get_stats()
        assert s["replicas"] == 2 and s["devices"] == 4


def test_shard_engine_health_check(temp_dir):
    engine = ShardEngine(WDBXConfig({"DATA_DIR": temp_dir}), device="cpu")
    asyncio.run(engine.initialize())
    report = engine.health_check()
    assert report["healthy"]
    assert len(report["devices"]) == 8
    assert all(v == "ok" for v in report["devices"].values())


class TestFailover:
    def test_plan_recovery_uses_replicas(self, temp_dir):
        """Replica metadata must be CONSUMED on failure: a dead primary's
        shard is re-targeted at its first healthy replica."""
        engine = ShardEngine(WDBXConfig({
            "DATA_DIR": temp_dir, "DISTRIBUTED_REPLICATION_FACTOR": 2,
        }), device="cpu")
        asyncio.run(engine.initialize())
        alloc = engine.allocation()
        devices = [p["primary"] for p in alloc["shards"].values()]
        health = {
            "healthy": False,
            "devices": {
                d: ("error: down" if i == 0 else "ok")
                for i, d in enumerate(devices)
            },
        }
        plan = engine.plan_recovery(health)
        assert 0 in plan
        expected_replica = alloc["shards"]["0"]["replicas"][0]
        assert plan[0] == expected_replica
        assert all(s == 0 for s in plan)


class TestRemesh:
    def test_flat_remesh_preserves_data(self, rng):
        """8 -> 4 shards: same slots, same search results, adds work."""
        idx = TIndex(8, capacity=64)
        vecs = _normed(rng, 40, 8)
        slots = idx.add_batch(vecs)
        _, pre = idx.search(vecs[:5], 3)
        idx.remesh(cpu_mesh(4))
        assert idx.n_devices == 4
        _, post = idx.search(vecs[:5], 3)
        assert (pre == post).all()
        assert idx.count() == 40
        more = idx.add_batch(_normed(rng, 6, 8))
        _, got = idx.search(np.asarray(idx.get_vectors(more[:1])), 1)
        assert got.ravel()[0] == more[0]
        idx.remove_slots(slots[:2])
        assert idx.count() == 44

    def test_remesh_up(self, rng):
        idx = TIndex(8, mesh=cpu_mesh(2), capacity=64)
        vecs = _normed(rng, 16, 8)
        idx.add_batch(vecs)
        idx.remesh(cpu_mesh(8))
        assert idx.n_devices == 8
        _, got = idx.search(vecs[:3], 1)
        assert (got.ravel() == np.arange(3)).all()

    def test_degraded_mesh_excludes_dead(self, temp_dir):
        engine = ShardEngine(WDBXConfig({"DATA_DIR": temp_dir}), device="cpu")
        asyncio.run(engine.initialize())
        devices = list(engine.mesh.names)
        health = {"healthy": False, "devices": {
            d: ("error: down" if i == 2 else "ok")
            for i, d in enumerate(devices)
        }}
        degraded = engine.degraded_mesh(health)
        left = list(degraded.names)
        assert len(left) == len(devices) - 1 and devices[2] not in left
        ok = {"healthy": True, "devices": {d: "ok" for d in devices}}
        assert engine.degraded_mesh(ok) is engine.mesh

    def test_cold_rehost_adopt_mesh(self, rng, temp_dir):
        """adopt_mesh + checkpoint reload: the fallback when the old
        mesh is unreachable and a live remesh gather is impossible."""
        idx = TIndex(8, capacity=64)
        vecs = _normed(rng, 24, 8)
        slots = idx.add_batch(vecs)
        path = os.path.join(temp_dir, "cold")
        idx.save(path)
        idx.adopt_mesh(cpu_mesh(4))
        assert idx.n_devices == 4 and idx.count() == 0
        assert idx.load(path)
        _, got = idx.search(vecs[:5], 1)
        assert (got.ravel() == slots[:5]).all()


    def test_sharded_clustered_load_on_different_mesh(self, rng, temp_dir):
        """A trained checkpoint of 8 shards rebuilds its per-shard
        extents when loaded on 4 (installing the persisted (8, nlist)
        extents would corrupt results)."""
        from wdbx_tpu_torch.parallel import ShardedClusteredIndex

        idx = ShardedClusteredIndex(16, nlist=8, nprobe=8,
                                    train_threshold=64, device="cpu")
        idx.batch_flat_fallback = False
        vecs = _normed(rng, 600, 16)
        slots = idx.add_batch(vecs)
        idx.build()
        path = os.path.join(temp_dir, "xmesh")
        idx.save(path)
        idx2 = ShardedClusteredIndex(16, mesh=cpu_mesh(4), nlist=8,
                                     nprobe=8, train_threshold=64)
        idx2.batch_flat_fallback = False
        assert idx2.load(path)
        assert idx2.is_trained and idx2.n_devices == 4
        assert idx2._local_counts.shape[0] == 4
        _, got = idx2.search(vecs[:8], 1)
        assert (got.ravel() == slots[:8]).all()


class TestShardedPipelined:
    def test_sharded_flat_pipelined(self, rng):
        idx = TIndex(dim=16, capacity=1024)
        vecs = _normed(rng, 300, 16)
        idx.add_batch(vecs)
        qs = vecs[:24].reshape(3, 8, 16)
        s3, i3 = idx.search_pipelined(qs, k=5)
        assert s3.shape == (3, 8, 5)
        for nb in range(3):
            _, i1 = idx.search(qs[nb], k=5)
            np.testing.assert_array_equal(i3[nb], i1)

    def test_sharded_inflight_matches_blocking(self, rng):
        """materialize=False handles on the sharded engines resolve to
        the blocking path's exact output."""
        from wdbx_tpu_torch.parallel import ShardedIVFIndex

        vecs = _normed(rng, 512, 16)
        qs = vecs[:24].reshape(3, 8, 16)

        flat = TIndex(dim=16, capacity=1024)
        flat.add_batch(vecs)
        want = flat.search_pipelined(qs, k=5)
        got = flat.resolve_pipelined(
            flat.search_pipelined(qs, k=5, materialize=False)
        )
        np.testing.assert_array_equal(got[1], want[1])

        ivf = ShardedIVFIndex(dim=16, nlist=16, nprobe=16,
                              train_threshold=64, device="cpu")
        ivf.batch_flat_fallback = False
        ivf.add_batch(vecs)
        ivf.build()
        want = ivf.search_pipelined(qs, k=4)
        handles = [
            ivf.search_pipelined(qs, k=4, materialize=False)
            for _ in range(2)
        ]
        for h in handles:
            _, ii = ivf.resolve_pipelined(h)
            np.testing.assert_array_equal(ii, want[1])
        cold = ShardedIVFIndex(dim=16, train_threshold=10**9, device="cpu")
        cold.add_batch(vecs[:64])
        want = cold.search_pipelined(qs, k=2)
        got = cold.resolve_pipelined(
            cold.search_pipelined(qs, k=2, materialize=False)
        )
        np.testing.assert_array_equal(got[1], want[1])
        # k past the capacity on the untrained fallback pads to k
        tiny = ShardedIVFIndex(dim=16, train_threshold=10**9, capacity=64,
                               device="cpu", mesh=cpu_mesh(1))
        tiny.add_batch(vecs[:64])
        ks, kg = tiny.search_pipelined(qs, k=200)
        assert ks.shape == (3, 8, 200) and kg.shape == (3, 8, 200)
        assert (kg[:, :, 64:] == -1).all()
        ks2, kg2 = tiny.resolve_pipelined(
            tiny.search_pipelined(qs, k=200, materialize=False)
        )
        np.testing.assert_array_equal(kg2, kg)


def test_sharded_fused_kernel_path(rng):
    """topk_method="fused": each shard's stage 1 through the kernel
    wrapper (its plain version on CPU tensors) and one merge."""
    for dtype in ("bfloat16", "int8"):
        idx = TIndex(dim=32, dtype=dtype, capacity=2048)
        idx.topk_method = "fused"
        vecs = _normed(rng, 600, 32)
        slots = idx.add_batch(vecs)
        idx.remove_slots(slots[:5])
        _, got = idx.search(vecs[5:13], k=3)
        np.testing.assert_array_equal(got[:, 0], slots[5:13])
        assert slots[0] not in got.flatten()


# -- parity with the JAX ShardedFlatIndex ------------------------------------
def _pair(dtype, capacity=64, replicas=1, dim=16):
    return (JSharded(dim, dtype=dtype, capacity=capacity, replicas=replicas),
            TIndex(dim, dtype=dtype, capacity=capacity, replicas=replicas))


def _same(jres, tres, dtype):
    assert tres[1].dtype == np.int64
    assert_topk_match(*jres, *tres, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_flat_matches_jax(rng, dtype):
    """The same mutations and searches through both packages: adds,
    updates, deletes, slot reuse, growth past a capacity step, plain /
    masked / pipelined searches, get_vectors, compact."""
    j, t = _pair(dtype)
    both = (j, t)
    x = rng.standard_normal((900, 16)).astype(np.float32)
    np.testing.assert_array_equal(j.add_batch(x), t.add_batch(x))
    assert j.capacity == t.capacity == 1024
    for ix in both:
        ix.update_slots(np.array([3, 7]), x[:2] * 2)
        ix.remove_slots(np.array([1, 2, 10, 801]))
    reuse = [ix.add_batch(x[100:105]) for ix in both]
    np.testing.assert_array_equal(*reuse)
    grow = rng.standard_normal((300, 16)).astype(np.float32)
    for ix in both:
        ix.add_batch(grow)
    assert j.capacity == t.capacity > 1024
    assert j.count() == t.count() == 1201
    q = rng.standard_normal((9, 16)).astype(np.float32)
    _same(j.search(q, 10), t.search(q, 10), dtype)
    _same(j.search(q, 1), t.search(q, 1), dtype)
    mask = rng.random(j.capacity) > 0.7
    _same(j.search(q, 10, slot_mask=mask), t.search(q, 10, slot_mask=mask),
          dtype)
    qs = rng.standard_normal((3, 5, 16)).astype(np.float32)
    _same(j.search_pipelined(qs, 4), t.search_pipelined(qs, 4), dtype)
    probe = np.array([0, 3, 7, 801, 1200])
    np.testing.assert_allclose(t.get_vectors(probe), j.get_vectors(probe),
                               atol=TOL[dtype])
    # compact: the JAX sharded index takes the device axis of its
    # (n_dev, rows) validity for slots (a fault of the reference), so
    # the port's repack is held against JAX's live slots and answers
    live = np.nonzero(j._host_slot_view()[1])[0]
    old, new = t.compact()
    np.testing.assert_array_equal(old, live)
    np.testing.assert_array_equal(new, np.arange(len(live)))
    remap = np.full(j.capacity, -1)
    remap[old] = new
    sj, ij = j.search(q, 10)
    _same((sj, np.where(ij >= 0, remap[ij], -1)), t.search(q, 10), dtype)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_replicated_matches_jax(rng, dtype):
    """2 replicas x 4 shards: batches split over the replica groups, and
    every write reaches both copies."""
    j, t = _pair(dtype, replicas=2)
    assert t.replicas == 2 and t.n_devices == 4
    x = rng.standard_normal((700, 16)).astype(np.float32)
    for ix in (j, t):
        ix.add_batch(x)
        ix.remove_slots(np.arange(0, 50, 3))
    for b in (1, 7, 16):
        q = rng.standard_normal((b, 16)).astype(np.float32)
        _same(j.search(q, 8), t.search(q, 8), dtype)
    # JAX's replicated search_pipelined slices a replica-sharded result
    # and raises ShardingTypeError: the port's stack is held against
    # JAX's search of each batch
    qs = rng.standard_normal((2, 6, 16)).astype(np.float32)
    per = [j.search(qb, 5) for qb in qs]
    _same((np.stack([p[0] for p in per]), np.stack([p[1] for p in per])),
          t.search_pipelined(qs, 5), dtype)


@pytest.mark.parametrize("n_new", [4, 7])
def test_remesh_matches_jax(rng, n_new):
    """Live re-meshing 8 -> 4 and 8 -> 7 shards in both packages: the
    same answers after, and writes on the new striping."""
    j, t = _pair("bfloat16", capacity=64)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    for ix in (j, t):
        ix.add_batch(x)
        ix.remove_slots(np.array([4, 5, 77]))
    j.remesh(jmesh(n_new))
    t.remesh(cpu_mesh(n_new))
    assert t.n_devices == j.n_devices == n_new
    assert t.capacity == j.capacity
    q = rng.standard_normal((6, 16)).astype(np.float32)
    _same(j.search(q, 10), t.search(q, 10), "bfloat16")
    more = rng.standard_normal((40, 16)).astype(np.float32)
    np.testing.assert_array_equal(j.add_batch(more), t.add_batch(more))
    _same(j.search(q, 10), t.search(q, 10), "bfloat16")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_clustered_checkpoint_across_packages_and_meshes(
        rng, temp_dir, writer):
    """An ``.ivfsc`` checkpoint of 8 shards written by one package loads
    on 4 shards in the other: the extents rebuild there, and every row
    answers its own query."""
    from wdbx_tpu.parallel.sharded_clustered import (
        ShardedClusteredIndex as JClustered,
    )
    from wdbx_tpu_torch.parallel import ShardedClusteredIndex

    vecs = _normed(rng, 700, 16)
    kw = dict(nlist=8, nprobe=8, train_threshold=64)
    if writer == "jax":
        src = JClustered(16, **kw)
        dst = ShardedClusteredIndex(16, mesh=cpu_mesh(4), **kw)
    else:
        src = ShardedClusteredIndex(16, device="cpu", **kw)
        dst = JClustered(16, mesh=jmesh(4), **kw)
    slots = src.add_batch(vecs)
    src.build()
    src.remove_slots(slots[:5])
    path = os.path.join(temp_dir, "ckpt")
    src.save(path)
    dst.batch_flat_fallback = False
    assert dst.load(path)
    assert dst.n_devices == 4 and dst.is_trained
    assert dst.count() == src.count() == 695
    _, got = dst.search(vecs[5:21], 1)
    np.testing.assert_array_equal(got.ravel(), slots[5:21])
