"""The port's ShardedIVFIndex (wdbx_tpu_torch.parallel.sharded_ivf) on
8 logical CPU shards.

The sharded IVF cases of ``tests/test_parallel.py`` (``TestShardedIVF``,
``test_sharded_ivf_int8_tables``, the pipelined and remesh cases) run on
the port. Then parity: a JAX ``ShardedIVFIndex`` is built (its k-means
picks the layout) and carried into the port with
``sharded_ivf_index_from_arrays``, so both serve the same slab, tables,
centroids and residual list. Hits must agree within 1e-5 (float32 slab)
or 2e-2 (bf16 / int8), slot sets equal except at ties, -inf / -1 in the
same places; at a size where the per-shard probe quota overflows, the
port must drop the probes JAX drops and keep exactly the slots JAX
keeps.
"""

import numpy as np
import pytest
import torch

from test_torch_ops import TOL, assert_topk_match
from wdbx_tpu.parallel.sharded_ivf import ShardedIVFIndex as JIndex
from wdbx_tpu_torch.convert import sharded_ivf_index_from_arrays
from wdbx_tpu_torch.parallel import ShardedFlatIndex, ShardedIVFIndex, make_mesh
from wdbx_tpu_torch.parallel.mesh import MESH_SIZE_ENV

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def eight_shards(monkeypatch):
    monkeypatch.setenv(MESH_SIZE_ENV, "8")


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def TIndex(*args, **kw):  # noqa: N802 - the port's index on the CPU
    return ShardedIVFIndex(*args, device="cpu", **kw)


class TestShardedIVF:
    def _mk(self, rng, n=2048, d=32, nlist=16, nprobe=4):
        idx = TIndex(dim=d, nlist=nlist, nprobe=nprobe, train_threshold=256)
        vecs = _normed(rng, n, d)
        slots = idx.add_batch(vecs)
        idx.build()
        return idx, vecs, slots

    def test_build_shards_tables(self, rng):
        idx, vecs, slots = self._mk(rng)
        assert idx.is_trained
        # one table block a shard, on its position's device
        assert len(idx._bucket_rows) == idx.n_devices
        local = idx._bucket_rows[0].shape[0]
        assert all(t.shape[0] == local for t in idx._bucket_rows)
        assert (local * idx.n_devices) % idx.n_devices == 0
        assert all(t.device == d for t, d in
                   zip(idx._bucket_rows, idx.mesh.devices))

    def test_self_query_and_recall(self, rng):
        idx, vecs, slots = self._mk(rng)
        idx.batch_flat_fallback = False
        idx.nprobe = 16  # probe everything: exact
        scores, got = idx.search(vecs[:32], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[:32])
        idx.nprobe = 4
        achieved = idx.tune(vecs[100:164], k=10, target_recall=0.9)
        assert achieved >= 0.9, achieved

    def test_fresh_adds_visible(self, rng):
        idx, vecs, slots = self._mk(rng)
        idx.batch_flat_fallback = False
        late = _normed(rng, 5, 32)
        late_slots = idx.add_batch(late)
        _, got = idx.search(late, k=1)
        np.testing.assert_array_equal(got[:, 0], late_slots)

    def test_delete_after_build_invisible(self, rng):
        idx, vecs, slots = self._mk(rng)
        idx.batch_flat_fallback = False
        idx.nprobe = 16
        idx.remove_slots(slots[:4])
        _, got = idx.search(vecs[:4], k=5)
        for qi in range(4):
            assert slots[qi] not in got[qi]

    def test_candidates_span_devices(self, rng):
        idx, vecs, slots = self._mk(rng, n=4096, nlist=32, nprobe=32)
        idx.batch_flat_fallback = False
        _, got = idx.search(vecs[:64], k=10)
        owners = {int(s) % idx.n_devices for s in got.flatten() if s >= 0}
        assert len(owners) == idx.n_devices, owners

    def test_masked_search_falls_to_exact(self, rng):
        idx, vecs, slots = self._mk(rng)
        mask = np.zeros(idx.capacity, bool)
        allowed = slots[::3]
        mask[allowed] = True
        _, got = idx.search(vecs[:8], k=5, slot_mask=mask)
        allowed_set = set(int(s) for s in allowed)
        for row in got:
            for s in row:
                assert s < 0 or int(s) in allowed_set

    def test_masked_search_pushdown_above_threshold(self, rng, monkeypatch):
        """>=2% selectivity masks ride the bucket tables (AND into each
        shard's bucket validity + the striped row validity), not the
        exact scan."""
        idx, vecs, slots = self._mk(rng, n=4096, nlist=16, nprobe=4)
        idx.batch_flat_fallback = False
        called = []
        orig = ShardedFlatIndex._enqueue

        def spy(self_, q, k, plan):
            called.append(1)
            return orig(self_, q, k, plan)

        monkeypatch.setattr(ShardedFlatIndex, "_enqueue", spy)
        mask = np.zeros(idx.capacity, bool)
        allowed = slots[: len(slots) // 2]  # 50%
        mask[allowed] = True
        q = vecs[:8]
        _, got = idx.search(q, k=10, slot_mask=mask)
        assert not called, "50% filter must use bucket pushdown"
        allowed_set = set(int(s) for s in allowed)
        live = [int(s) for row in got for s in row if s >= 0]
        assert live and all(s in allowed_set for s in live)
        sub = np.asarray(allowed)
        exact = sub[np.argsort(-(q @ vecs[sub].T), axis=-1)[:, :10]]
        recall = np.mean(
            [len(set(a.tolist()) & set(b.tolist())) / 10
             for a, b in zip(got, exact)]
        )
        assert recall >= 0.8, recall
        sparse = np.zeros(idx.capacity, bool)
        sparse[slots[:40]] = True  # ~1%
        idx.search(q, k=5, slot_mask=sparse)
        assert called

    def test_factory(self):
        from wdbx_tpu_torch.core.config import WDBXConfig
        from wdbx_tpu_torch.index import create_index

        idx = create_index("sharded_ivf", 16, WDBXConfig({"IVF_NLIST": 8}),
                           device="cpu")
        assert idx.kind == "sharded_ivf" and idx.nlist == 8
        assert isinstance(idx, ShardedIVFIndex)
        with pytest.raises(ValueError):
            TIndex(16, dtype="int4")


def test_sharded_ivf_pipelined(rng):
    idx = TIndex(dim=16, nlist=16, nprobe=16, train_threshold=64)
    idx.batch_flat_fallback = False
    vecs = _normed(rng, 512, 16)
    slots = idx.add_batch(vecs)
    idx.build()
    qs = vecs[:16].reshape(2, 8, 16)
    s3, i3 = idx.search_pipelined(qs, k=1)
    assert s3.shape == (2, 8, 1)
    np.testing.assert_array_equal(i3.reshape(-1), slots[:16])


def test_sharded_ivf_remesh_rebuilds(rng):
    idx = TIndex(16, nlist=8, nprobe=8, train_threshold=64)
    vecs = _normed(rng, 600, 16)
    idx.add_batch(vecs)
    idx.build()
    assert idx.is_trained
    idx.remesh(make_mesh(4, device="cpu"))
    assert idx.is_trained and len(idx._bucket_rows) == 4
    idx.batch_flat_fallback = False
    _, got = idx.search(vecs[:5], 1)
    assert (got.ravel() == np.arange(5)).all()


def test_sharded_ivf_int8_tables(rng):
    """int8 slabs keep int8 code tables + a scale table a shard."""
    idx = TIndex(dim=32, dtype="int8", nlist=16, nprobe=16,
                 train_threshold=64)
    idx.batch_flat_fallback = False
    vecs = _normed(rng, 1024, 32)
    slots = idx.add_batch(vecs)
    idx.build()
    assert all(t.dtype == torch.int8 for t in idx._bucket_rows)
    assert idx._bucket_scale is not None
    assert len(idx._bucket_rows) == idx.n_devices
    _, got = idx.search(vecs[:16], k=1)
    np.testing.assert_array_equal(got[:, 0], slots[:16])
    qs = vecs[:16].reshape(2, 8, 32)
    _, got3 = idx.search_pipelined(qs, k=1)
    np.testing.assert_array_equal(got3.reshape(-1), slots[:16])


# -- parity with the JAX ShardedIVFIndex ---------------------------------------
def jax_overlay(j) -> tuple[dict, dict]:
    """A JAX sharded IVF index's slot-order state and global tables."""
    slab, valid = j._host_slot_view()
    arrays = {"slab": slab, "valid": valid,
              "scales": np.asarray(j._scales).T.reshape(-1)}
    meta = dict(dim=j.dim, dtype=j.dtype_name, metric=j.metric, size=j._size,
                next_slot=j._next_slot, free=list(j._free), capacity=j._cap,
                nlist=j.nlist, nprobe=j.nprobe, built_size=j._built_size,
                residual_base=j._residual_base,
                quarantine=list(j._quarantine))
    if j.is_trained:
        arrays.update(
            centroids=np.asarray(j._centroids),
            bucket_slot=np.asarray(j._bucket_slot),
            bucket_valid=np.asarray(j._bucket_valid),
            bucket_rows=np.asarray(j._bucket_rows),
            residual=np.asarray(j._residual, np.int32),
        )
        if j._bucket_scale is not None:
            arrays["bucket_scale"] = np.asarray(j._bucket_scale)
    return arrays, meta


def carry(j, n_dev=8) -> ShardedIVFIndex:
    arrays, meta = jax_overlay(j)
    t = sharded_ivf_index_from_arrays(arrays, meta,
                                      make_mesh(n_dev, device="cpu"))
    t.batch_flat_fallback = j.batch_flat_fallback
    t.quota_slack = j.quota_slack
    return t


def _built(rng, dtype, n=2048, nlist=16, nprobe=4):
    j = JIndex(dim=32, dtype=dtype, nlist=nlist, nprobe=nprobe,
               train_threshold=256)
    j.add_batch(rng.standard_normal((n, 32)).astype(np.float32))
    j.build()
    j.batch_flat_fallback = False
    return j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_sharded_ivf_matches_jax(rng, dtype):
    """Same state in both packages: searches at k 1 / 10, the filter
    pushdown, the pipelined path, then adds (residual) and deletes
    (bucket invalidation) after the build, applied to both."""
    j = _built(rng, dtype)
    t = carry(j)
    tol = TOL[dtype]
    q = rng.standard_normal((37, 32)).astype(np.float32)
    for k in (1, 10):
        assert_topk_match(*j.search(q, k), *t.search(q, k), tol)
    mask = rng.random(j.capacity) > 0.5
    assert_topk_match(*j.search(q, 10, slot_mask=mask),
                      *t.search(q, 10, slot_mask=mask), tol)
    qs = q[:32].reshape(4, 8, 32)
    assert_topk_match(*j.search_pipelined(qs, 5), *t.search_pipelined(qs, 5),
                      tol)
    fresh = rng.standard_normal((25, 32)).astype(np.float32)
    np.testing.assert_array_equal(j.add_batch(fresh), t.add_batch(fresh))
    for ix in (j, t):
        ix.remove_slots(np.array([3, 4, 17, 2050]))
        ix.update_slots(np.array([9]), fresh[:1])
    assert sorted(j._residual) == sorted(t._residual)
    assert_topk_match(*j.search(q, 10), *t.search(q, 10), tol)
    assert_topk_match(*j.search(fresh, 3), *t.search(fresh, 3), tol)


def test_quota_overflow_drops_the_probes_jax_drops(rng):
    """nprobe 16 of 16 buckets and a quota slack of 0.5: each shard keeps
    ceil(B*P/8 * 0.5) of its 2*B*P/8 probes, the lowest-ranked drop. The
    port keeps exactly the slots JAX keeps (zero pad queries of the
    power-of-two batch take quota slots on both)."""
    j = _built(rng, "float32", nprobe=16)
    j.quota_slack = 0.5
    t = carry(j)
    q = rng.standard_normal((37, 32)).astype(np.float32)
    sj, ij = j.search(q, 10)
    st, it = t.search(q, 10)
    assert_topk_match(sj, ij, st, it, TOL["float32"])
    np.testing.assert_array_equal(np.sort(ij, 1), np.sort(it, 1))
    # the drop is real: without it the answers differ
    t.quota_slack = 8.0
    _, full = t.search(q, 10)
    assert (np.sort(full, 1) != np.sort(it, 1)).any()
    t.quota_slack = 0.5
    qs = q[:32].reshape(4, 8, 32)
    pj, pt = j.search_pipelined(qs, 10), t.search_pipelined(qs, 10)
    np.testing.assert_array_equal(np.sort(pj[1], -1), np.sort(pt[1], -1))


@pytest.mark.parametrize("n_dev", [8, 4])
def test_sharded_ivf_checkpoint_moves_both_ways(rng, temp_dir, n_dev):
    """npz checkpoints of the sharded IVF engine: JAX (8 shards) -> port
    (8 or 4 shards), and the port's back into JAX, the same answers."""
    j = _built(rng, "bfloat16")
    j.add_batch(rng.standard_normal((10, 32)).astype(np.float32))
    j.remove_slots(np.array([5, 6]))
    j.save(f"{temp_dir}/jax")
    t = TIndex(32, dtype="bfloat16", nlist=16,
               mesh=make_mesh(n_dev, device="cpu"))
    assert t.load(f"{temp_dir}/jax")
    assert t.is_trained and len(t._bucket_rows) == n_dev
    for ix in (j, t):
        ix.batch_flat_fallback = False
    q = rng.standard_normal((12, 32)).astype(np.float32)
    assert_topk_match(*j.search(q, 10), *t.search(q, 10), TOL["bfloat16"])
    t.save(f"{temp_dir}/port")
    j2 = JIndex(dim=32, dtype="bfloat16", nlist=16)
    assert j2.load(f"{temp_dir}/port")
    j2.batch_flat_fallback = False
    assert_topk_match(*j2.search(q, 10), *t.search(q, 10), TOL["bfloat16"])
