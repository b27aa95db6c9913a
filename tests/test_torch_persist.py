"""Checkpoints of the port's flat and sharded engines on the CPU.

``PERSIST_BACKEND=orbax`` in the port is ``store/persist.py``: one
``torch.save`` file a mesh position plus a JSON sidecar. The cases of
``tests/test_index.py::TestOrbaxPersistence`` run on it; a directory
that JAX's orbax wrote is refused with an error naming the difference.
npz checkpoints of ``ShardedFlatIndex`` move both ways between
``wdbx_tpu`` and ``wdbx_tpu_torch``, at 8 and at 4 shards (the sharded
IVF engine's are in ``tests/test_torch_sharded_ivf.py``). Hits agree
within 1e-5 (float32) or 2e-2 (bf16 / int8 / int4), slot sets equal
except at ties.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_ops import TOL, assert_topk_match
from wdbx_tpu.index import FlatIndex as JFlat
from wdbx_tpu.parallel import ShardedFlatIndex as JSharded
from wdbx_tpu_torch.core.config import WDBXConfig
from wdbx_tpu_torch.index.flat import FlatIndex
from wdbx_tpu_torch.parallel import ShardedFlatIndex, make_mesh
from wdbx_tpu_torch.parallel.mesh import MESH_SIZE_ENV
from wdbx_tpu_torch.store import persist

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def eight_shards(monkeypatch):
    monkeypatch.setenv(MESH_SIZE_ENV, "8")


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


class TestOrbaxPersistence:
    def test_flat_orbax_roundtrip(self, rng, temp_dir):
        idx = FlatIndex(dim=16, device="cpu")
        idx.persist_backend = "orbax"
        vecs = _normed(rng, 30, 16)
        slots = idx.add_batch(vecs)
        idx.remove_slots(slots[:2])
        idx.save(f"{temp_dir}/ob")
        assert persist.exists(f"{temp_dir}/ob")
        assert not os.path.exists(f"{temp_dir}/ob.npz")
        idx2 = FlatIndex(dim=16, device="cpu")
        assert idx2.load(f"{temp_dir}/ob")
        assert idx2.persist_backend == "orbax"
        assert idx2.count() == 28
        _, got = idx2.search(vecs[5], k=1)
        assert got[0, 0] == slots[5]
        _, got = idx2.search(vecs[0], k=28)
        assert slots[0] not in got[0]

    def test_sharded_orbax_roundtrip(self, rng, temp_dir):
        idx = ShardedFlatIndex(dim=16, device="cpu")
        idx.persist_backend = "orbax"
        vecs = _normed(rng, 40, 16)
        slots = idx.add_batch(vecs)
        idx.save(f"{temp_dir}/obs")
        assert len(os.listdir(f"{temp_dir}/obs.orbax")) == 8 + 1  # + sidecar
        idx2 = ShardedFlatIndex(dim=16, device="cpu")
        assert idx2.load(f"{temp_dir}/obs")
        _, got = idx2.search(vecs[:4], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[:4])

    @pytest.mark.parametrize("dtype", ["float32", "int4"])
    def test_sharded_clustered_orbax_roundtrip(self, rng, temp_dir, dtype):
        """The per-position files beside the ``.ivfsc`` overlay sidecar:
        the layout, its holes and its fresh rows come back."""
        from wdbx_tpu_torch.parallel import ShardedClusteredIndex

        kw = dict(dim=16, dtype=dtype, nlist=8, nprobe=8,
                  train_threshold=64, device="cpu")
        idx = ShardedClusteredIndex(**kw)
        idx.persist_backend = "orbax"
        vecs = _normed(rng, 500, 16)
        slots = idx.add_batch(vecs)
        idx.build()
        idx.remove_slots(slots[:6])
        fresh = idx.add_batch(_normed(rng, 4, 16))
        idx.save(f"{temp_dir}/obc")
        assert persist.exists(f"{temp_dir}/obc")
        assert not os.path.exists(f"{temp_dir}/obc.npz")
        assert os.path.exists(f"{temp_dir}/obc.ivfsc.npz")
        idx2 = ShardedClusteredIndex(**kw)
        idx2.batch_flat_fallback = idx.batch_flat_fallback = False
        assert idx2.load(f"{temp_dir}/obc")
        assert idx2.persist_backend == "orbax" and idx2.is_trained
        assert sorted(idx2._quar_flat()) == sorted(idx._quar_flat())
        assert idx2._residual == idx._residual
        q = np.concatenate([vecs[10:16], idx.get_vectors(fresh)])
        for a, b in zip(idx.search(q, 5), idx2.search(q, 5)):
            np.testing.assert_array_equal(a, b)

    def test_int8_orbax(self, rng, temp_dir):
        idx = FlatIndex(dim=16, dtype="int8", device="cpu")
        idx.persist_backend = "orbax"
        vecs = _normed(rng, 20, 16)
        slots = idx.add_batch(vecs)
        idx.save(f"{temp_dir}/obi")
        idx2 = FlatIndex(dim=16, dtype="int8", device="cpu")
        assert idx2.load(f"{temp_dir}/obi")
        _, got = idx2.search(vecs[:4], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[:4])


@pytest.mark.parametrize("dtype", ["int4", "bfloat16"])
def test_per_position_checkpoint_replicas_and_shard_counts(rng, temp_dir,
                                                           dtype):
    """A replicated index saves one file a shard and loads every copy;
    another shard count is refused (npz moves between counts)."""
    idx = ShardedFlatIndex(16, dtype=dtype, replicas=2, device="cpu")
    idx.persist_backend = "orbax"
    vecs = _normed(rng, 100, 16)
    slots = idx.add_batch(vecs)
    idx.remove_slots(slots[:3])
    idx.save(f"{temp_dir}/rep")
    assert len(os.listdir(f"{temp_dir}/rep.orbax")) == 4 + 1  # one a shard
    idx2 = ShardedFlatIndex(16, dtype=dtype, replicas=2, device="cpu")
    assert idx2.load(f"{temp_dir}/rep")
    q = vecs[3:11]
    assert_topk_match(*idx.search(q, 5), *idx2.search(q, 5), TOL[dtype])
    for p in range(idx2.mesh.size):
        assert torch.equal(idx2._slabs[p], idx._slabs[p])
    other = ShardedFlatIndex(16, dtype=dtype, device="cpu")  # 8 shards
    with pytest.raises(ValueError, match="npz"):
        other.load(f"{temp_dir}/rep")


def test_orbax_directory_from_jax_is_refused(rng, temp_dir):
    j = JFlat(dim=16)
    j.persist_backend = "orbax"
    j.add_batch(_normed(rng, 10, 16))
    j.save(f"{temp_dir}/jx")
    t = FlatIndex(dim=16, device="cpu")
    with pytest.raises(ValueError, match="npz"):
        t.load(f"{temp_dir}/jx")


def test_store_with_the_per_position_backend(rng, temp_dir):
    """PERSIST_BACKEND=orbax through the store: save, reopen, recover."""
    from wdbx_tpu_torch.store.vector_store import VectorStore

    cfg = {"VECTOR_DIMENSION": 8, "DATA_DIR": temp_dir,
           "INDEX_TYPE": "sharded_flat", "PERSIST_BACKEND": "orbax",
           "VECTOR_STORE_AUTOSAVE_INTERVAL": 0}
    store = VectorStore(WDBXConfig(cfg), device="cpu")
    vecs = {f"v{i}": rng.standard_normal(8).astype(np.float32)
            for i in range(50)}
    store.batch_store(vecs)
    store.save()
    again = VectorStore(WDBXConfig(cfg), device="cpu")
    assert again.count() == 50
    assert again.search(vecs["v7"], limit=1)[0][0] == "v7"
    again.indices[0].clear()
    assert again.recover(0)
    assert again.search(vecs["v9"], limit=1)[0][0] == "v9"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
@pytest.mark.parametrize("n_dev", [8, 4])
def test_sharded_flat_npz_moves_both_ways(rng, temp_dir, dtype, n_dev):
    """JAX (8 shards) -> port (8 or 4 shards) -> JAX: the npz slot-order
    layout carries the same rows, tombstones and free list."""
    j = JSharded(16, dtype=dtype)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    j.add_batch(x)
    j.remove_slots(np.array([0, 9, 200]))
    j.save(f"{temp_dir}/j")
    t = ShardedFlatIndex(16, dtype=dtype,
                         mesh=make_mesh(n_dev, device="cpu"))
    assert t.load(f"{temp_dir}/j")
    assert t.n_devices == n_dev and t.count() == j.count() == 297
    assert t._free == j._free and t._next_slot == j._next_slot
    q = rng.standard_normal((7, 16)).astype(np.float32)
    assert_topk_match(*j.search(q, 10), *t.search(q, 10), TOL[dtype])
    more = rng.standard_normal((5, 16)).astype(np.float32)
    np.testing.assert_array_equal(j.add_batch(more), t.add_batch(more))
    t.save(f"{temp_dir}/t")
    j2 = JSharded(16, dtype=dtype)
    assert j2.load(f"{temp_dir}/t")
    assert_topk_match(*j2.search(q, 10), *t.search(q, 10), TOL[dtype])
