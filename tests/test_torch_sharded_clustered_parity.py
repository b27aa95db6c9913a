"""Parity of the port's ShardedClusteredIndex with the JAX package's, on 8
logical CPU shards.

A JAX ``ShardedClusteredIndex`` is built on seeded numpy rows (its
k-means picks the layout), mutated (deletes into the quarantine, fresh
rows into the residual, an update that moves its row), and carried into
the port with ``convert.sharded_clustered_index_from_arrays``, so both
serve the same slabs, extents, centroids and residual list. Then every
search route runs through both: the kernel path (JAX's Pallas kernels in
interpret mode, the port's K3 / K4 plain version; v2 with bf16 and int8
queries, and v1), the exact-bucket-range scan, the portable block scan,
filter pushdown, the exact masked route and the pipelined stack, on
float32, int8 and int4 slabs. Scores agree within 1e-5 (float32) or
1e-4 (int8 / int4), slot sets agree except at ties, and -inf / -1 sit in
the same places. Batches are powers of two (JAX pads a batch to one, and
its pad rows' probes would add blocks the port does not scan). Then
``.ivfsc`` checkpoints move both ways between the packages.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_ops import assert_topk_match
from wdbx_tpu.parallel.sharded_clustered import ShardedClusteredIndex as JIndex
from wdbx_tpu_torch.convert import sharded_clustered_index_from_arrays
from wdbx_tpu_torch.parallel import ShardedClusteredIndex, make_mesh
from wdbx_tpu_torch.parallel.mesh import MESH_SIZE_ENV

torch.set_num_threads(2)

D = 32
TOL = {"float32": 1e-5, "int8": 1e-4, "int4": 1e-4}


@pytest.fixture(autouse=True)
def eight_shards(monkeypatch):
    monkeypatch.setenv(MESH_SIZE_ENV, "8")


def _normed(rng, n, d=D):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _jax_index(rng, dtype, n=1500, nlist=8, nprobe=3):
    j = JIndex(D, dtype=dtype, nlist=nlist, nprobe=nprobe,
               train_threshold=256)
    j.batch_flat_fallback = False
    db = _normed(rng, n, D)
    slots = j.add_batch(db)
    j.build()
    j.remove_slots(slots[:12])  # quarantined holes
    j.update_slots(slots[20:22], _normed(rng, 2))  # moved rows
    j.add_batch(_normed(rng, 9))  # the residual
    return j, db, slots


def _carry(j, mesh=None):
    """The JAX index's state, through convert, onto a port mesh."""
    arrays = {
        "slab": np.asarray(j._slab), "valid": np.asarray(j._valid),
        "slot_of": j._slot_of,
        "residual": np.asarray(j._residual, np.int64),
    }
    if j._is_quantized:
        arrays["scales"] = np.asarray(j._scales)
    if j.is_trained:
        arrays["centroids"] = np.asarray(j._centroids)
        arrays["local_counts"] = j._local_counts
    meta = {
        "dim": j.dim, "dtype": j.dtype_name, "metric": j.metric,
        "size": j._size, "next_slot": j._next_slot, "free": list(j._free),
        "capacity": j._cap, "nlist": j.nlist, "nprobe": j.nprobe,
        "trained": j.is_trained, "built_size": j._built_size,
        "residual_base": j._residual_base,
        "next_ext_slot": j._next_ext_slot,
        "free_slots": list(j._free_slots),
        "pos_quarantine": j._quar_flat(), "block_rows": j._c,
        "fresh_base": j._fresh_base,
    }
    t = sharded_clustered_index_from_arrays(
        arrays, meta, mesh or make_mesh(8, device="cpu"))
    t.batch_flat_fallback = False
    return t


def _same(jres, tres, dtype):
    assert tres[1].dtype == np.int64
    assert_topk_match(*jres, *tres, TOL[dtype])


def _route(j, t, **knobs):
    for ix in (j, t):
        for key, value in knobs.items():
            setattr(ix, key, value)


@pytest.mark.parametrize("dtype", ["float32", "int8", "int4"])
def test_carried_state_matches(rng, dtype):
    j, db, slots = _jax_index(rng, dtype)
    t = _carry(j)
    assert t.is_trained and t.count() == j.count()
    assert t._c == j._c and t._m == j._m
    np.testing.assert_array_equal(t._local_counts, j._local_counts)
    np.testing.assert_array_equal(t._slot_of, j._slot_of)
    np.testing.assert_array_equal(t._pos_of, j._pos_of)
    assert sorted(t._quar_flat()) == sorted(j._quar_flat())
    assert t._residual == [int(p) for p in j._residual]
    probe = slots[30:40]
    np.testing.assert_allclose(t.get_vectors(probe), j.get_vectors(probe),
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "int8", "int4"])
@pytest.mark.parametrize("route", ["kernel", "lax", "ranges"])
def test_search_routes_match_jax(rng, dtype, route):
    j, db, slots = _jax_index(rng, dtype)
    t = _carry(j)
    knobs = {"kernel": dict(ivf_kernel="pallas", latency_path="wide"),
             "lax": dict(ivf_kernel="lax", latency_path="wide"),
             "ranges": dict(ivf_kernel="pallas", latency_path="ranges")}
    _route(j, t, **knobs[route])
    for b, k in ((8, 10), (1, 5), (4, 1)):
        q = np.concatenate([db[40:40 + b // 2], _normed(rng, b - b // 2)])
        _same(j.search(q, k), t.search(q, k), dtype)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_int8_queries_and_v1_match_jax(rng, dtype):
    """v2 with IVF_KERNEL_QPREC=int8 queries; v1 (int8 slabs only: int4
    takes v2 in both packages)."""
    j, db, _ = _jax_index(rng, dtype)
    t = _carry(j)
    _route(j, t, ivf_kernel="pallas", latency_path="wide",
           kernel_qprec="int8")
    q = _normed(rng, 8)
    _same(j.search(q, 10), t.search(q, 10), dtype)
    _route(j, t, kernel_qprec="bf16", kernel_version="v1")
    assert t._kernel_gen() == j._kernel_gen()
    _same(j.search(q, 10), t.search(q, 10), dtype)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_filters_match_jax(rng, dtype):
    """Pushdown above the 2% threshold (the mask ANDed into each
    shard's validity, nprobe boosted), the exact masked route below."""
    j, db, slots = _jax_index(rng, dtype)
    t = _carry(j)
    _route(j, t, ivf_kernel="pallas", latency_path="wide")
    q = _normed(rng, 8)
    wide = np.zeros(j.capacity, bool)
    wide[slots[rng.random(len(slots)) < 0.3]] = True
    sparse = np.zeros(j.capacity, bool)
    sparse[slots[::100]] = True
    for mask in (wide, sparse):
        _same(j.search(q, 10, slot_mask=mask),
              t.search(q, 10, slot_mask=mask), dtype)
    _route(j, t, ivf_kernel="lax")
    _same(j.search(q, 10, slot_mask=wide), t.search(q, 10, slot_mask=wide),
          dtype)


@pytest.mark.parametrize("dtype", ["float32", "int4"])
def test_pipelined_matches_jax(rng, dtype):
    j, db, _ = _jax_index(rng, dtype)
    t = _carry(j)
    _route(j, t, ivf_kernel="pallas", latency_path="wide")
    qs = np.stack([_normed(rng, 4) for _ in range(3)])
    _same(j.search_pipelined(qs, 6), t.search_pipelined(qs, 6), dtype)
    handle = t.search_pipelined(qs, 6, materialize=False)
    _same(j.search_pipelined(qs, 6), t.resolve_pipelined(handle), dtype)


def test_replicas_match_jax(rng):
    """A 2 x 4 (replica, shard) mesh: each group serves its slice."""
    from wdbx_tpu.parallel import make_mesh2 as jmesh2
    from wdbx_tpu_torch.parallel import make_mesh2

    j = JIndex(D, nlist=8, nprobe=3, train_threshold=256, replicas=2,
               mesh=jmesh2(2, 4))
    j.batch_flat_fallback = False
    db = _normed(rng, 900)
    j.add_batch(db)
    j.build()
    j.add_batch(_normed(rng, 5))
    t = _carry(j, make_mesh2(2, 4, device="cpu"))
    assert t.replicas == 2 and t.n_devices == 4
    _route(j, t, ivf_kernel="pallas", latency_path="wide")
    q = _normed(rng, 8)
    _same(j.search(q, 10), t.search(q, 10), "float32")


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_checkpoints_move_both_ways(rng, dtype, temp_dir):
    """A JAX ``.ivfsc`` checkpoint loads in the port and the port's in
    JAX, with the same answers."""
    j, db, slots = _jax_index(rng, dtype)
    j.latency_path = "wide"
    q = _normed(rng, 8)
    jpath = os.path.join(temp_dir, "from_jax")
    j.save(jpath)
    t = ShardedClusteredIndex(D, dtype=dtype, nlist=8, device="cpu")
    assert t.load(jpath)
    t.batch_flat_fallback = False
    _route(j, t, ivf_kernel="pallas", latency_path="wide")
    assert t.is_trained and t.count() == j.count()
    assert sorted(t._quar_flat()) == sorted(j._quar_flat())
    _same(j.search(q, 10), t.search(q, 10), dtype)
    fresh = _normed(rng, 3)
    new = t.add_batch(fresh)
    tpath = os.path.join(temp_dir, "from_port")
    t.save(tpath)
    j2 = JIndex(D, dtype=dtype, nlist=8, train_threshold=256)
    assert j2.load(tpath)
    j2.batch_flat_fallback = False
    _route(j2, t, ivf_kernel="pallas")
    assert j2.count() == t.count()
    _same(j2.search(q, 10), t.search(q, 10), dtype)
    _, got = j2.search(fresh, 1)
    np.testing.assert_array_equal(got.ravel(), new)
