"""Parity of the port's store and facade with wdbx_tpu's, on the CPU.

``WDBX(enable_plugins=False)`` of both packages (the port's with
``device="cpu"``) goes through bulk loads with metadata columns, plain
and filtered batch searches, delete and update, the int8 / int4 raw-store
rerank, pipelined submit / resolve, and save + reload, including a
data_dir saved by one package and served by the other. Hits must name
the same ids (except at ties) with the same scores and metadata.
"""

import glob

import numpy as np
import pytest
import torch

from wdbx_tpu.core.wdbx import WDBX as JWDBX
from wdbx_tpu_torch.core.wdbx import WDBX as TWDBX

torch.set_num_threads(2)

DIM = 16
TOLS = {"float32": 1e-5, "bfloat16": 2e-2, "int8": 1e-5, "int4": 1e-5}
# int8 / int4 hits are rescored exactly from the raw store (RAW_STORE=ram)
CONFIGS = {
    "float32": {"INDEX_DTYPE": "float32"},
    "bfloat16": {"INDEX_DTYPE": "bfloat16"},
    "int8": {"INDEX_DTYPE": "int8", "RAW_STORE": "ram"},
    "int4": {"INDEX_DTYPE": "int4", "RAW_STORE": "ram"},
}


def _open(pkg, path, dtype):
    cfg = dict(CONFIGS[dtype], VECTOR_STORE_AUTOSAVE_INTERVAL=0)
    kw = {"device": "cpu"} if pkg is TWDBX else {}
    return pkg(vector_dimension=DIM, num_shards=2, data_dir=str(path),
               config=cfg, enable_plugins=False, **kw)


def _same_hits(ref, got, tol):
    assert len(ref) == len(got)
    for rq, gq in zip(ref, got):
        assert len(rq) == len(gq)
        np.testing.assert_allclose([h[1] for h in gq], [h[1] for h in rq],
                                   atol=tol, rtol=0)
        rs = {h[0]: h for h in rq}
        gs = {h[0]: h for h in gq}
        edge = min(h[1] for h in rq) if rq else 0.0
        for vid in set(rs) ^ set(gs):  # only ties at the last rank differ
            h = rs.get(vid) or gs.get(vid)
            assert abs(h[1] - edge) <= tol, vid
        for vid in set(rs) & set(gs):
            assert rs[vid][2] == gs[vid][2]


def _load(dbs, rng, n=200):
    ids = [f"v{i}" for i in range(n)]
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    cols = {"tag": np.arange(n) % 3, "n": np.arange(n)}
    for db in dbs:
        assert db.store.bulk_load(ids, x, cols) == n
    return ids, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_facade_matches_through_mutations(tmp_path, rng, dtype):
    j = _open(JWDBX, tmp_path / "j", dtype)
    t = _open(TWDBX, tmp_path / "t", dtype)
    ids, x = _load((j, t), rng)
    tol = TOLS[dtype]
    q = rng.standard_normal((4, DIM)).astype(np.float32)
    for flt in (None, {"tag": 1}, {"n": {"$gt": 150}}):
        _same_hits(j.vector_search_batch(q, limit=5, filter_metadata=flt),
                   t.vector_search_batch(q, limit=5, filter_metadata=flt),
                   tol)
    for db in (j, t):
        for vid in ids[:5]:
            assert db.delete_vector(vid)
        db.batch_store({ids[7]: x[0] * 2, ids[8]: -x[1]},
                       {ids[7]: {"tag": 9}, ids[8]: {"tag": 9}})
    assert j.count_vectors() == t.count_vectors() == 195
    _same_hits(j.vector_search_batch(x[:3], limit=5),
               t.vector_search_batch(x[:3], limit=5), tol)
    _same_hits([j.vector_search(x[0].tolist(), limit=4,
                                filter_metadata={"tag": 9})],
               [t.vector_search(x[0].tolist(), limit=4,
                                filter_metadata={"tag": 9})], tol)
    hj = j.store.search_batch_resolve(j.store.search_batch_submit(q, limit=5))
    ht = t.store.search_batch_resolve(t.store.search_batch_submit(q, limit=5))
    _same_hits(hj, ht, tol)
    assert t.get_vector(ids[9])[1] == j.get_vector(ids[9])[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax",
                                       "torch_to_torch"])
def test_saved_store_reloads_across_packages(tmp_path, rng, dtype, direction):
    src_pkg = JWDBX if direction == "jax_to_torch" else TWDBX
    dst_pkg = JWDBX if direction == "torch_to_jax" else TWDBX
    src = _open(src_pkg, tmp_path / "d", dtype)
    ids, x = _load((src,), rng, n=120)
    src.delete_vector(ids[3])
    src.update_metadata(ids[4], {"tag": 7})
    q = rng.standard_normal((3, DIM)).astype(np.float32)
    before = src.vector_search_batch(q, limit=6)
    src.store.save()
    del src
    dst = _open(dst_pkg, tmp_path / "d", dtype)
    assert dst.count_vectors() == 119
    _same_hits(before, dst.vector_search_batch(q, limit=6), TOLS[dtype])
    assert dst.get_vector(ids[4])[1]["tag"] == 7
    assert dst.get_vector(ids[3]) is None


def test_unported_surfaces_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="slice 3"):
        TWDBX(vector_dimension=DIM, data_dir=str(tmp_path / "a"),
              device="cpu")
    with pytest.raises(NotImplementedError, match="slice 5"):
        TWDBX(vector_dimension=DIM, data_dir=str(tmp_path / "b"),
              enable_plugins=False, enable_distributed=True, device="cpu")
    db = TWDBX(vector_dimension=DIM, data_dir=str(tmp_path / "c"),
               enable_plugins=False, device="cpu")
    with pytest.raises(NotImplementedError, match="slice 5"):
        db.heal()
    assert db.store.verify()["consistent"]


@pytest.mark.parametrize("kind,slice_", [
    ("ivf", None), ("hnsw", None), ("ivf_clustered", None),
    ("ivf_dense", None), ("sharded_flat", "slice 5"),
])
def test_index_types_through_the_facade(tmp_path, kind, slice_):
    """The clustered aliases serve through the port's ClusteredIVFIndex
    and ``ivf_dense`` through its dense IVFIndex; the sharded engines
    raise, naming their slice."""
    from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex
    from wdbx_tpu_torch.index.ivf import IVFIndex

    kw = dict(vector_dimension=DIM, data_dir=str(tmp_path / kind),
              enable_plugins=False, device="cpu",
              config={"INDEX_TYPE": kind})
    if slice_ is not None:
        with pytest.raises(NotImplementedError, match=slice_):
            TWDBX(**kw)
        return
    db = TWDBX(**kw)
    want = IVFIndex if kind == "ivf_dense" else ClusteredIVFIndex
    assert all(type(ix) is want for ix in db.store.indices)
    assert db.store.verify()["consistent"]


async def test_async_twins_match_sync(tmp_path, rng):
    db = _open(TWDBX, tmp_path / "s", "float32")
    vid = await db.vector_store_async(rng.standard_normal(DIM).tolist(),
                                      {"a": 1}, id="x")
    hits = await db.vector_search_async(db.get_vector(vid)[0], limit=1)
    assert hits[0][0] == "x" and hits[0][2] == {"a": 1}
    assert await db.delete_vector_async("x")
    assert db.count_vectors() == 0


@pytest.mark.parametrize("dtype,raw", [("int8", "float32"), ("int4", "int8")])
def test_slab_external_checkpoint_restores_in_the_port(tmp_path, rng, dtype,
                                                       raw):
    """A quantized store saved by wdbx_tpu without its slab (rebuilt at
    load from the memmap raw store) serves the same hits in the port."""
    cfg = {"INDEX_DTYPE": dtype, "RAW_STORE": "memmap",
           "RAW_STORE_DTYPE": raw, "VECTOR_STORE_AUTOSAVE_INTERVAL": 0}
    kw = dict(vector_dimension=DIM, num_shards=2, data_dir=str(tmp_path),
              config=cfg, enable_plugins=False)
    src = JWDBX(**kw)
    ids, _ = _load((src,), rng, n=150)
    src.delete_vector(ids[2])
    q = rng.standard_normal((4, DIM)).astype(np.float32)
    before = src.vector_search_batch(q, limit=5)
    src.store.save()
    [npz] = glob.glob(str(tmp_path / "checkpoint" / "g*" / "indices"
                          / "shard_0.npz"))
    assert "slab" not in np.load(npz).keys()
    del src
    dst = TWDBX(device="cpu", **kw)
    assert dst.count_vectors() == 149
    _same_hits(before, dst.vector_search_batch(q, limit=5), 2e-2)
    assert not dst.store.indices[0]._slab_restore_pending


def test_warm_serves_one_batch_and_changes_nothing(tmp_path, rng):
    db = _open(TWDBX, tmp_path / "db", "float32")
    assert db.store.warm() == 0  # empty store: nothing to serve
    _load((db,), rng, n=50)
    q = rng.standard_normal((3, DIM)).astype(np.float32)
    before = db.vector_search_batch(q, limit=5)
    assert db.store.warm(max_batch=100, limit=5) == 1
    assert db.count_vectors() == 50
    assert db.vector_search_batch(q, limit=5) == before


def test_trace_writes_a_chrome_trace(tmp_path, rng):
    from wdbx_tpu_torch.utils.metrics import trace

    db = _open(TWDBX, tmp_path / "db", "float32")
    _load((db,), rng, n=20)
    with trace(str(tmp_path / "t")) as d:
        db.vector_search_batch(rng.standard_normal((2, DIM)), limit=3)
    with open(f"{d}/trace.json") as f:
        assert "traceEvents" in f.read()
