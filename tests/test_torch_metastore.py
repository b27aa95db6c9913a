"""The cases of ``tests/test_metastore.py`` on the port, on the CPU.

A translated copy of that file: the same classes, functions,
parametrisations and asserts, run on ``wdbx_tpu_torch``. Each
``wdbx_tpu`` import names its ``wdbx_tpu_torch`` counterpart; the
autouse fixture asks for the CPU through
``test_torch_ops.port_on_cpu`` (the default device and mesh of one
test), so the package keeps the card as its own default.

Translated, every case (43 cases):
test_meta_set_get_drop_roundtrip; test_meta_kind_promotion;
test_meta_mask_matches_reference_semantics;
test_meta_mask_obj_column_cmp; test_meta_mask_obj_column_in_nin;
test_meta_get_lockfree_vs_column_inserts;
test_meta_set_columns_bulk_and_mask_speed_shape;
test_meta_persistence_roundtrip; test_meta_remap;
test_rawstore_roundtrip; test_rawstore_ram_backend_roundtrip;
test_rawstore_remap; test_rawstore_persisted_dtype_wins;
test_rawstore_read_lockfree_vs_grow; test_store_bulk_load_and_filter;
test_store_legacy_blob_ingestion;
test_store_rerank_rides_rawstore_not_dict;
test_store_rerank_disabled_without_rawstore;
test_store_save_keeps_legacy_raw_when_rawstore_disabled;
test_store_bulk_load_rejects_duplicate_ids_in_batch;
test_store_compact_remaps_sidecars.

Changed beyond the imports and the fixture: nothing. Left out: nothing.

The reference file's description:

Columnar metadata + memmap raw store (round-4 store-scale layer).

Covers the two sidecars the store now keeps per shard:
  * ColumnarMetadata — typed columns, kind promotion, vectorized filter
    masks matching the reference operator semantics (reference
    wdbx/core/vector_store.py:414-463), persistence, slot remap;
  * RawStore — slot-indexed memmap raws, precision tiers, legacy
    raw.npz / metadata.json ingestion, re-rank routing without the
    per-id dict (VERDICT r3 ask #1).
"""

import json
import os

import numpy as np
import pytest

from wdbx_tpu_torch.core.config import WDBXConfig
from wdbx_tpu_torch.store.filters import matches_filter
from wdbx_tpu_torch.store.metastore import ColumnarMetadata
from wdbx_tpu_torch.store.rawstore import RawStore
from wdbx_tpu_torch.store.vector_store import VectorStore
from test_torch_ops import port_on_cpu


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    port_on_cpu(monkeypatch)


# ---------------------------------------------------------------- metadata
def test_meta_set_get_drop_roundtrip():
    m = ColumnarMetadata(1)
    m.set(0, 3, {"a": 1, "b": "x", "c": 2.5, "d": True, "e": [1, 2]})
    got = m.get(0, 3)
    assert got == {"a": 1, "b": "x", "c": 2.5, "d": True, "e": [1, 2]}
    # exact python types round-trip (not numpy scalars / floatified ints)
    assert type(got["a"]) is int and type(got["c"]) is float
    assert type(got["d"]) is bool and type(got["b"]) is str
    assert m.get(0, 4) is None
    assert m.count() == 1
    # overwrite replaces the whole dict (old keys vanish)
    m.set(0, 3, {"z": 9})
    assert m.get(0, 3) == {"z": 9}
    m.drop(0, 3)
    assert m.get(0, 3) is None and m.count() == 0


def test_meta_kind_promotion():
    m = ColumnarMetadata(1)
    m.set(0, 0, {"k": 1})
    m.set(0, 1, {"k": 2.5})          # int -> float promotion
    assert m.get(0, 0)["k"] == 1.0
    assert m.get(0, 1)["k"] == 2.5
    m.set(0, 2, {"k": "mixed"})      # float -> obj demotion
    assert m.get(0, 0)["k"] == 1.0
    assert m.get(0, 2)["k"] == "mixed"
    # strings widen in place
    m.set(0, 3, {"s": "ab"})
    m.set(0, 4, {"s": "a" * 40})
    assert m.get(0, 3)["s"] == "ab"
    assert m.get(0, 4)["s"] == "a" * 40


@pytest.mark.parametrize("flt", [
    {"n": {"$gt": 5}},
    {"n": {"$gte": 5}},
    {"n": {"$lt": 5}},
    {"n": {"$lte": 5}},
    {"n": {"$in": [2, 4, 6]}},
    {"n": {"$nin": [2, 4, 6]}},
    {"n": {"$exists": True}},
    {"m": {"$exists": False}},
    {"n": 4},
    {"s": "cat3"},
    {"s": {"$in": ["cat1", "cat9"]}},
    {"n": {"$gt": 2, "$lt": 7}},
    {"n": {"$gt": 2}, "s": "cat1"},
    {"missing_key": 1},
    {"missing_key": {"$exists": False}},
    {"n": {"$gt": "not_a_number"}},
    # mixed-type $in/$nin: np.asarray promotion must not kill matches
    # (review r4 finding: ['a', 4] promoted to unicode -> zero matches)
    {"n": {"$in": ["a", 4]}},
    {"n": {"$nin": ["a", 4]}},
    {"s": {"$in": ["cat1", 3]}},
    {"n": {"$in": []}},
    {"n": {"$in": [4.0, 6]}},
])
def test_meta_mask_matches_reference_semantics(flt):
    """The vectorized mask must agree with the scalar matcher row by
    row for every operator (the scalar matcher IS reference parity)."""
    m = ColumnarMetadata(1)
    metas = []
    for i in range(40):
        meta = {"n": i % 10, "s": f"cat{i % 5}"}
        if i % 3 == 0:
            meta["m"] = "only_sometimes"
        if i % 7 == 0:
            meta.pop("n")
        metas.append(meta)
        m.set(0, i, meta)
    mask = m.mask(0, flt, 64)
    assert mask.shape == (64,)
    for i in range(40):
        assert mask[i] == matches_filter(metas[i], flt), (i, metas[i])
    # slots the metadata never reached carry the empty-row verdict
    # (reference evaluates metadata.get(id, {}) — a live row stored
    # without metadata must match e.g. $exists: False); the index ANDs
    # its own validity so dead slots can't surface
    assert (mask[40:] == matches_filter({}, flt)).all()


def test_meta_mask_obj_column_cmp():
    """Object columns (mixed types) compare with TypeError-as-False."""
    m = ColumnarMetadata(1)
    m.set(0, 0, {"k": 3})
    m.set(0, 1, {"k": "three"})
    m.set(0, 2, {"k": 7})
    mask = m.mask(0, {"k": {"$gt": 4}}, 8)
    assert mask.tolist()[:3] == [False, False, True]
    mask = m.mask(0, {"k": "three"}, 8)
    assert mask.tolist()[:3] == [False, True, False]


def test_meta_mask_obj_column_in_nin():
    """$in/$nin on an object (mixed-type) column uses Python equality
    per element — np.isin's sort kernel would raise or mismatch."""
    m = ColumnarMetadata(1)
    metas = [{"k": 3}, {"k": "three"}, {"k": 7}, {"k": (1, 2)}]
    for i, meta in enumerate(metas):
        m.set(0, i, meta)
    for flt in ({"k": {"$in": [3, "three"]}}, {"k": {"$nin": [7]}}):
        mask = m.mask(0, flt, 8)
        for i, meta in enumerate(metas):
            assert mask[i] == matches_filter(meta, flt), (i, flt)


def test_meta_get_lockfree_vs_column_inserts():
    """get() races writers that insert first-seen columns and grow the
    arrays (the search merge reads lock-free under epoch retry); it must
    never crash (review r4 finding: dict-changed-size RuntimeError)."""
    import threading

    m = ColumnarMetadata(1)
    m.set(0, 0, {"base": 1})
    stop = threading.Event()
    errors: list[Exception] = []

    def reader():
        while not stop.is_set():
            try:
                got = m.get(0, 0)
                assert got is None or isinstance(got, dict)
            except Exception as e:  # noqa: BLE001 — no-crash IS the test
                errors.append(e)
                return

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    for i in range(1, 3000):
        m.set(0, (i % 599) + 1, {"base": 2, f"k{i}": i})
    stop.set()
    for t in threads:
        t.join()
    assert not errors, errors[0]


def test_meta_set_columns_bulk_and_mask_speed_shape():
    m = ColumnarMetadata(1)
    n = 10_000
    slots = np.arange(n)
    m.set_columns(0, slots, {
        "cat": np.asarray([f"c{i % 7}" for i in range(n)]),
        "score": np.arange(n, dtype=np.float64),
    })
    assert m.count() == n
    assert m.get(0, 123) == {"cat": "c4", "score": 123.0}
    mask = m.mask(0, {"cat": "c3", "score": {"$lt": 70}}, n)
    expect = np.zeros(n, bool)
    for i in range(n):
        expect[i] = (i % 7 == 3) and (i < 70)
    assert (mask == expect).all()


def test_meta_persistence_roundtrip(tmp_path):
    m = ColumnarMetadata(2)
    m.set(0, 0, {"a": 1, "s": "x", "o": {"nested": True}})
    m.set(0, 5, {"a": 2, "f": 1.5})
    m.set(1, 1, {"b": False})
    m.save(str(tmp_path))
    m2 = ColumnarMetadata(2)
    assert m2.load(str(tmp_path))
    assert m2.get(0, 0) == {"a": 1, "s": "x", "o": {"nested": True}}
    assert m2.get(0, 5) == {"a": 2, "f": 1.5}
    assert m2.get(1, 1) == {"b": False}
    assert m2.count() == 3
    assert m2.get(0, 1) is None


def test_meta_remap():
    m = ColumnarMetadata(1)
    for i in range(6):
        m.set(0, i, {"v": i})
    # compaction-style remap: live slots [1,3,5] -> [0,1,2]
    m.remap(0, np.asarray([1, 3, 5]), np.asarray([0, 1, 2]))
    assert m.get(0, 0) == {"v": 1}
    assert m.get(0, 2) == {"v": 5}
    assert m.get(0, 4) is None and m.count() == 3


# ---------------------------------------------------------------- rawstore
@pytest.mark.parametrize("dtype,atol", [
    ("float32", 0.0), ("float16", 2e-3), ("int8", 2e-2),
])
def test_rawstore_roundtrip(tmp_path, dtype, atol):
    rs = RawStore(str(tmp_path), 1, 8, dtype=dtype)
    rows = np.random.default_rng(0).standard_normal((5, 8)).astype(np.float32)
    rs.write(0, np.asarray([0, 3, 7, 100, 2000]), rows)
    got, have = rs.read(0, np.asarray([3, 7, 1, 2000, -1]))
    assert have.tolist() == [True, True, False, True, False]
    np.testing.assert_allclose(got[0], rows[1], atol=atol, rtol=atol)
    np.testing.assert_allclose(got[3], rows[4], atol=atol, rtol=atol)
    assert (got[2] == 0).all()
    rs.drop(0, np.asarray([3]))
    _, have = rs.read(0, np.asarray([3]))
    assert not have[0]
    # persistence: the memmap IS the format
    rs.flush()
    rs2 = RawStore(str(tmp_path), 1, 8, dtype=dtype)
    got, have = rs2.read(0, np.asarray([7, 2000]))
    assert have.all()
    np.testing.assert_allclose(got[1], rows[4], atol=atol, rtol=atol)


def test_rawstore_ram_backend_roundtrip(tmp_path):
    rs = RawStore(str(tmp_path), 1, 8, dtype="int8", backend="ram")
    rows = np.random.default_rng(3).standard_normal((4, 8)).astype(np.float32)
    rs.write(0, np.asarray([1, 2, 3, 4]), rows)
    got, have = rs.read(0, np.asarray([2]))
    assert have[0]
    np.testing.assert_allclose(got[0], rows[1], atol=2e-2)
    rs.flush()  # ram backend serializes only here
    rs2 = RawStore(str(tmp_path), 1, 8, backend="mmap")  # cross-backend
    assert rs2.dtype_name == "int8"
    got, have = rs2.read(0, np.asarray([4]))
    assert have[0]
    np.testing.assert_allclose(got[0], rows[3], atol=2e-2)


def test_rawstore_remap(tmp_path):
    rs = RawStore(str(tmp_path), 1, 4)
    rows = np.eye(4, dtype=np.float32)
    rs.write(0, np.asarray([2, 5, 9, 11]), rows)
    rs.remap(0, np.asarray([2, 5, 9, 11]), np.asarray([0, 1, 2, 3]))
    got, have = rs.read(0, np.asarray([0, 1, 2, 3, 5]))
    assert have.tolist() == [True] * 4 + [False]
    np.testing.assert_array_equal(got[:4], rows)


def test_rawstore_persisted_dtype_wins(tmp_path):
    rs = RawStore(str(tmp_path), 1, 4, dtype="int8")
    rs.write(0, np.asarray([0]), np.ones((1, 4), np.float32))
    rs.flush()
    rs2 = RawStore(str(tmp_path), 1, 4, dtype="float32")
    assert rs2.dtype_name == "int8"  # bytes must not be reinterpreted
    got, have = rs2.read(0, np.asarray([0]))
    assert have[0]
    np.testing.assert_allclose(got[0], np.ones(4), atol=2e-2)


def test_rawstore_read_lockfree_vs_grow(tmp_path):
    """read() races a writer growing the shard (the re-rank path reads
    lock-free); views must never be nulled mid-resize (review r4
    finding: NoneType subscript crash)."""
    import threading

    rs = RawStore(str(tmp_path), 1, 8)
    rows = np.ones((1, 8), np.float32)
    rs.write(0, np.asarray([0]), rows)
    stop = threading.Event()
    errors: list[Exception] = []

    def reader():
        while not stop.is_set():
            try:
                got, have = rs.read(0, np.asarray([0]))
                assert have[0] and got.shape == (1, 8)
            except Exception as e:  # noqa: BLE001 — no-crash IS the test
                errors.append(e)
                return

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    # each write doubles capacity several times -> many grow windows
    for hi in (100, 1000, 10_000, 60_000, 200_000):
        rs.write(0, np.asarray([hi]), rows)
    stop.set()
    for t in threads:
        t.join()
    assert not errors, errors[0]


# ------------------------------------------------------- store integration
def _store(tmp_path, **over):
    cfg = {"VECTOR_DIMENSION": 8, "DATA_DIR": str(tmp_path),
           "VECTOR_STORE_AUTOSAVE_INTERVAL": 0}
    cfg.update(over)
    return VectorStore(WDBXConfig(cfg))


def test_store_bulk_load_and_filter(tmp_path):
    s = _store(tmp_path, NUM_SHARDS=2)
    n = 500
    rng = np.random.default_rng(1)
    vecs = rng.standard_normal((n, 8)).astype(np.float32)
    ids = [f"v{i}" for i in range(n)]
    s.bulk_load(ids, vecs, metadata_columns={
        "i": np.arange(n), "cat": [f"c{i % 3}" for i in range(n)],
    })
    assert s.count() == n
    got = s.get("v42")
    assert got is not None
    np.testing.assert_allclose(got[0], vecs[42], atol=1e-6)
    assert got[1] == {"i": 42, "cat": "c0"}
    hits = s.search(vecs[7], limit=3, filter_metadata={"cat": "c1"})
    assert hits and all(h[2]["cat"] == "c1" for h in hits)
    with pytest.raises(ValueError, match="insert-only"):
        s.bulk_load(["v0"], vecs[:1])
    # restart-resume with the columnar + memmap persistence
    s.save()
    s2 = _store(tmp_path, NUM_SHARDS=2)
    assert s2.count() == n
    got = s2.get("v42")
    np.testing.assert_allclose(got[0], vecs[42], atol=1e-6)
    assert got[1] == {"i": 42, "cat": "c0"}


def test_store_legacy_blob_ingestion(tmp_path):
    """A reference-format data_dir (one-blob metadata.json + raw.npz)
    loads into the columnar/memmap stores transparently."""
    s = _store(tmp_path)
    s.store("a", np.arange(8, dtype=np.float32), {"k": 1})
    s.store("b", -np.arange(8, dtype=np.float32), {"k": 2})
    s.save()
    # rewrite persistence in the LEGACY formats
    meta_dir = os.path.join(str(tmp_path), "metadata")
    for f in os.listdir(meta_dir):
        if f.startswith("columns_shard"):
            os.remove(os.path.join(meta_dir, f))
    with open(os.path.join(meta_dir, "metadata.json"), "w") as f:
        json.dump({"a": {"k": 1}, "b": {"k": 2}}, f)
    vec_dir = os.path.join(str(tmp_path), "vectors")
    for f in os.listdir(vec_dir):
        if f.startswith("raw_"):
            os.remove(os.path.join(vec_dir, f))
    np.savez(
        os.path.join(vec_dir, "raw.npz"),
        ids=np.asarray(["a", "b"], dtype=np.str_),
        vectors=np.stack([np.arange(8, dtype=np.float32),
                          -np.arange(8, dtype=np.float32)]),
    )
    s2 = _store(tmp_path)
    got = s2.get("a")
    np.testing.assert_allclose(got[0], np.arange(8), atol=1e-6)
    assert got[1] == {"k": 1}
    assert s2.get("b")[1] == {"k": 2}


def test_store_rerank_rides_rawstore_not_dict(tmp_path):
    """RERANK=auto must work with ONLY the memmap raw store (no per-id
    dict exists anymore) — the int4/int8 recall-protection path at the
    capacity tier (VERDICT r3 ask #1)."""
    s = _store(tmp_path, INDEX_TYPE="flat", INDEX_DTYPE="int8",
               RAW_STORE_DTYPE="float32")
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((256, 8)).astype(np.float32)
    s.bulk_load([f"v{i}" for i in range(256)], vecs)
    assert s._rerank_enabled()
    q = vecs[13]
    hits = s.search(q, limit=5)
    assert hits[0][0] == "v13"
    # the top score must be the EXACT f32 cosine (re-ranked), not the
    # int8-quantized one
    qn = q / np.linalg.norm(q)
    assert abs(hits[0][1] - 1.0) < 1e-5 or abs(
        hits[0][1] - float(qn @ qn)
    ) < 1e-5


def test_store_rerank_disabled_without_rawstore(tmp_path):
    s = _store(tmp_path, INDEX_TYPE="flat", INDEX_DTYPE="int8",
               RAW_STORE="none")
    s.store("a", np.ones(8, np.float32))
    assert not s._rerank_enabled()
    assert s.search(np.ones(8, np.float32), limit=1)[0][0] == "a"


def test_store_save_keeps_legacy_raw_when_rawstore_disabled(tmp_path):
    """save() must NOT delete a legacy raw.npz it never ingested: with
    the raw store disabled it is the only f32 copy (review r4 finding).
    Re-enabling the raw store later must still find and ingest it."""
    s = _store(tmp_path)
    s.store("a", np.arange(8, dtype=np.float32), {"k": 1})
    s.save()
    vec_dir = os.path.join(str(tmp_path), "vectors")
    for f in os.listdir(vec_dir):
        if f.startswith("raw_"):
            os.remove(os.path.join(vec_dir, f))
    legacy = os.path.join(vec_dir, "raw.npz")
    np.savez(
        legacy,
        ids=np.asarray(["a"], dtype=np.str_),
        vectors=np.arange(8, dtype=np.float32)[None],
    )
    s2 = _store(tmp_path, RAW_STORE="none")
    s2.save()  # must not destroy the blob it did not read
    assert os.path.exists(legacy)
    s3 = _store(tmp_path)  # raw store back on: blob ingests, then save
    got = s3.get("a")
    np.testing.assert_allclose(got[0], np.arange(8), atol=1e-6)
    s3.save()
    assert not os.path.exists(legacy)  # ingested -> superseded


def test_store_bulk_load_rejects_duplicate_ids_in_batch(tmp_path):
    """A duplicate id inside one bulk_load batch would insert two index
    rows but register one -> permanent ghost slot (review r4 finding)."""
    s = _store(tmp_path)
    vecs = np.eye(3, 8, dtype=np.float32)
    with pytest.raises(ValueError, match="unique"):
        s.bulk_load(["a", "b", "a"], vecs)
    assert s.count() == 0
    assert all(ix.count() == 0 for ix in s.indices)


def test_store_compact_remaps_sidecars(tmp_path):
    """optimize()'s slot renumbering must carry metadata + raws along."""
    s = _store(tmp_path, INDEX_TYPE="flat")
    vecs = {f"v{i}": np.random.default_rng(i).standard_normal(8).astype(
        np.float32) for i in range(50)}
    s.batch_store(vecs, {k: {"n": int(k[1:])} for k in vecs})
    for i in range(0, 50, 2):
        s.delete(f"v{i}")
    s.optimize()
    for i in range(1, 50, 2):
        got = s.get(f"v{i}")
        assert got is not None
        np.testing.assert_allclose(got[0], vecs[f"v{i}"], atol=1e-6)
        assert got[1] == {"n": i}
    assert s.verify()["orphan_metadata"] == 0
