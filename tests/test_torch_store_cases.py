"""The cases of ``tests/test_store.py`` on the port, on the CPU.

A translated copy of that file: the same classes, functions,
parametrisations and asserts, run on ``wdbx_tpu_torch``. Each
``wdbx_tpu`` import names its ``wdbx_tpu_torch`` counterpart; the
autouse fixture asks for the CPU through
``test_torch_ops.port_on_cpu`` (the default device and mesh of one
test), so the package keeps the card as its own default.

Translated (35 cases):
TestFilters: test_equality, test_operators, test_combined_clauses,
test_unknown_operator_raises; TestStableShard: test_deterministic,
test_spreads; TestVectorStore: test_store_search_roundtrip,
test_full_crud_cycle,
test_missing_id_semantics, test_dim_mismatch_raises,
test_batch_store_and_nn_identity, test_metadata_filter_lt,
test_prefilter_returns_full_limit, test_threshold,
test_update_existing_vector, test_persistence_restart, test_clear,
test_stats_shape, test_search_batch, test_async_twins, test_ivf_store,
test_optimize_background_scoped_and_off_lock,
test_clustered_store_lifecycle; TestVerifyRecover:
test_verify_consistent, test_verify_detects_divergence,
test_recover_from_checkpoint,
test_recover_without_checkpoint_preserves_live_state;
test_dimension_mismatch_refuses_to_load;
test_int8_store_reranks_with_f32;
test_rerank_pair_path_matches_matmul_path; test_local_embeddings_plugin;
test_store_tune_reports_per_shard; test_store_tune_learns_fetch_factor;
test_tuned_fetch_factor_survives_restart.

Changed beyond the imports and the fixture: nothing. Left out, one case:
``TestVectorStore::test_warm_precompiles_batch_widths``. It counts the
batch widths that ``warm()`` compiles, and the port compiles nothing
per width;
``test_torch_store.py::test_warm_serves_one_batch_and_changes_nothing``
covers the port's ``warm()``.

The reference file's description:

VectorStore tests — the compatibility spec from the reference suite
(reference tests/test_core.py: round-trip, CRUD, batch + filter,
error handling, persistence-across-restart, stats shapes).
"""

import numpy as np
import pytest

from wdbx_tpu_torch.core.config import WDBXConfig
from wdbx_tpu_torch.store.filters import matches_filter
from wdbx_tpu_torch.store.vector_store import VectorStore, stable_shard
from test_torch_ops import port_on_cpu


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    port_on_cpu(monkeypatch)


def make_store(temp_dir, dim=4, shards=2, **extra):
    cfg = WDBXConfig(
        {"VECTOR_DIMENSION": dim, "NUM_SHARDS": shards, "DATA_DIR": temp_dir, **extra}
    )
    return VectorStore(cfg)


class TestFilters:
    def test_equality(self):
        assert matches_filter({"a": 1}, {"a": 1})
        assert not matches_filter({"a": 2}, {"a": 1})
        assert not matches_filter({}, {"a": 1})

    def test_operators(self):
        meta = {"n": 5, "tag": "x"}
        assert matches_filter(meta, {"n": {"$gt": 4}})
        assert matches_filter(meta, {"n": {"$gte": 5}})
        assert matches_filter(meta, {"n": {"$lt": 6}})
        assert matches_filter(meta, {"n": {"$lte": 5}})
        assert matches_filter(meta, {"tag": {"$in": ["x", "y"]}})
        assert matches_filter(meta, {"tag": {"$nin": ["z"]}})
        assert matches_filter(meta, {"n": {"$exists": True}})
        assert matches_filter(meta, {"zzz": {"$exists": False}})
        assert not matches_filter(meta, {"n": {"$gt": 5}})
        assert not matches_filter(meta, {"zzz": {"$exists": True}})
        assert not matches_filter(meta, {"missing": {"$gt": 1}})

    def test_combined_clauses(self):
        meta = {"n": 5, "tag": "x"}
        assert matches_filter(meta, {"n": {"$gt": 1, "$lt": 10}, "tag": "x"})
        assert not matches_filter(meta, {"n": {"$gt": 1}, "tag": "y"})

    def test_unknown_operator_raises(self):
        with pytest.raises(ValueError):
            matches_filter({"a": 1}, {"a": {"$regex": "x"}})


class TestStableShard:
    def test_deterministic(self):
        assert stable_shard("vec-1", 4) == stable_shard("vec-1", 4)

    def test_spreads(self):
        shards = {stable_shard(f"id-{i}", 4) for i in range(100)}
        assert shards == {0, 1, 2, 3}


class TestVectorStore:
    def test_store_search_roundtrip(self, temp_dir):
        store = make_store(temp_dir)
        vec = [0.1, 0.2, 0.3, 0.4]
        assert store.store("v1", vec, {"tag": "a"})
        hits = store.search(vec, limit=5)
        assert hits[0][0] == "v1"
        assert hits[0][1] > 0.99
        assert hits[0][2] == {"tag": "a"}

    def test_full_crud_cycle(self, temp_dir):
        store = make_store(temp_dir)
        store.store("v1", [1, 0, 0, 0], {"k": 1})
        got = store.get("v1")
        assert got is not None
        vec, meta = got
        np.testing.assert_allclose(vec, [1, 0, 0, 0])
        assert meta == {"k": 1}
        assert store.update_metadata("v1", {"k": 2})
        assert store.get("v1")[1] == {"k": 2}
        assert store.delete("v1")
        assert store.get("v1") is None
        assert not store.delete("v1")
        assert store.count() == 0

    def test_missing_id_semantics(self, temp_dir):
        store = make_store(temp_dir)
        assert store.get("nope") is None
        assert not store.delete("nope")
        assert not store.update_metadata("nope", {})

    def test_dim_mismatch_raises(self, temp_dir):
        store = make_store(temp_dir)
        with pytest.raises(ValueError):
            store.store("v1", [1.0, 2.0])
        with pytest.raises(ValueError):
            store.search([1.0, 2.0])

    def test_batch_store_and_nn_identity(self, temp_dir, rng):
        store = make_store(temp_dir, dim=8)
        vecs = {
            f"v{i}": rng.standard_normal(8).astype(np.float32) for i in range(10)
        }
        metas = {f"v{i}": {"value": i} for i in range(10)}
        assert store.batch_store(vecs, metas) == 10
        assert store.count() == 10
        for vid, vec in list(vecs.items())[:3]:
            hits = store.search(vec, limit=1)
            assert hits[0][0] == vid

    def test_metadata_filter_lt(self, temp_dir, rng):
        store = make_store(temp_dir, dim=8)
        vecs = {
            f"v{i}": rng.standard_normal(8).astype(np.float32) for i in range(10)
        }
        metas = {f"v{i}": {"value": i} for i in range(10)}
        store.batch_store(vecs, metas)
        hits = store.search(vecs["v0"], limit=10, filter_metadata={"value": {"$lt": 5}})
        assert 0 < len(hits) <= 5
        assert all(h[2]["value"] < 5 for h in hits)

    def test_prefilter_returns_full_limit(self, temp_dir, rng):
        store = make_store(temp_dir, dim=8, FILTER_MODE="pre")
        vecs = {
            f"v{i}": rng.standard_normal(8).astype(np.float32) for i in range(50)
        }
        metas = {f"v{i}": {"value": i} for i in range(50)}
        store.batch_store(vecs, metas)
        hits = store.search(
            vecs["v49"], limit=5, threshold=-1e9,
            filter_metadata={"value": {"$lt": 10}},
        )
        assert len(hits) == 5
        assert all(h[2]["value"] < 10 for h in hits)

    def test_threshold(self, temp_dir):
        store = make_store(temp_dir)
        store.store("a", [1, 0, 0, 0])
        store.store("b", [0, 1, 0, 0])  # orthogonal → score ~0
        hits = store.search([1, 0, 0, 0], limit=10, threshold=0.5)
        assert [h[0] for h in hits] == ["a"]

    def test_update_existing_vector(self, temp_dir):
        store = make_store(temp_dir)
        store.store("v", [1, 0, 0, 0])
        store.store("v", [0, 1, 0, 0])  # overwrite
        assert store.count() == 1
        hits = store.search([0, 1, 0, 0], limit=1)
        assert hits[0][0] == "v" and hits[0][1] > 0.99

    def test_persistence_restart(self, temp_dir, rng):
        store = make_store(temp_dir, dim=8)
        vecs = {
            f"v{i}": rng.standard_normal(8).astype(np.float32) for i in range(20)
        }
        store.batch_store(vecs, {f"v{i}": {"i": i} for i in range(20)})
        store.save()
        store2 = make_store(temp_dir, dim=8)
        assert store2.count() == 20
        hits = store2.search(vecs["v7"], limit=1)
        assert hits[0][0] == "v7"
        assert store2.get("v7")[1] == {"i": 7}

    def test_clear(self, temp_dir):
        store = make_store(temp_dir)
        store.store("a", [1, 0, 0, 0])
        store.store("b", [0, 1, 0, 0])
        assert store.clear() == 2
        assert store.count() == 0
        store2 = make_store(temp_dir)  # clear persisted
        assert store2.count() == 0

    def test_stats_shape(self, temp_dir):
        store = make_store(temp_dir, shards=2)
        store.store("a", [1, 0, 0, 0])
        stats = store.get_stats()
        assert stats["vector_count"] == 1
        assert stats["num_shards"] == 2
        assert len(stats["indices"]) == 2
        assert stats["vector_dimension"] == 4

    def test_search_batch(self, temp_dir, rng):
        store = make_store(temp_dir, dim=8)
        vecs = {
            f"v{i}": rng.standard_normal(8).astype(np.float32) for i in range(30)
        }
        store.batch_store(vecs)
        queries = np.stack([vecs["v3"], vecs["v17"], vecs["v29"]])
        results = store.search_batch(queries, limit=1)
        assert [r[0][0] for r in results] == ["v3", "v17", "v29"]

    async def test_async_twins(self, temp_dir):
        store = make_store(temp_dir)
        assert await store.store_async("v1", [1, 0, 0, 0], {"a": 1})
        hits = await store.search_async([1, 0, 0, 0], limit=1)
        assert hits[0][0] == "v1"
        got = await store.get_async("v1")
        assert got[1] == {"a": 1}
        assert await store.update_metadata_async("v1", {"a": 2})
        assert await store.delete_async("v1")
        assert (await store.clear_async()) == 0

    def test_ivf_store(self, temp_dir, rng):
        store = make_store(
            temp_dir, dim=8, shards=1, INDEX_TYPE="ivf", IVF_TRAIN_THRESHOLD=64,
            IVF_NLIST=4,
        )
        vecs = {
            f"v{i}": rng.standard_normal(8).astype(np.float32) for i in range(100)
        }
        store.batch_store(vecs)
        store.optimize()
        hits = store.search(vecs["v42"], limit=1)
        assert hits[0][0] == "v42"

    def test_optimize_background_scoped_and_off_lock(self, temp_dir, rng):
        """optimize(background=True) must (a) route clustered shards to
        build_background WITHOUT flipping their configured
        ``background_rebuild``, and (b) run the retrain phase outside
        the store-wide lock so concurrent searches serve through it —
        the whole point of the serve-through rebuild (r3 review)."""
        import threading

        store = make_store(
            temp_dir, dim=8, shards=1, INDEX_TYPE="ivf_clustered",
            IVF_TRAIN_THRESHOLD=64, IVF_NLIST=4, IVF_NPROBE=4,
        )
        vecs = {
            f"v{i}": rng.standard_normal(8).astype(np.float32)
            for i in range(120)
        }
        store.batch_store(vecs)
        index = store.indices[0]
        assert index.background_rebuild is False

        calls = []
        orig_bg = index.build_background
        gate = threading.Event()
        in_optimize = threading.Event()

        def spy_bg():
            calls.append("background")
            in_optimize.set()
            assert gate.wait(10)
            return orig_bg()

        index.build_background = spy_bg
        t = threading.Thread(
            target=store.optimize, kwargs={"background": True}
        )
        t.start()
        assert in_optimize.wait(10)
        # store must keep serving while the rebuild is in flight
        hits = store.search(vecs["v42"], limit=1)
        assert hits[0][0] == "v42"
        gate.set()
        t.join(30)
        assert not t.is_alive()
        assert calls == ["background"]
        # per-call override, not a persistent flip
        assert index.background_rebuild is False
        # and a plain optimize() afterwards takes the blocking build
        index.build_background = lambda: calls.append("background")
        store.optimize()
        assert calls == ["background"]

    @pytest.mark.parametrize(
        "kind", ["ivf_clustered", "sharded_clustered"]
    )
    def test_clustered_store_lifecycle(self, temp_dir, rng, kind):
        """Full store lifecycle over the cluster-ordered layouts:
        batch_store -> optimize (build permutes the slab; registry must
        survive via stable slots) -> filtered search -> delete/update ->
        persistence restart."""
        store = make_store(
            temp_dir, dim=8, shards=1, INDEX_TYPE=kind,
            IVF_TRAIN_THRESHOLD=64, IVF_NLIST=4, IVF_NPROBE=4,
        )
        vecs = {
            f"v{i}": rng.standard_normal(8).astype(np.float32)
            for i in range(120)
        }
        metas = {k: {"i": int(k[1:])} for k in vecs}
        store.batch_store(vecs, metas)
        store.optimize()  # triggers the clustered build
        hits = store.search(vecs["v42"], limit=1)
        assert hits[0][0] == "v42"
        # filtered search through the store's mask machinery
        hits = store.search(
            vecs["v42"], limit=5, filter_metadata={"i": {"$lt": 50}}
        )
        assert hits and all(h[2]["i"] < 50 for h in hits)
        # mutation via the store
        assert store.delete("v42")
        hits = store.search(vecs["v42"], limit=1)
        assert hits[0][0] != "v42"
        store.update_metadata("v41", {"i": 1000})
        assert store.get("v41")[1]["i"] == 1000
        # restart-resume
        store.save()
        store2 = make_store(
            temp_dir, dim=8, shards=1, INDEX_TYPE=kind,
            IVF_TRAIN_THRESHOLD=64, IVF_NLIST=4, IVF_NPROBE=4,
        )
        assert store2.count() == 119
        hits = store2.search(vecs["v41"], limit=1)
        assert hits[0][0] == "v41"


class TestVerifyRecover:
    def test_verify_consistent(self, temp_dir, rng):
        store = make_store(temp_dir, dim=8)
        vecs = {f"v{i}": rng.standard_normal(8).astype(np.float32) for i in range(20)}
        store.batch_store(vecs)
        store.delete("v3")
        report = store.verify()
        assert report["consistent"]
        assert report["orphan_metadata"] == 0
        assert sum(s["registry_ids"] for s in report["shards"]) == 19

    def test_verify_detects_divergence(self, temp_dir, rng):
        store = make_store(temp_dir, dim=8, shards=1)
        store.store("a", rng.standard_normal(8).astype(np.float32))
        # corrupt: registry entry without an index slot
        store.registries[0].put(["ghost"], [99])
        assert not store.verify()["consistent"]

    def test_recover_from_checkpoint(self, temp_dir, rng):
        store = make_store(temp_dir, dim=8, shards=1)
        vecs = {f"v{i}": rng.standard_normal(8).astype(np.float32) for i in range(10)}
        store.batch_store(vecs)
        store.save()
        # simulate in-memory corruption
        store.indices[0].clear()
        store.registries[0] = type(store.registries[0])()
        assert store.verify()["shards"][0]["index_size"] == 0
        assert store.recover(0)
        assert store.count() == 10
        hits = store.search(vecs["v5"], limit=1)
        assert hits[0][0] == "v5"

    def test_recover_without_checkpoint_preserves_live_state(
        self, temp_dir, rng
    ):
        """recover() with no checkpoint must NOT wipe live in-memory
        rows (a flapping health check is not data loss); clearing is
        opt-in for callers that know the state is corrupt."""
        store = make_store(temp_dir, dim=8, shards=1)
        store.store("a", rng.standard_normal(8).astype(np.float32))
        import shutil

        shutil.rmtree(f"{temp_dir}/indices")
        import os

        os.makedirs(f"{temp_dir}/indices")
        assert not store.recover(0)
        assert store.count() == 1  # live row untouched
        assert not store.recover(0, clear_on_failure=True)
        assert store.count() == 0  # explicit clear


def test_dimension_mismatch_refuses_to_load(temp_dir):
    """Opening a data_dir with a different-dimension index must raise a
    config error, not silently serve an empty store (found live r2)."""
    from wdbx_tpu_torch.core.config import WDBXConfig
    from wdbx_tpu_torch.store.vector_store import VectorStore

    s = VectorStore(WDBXConfig({"VECTOR_DIMENSION": 16, "DATA_DIR": temp_dir}))
    s.store("a", np.ones(16, np.float32))
    s.save()
    with pytest.raises(ValueError, match="different-dimension"):
        VectorStore(WDBXConfig({"VECTOR_DIMENSION": 8, "DATA_DIR": temp_dir}))


def test_int8_store_reranks_with_f32(temp_dir, rng):
    """Quantized slab ranks candidates; the store re-scores the top set
    against the kept raw f32 vectors (SURVEY §7 recall protection)."""
    from wdbx_tpu_torch.core.config import WDBXConfig
    from wdbx_tpu_torch.store.vector_store import VectorStore

    store = VectorStore(WDBXConfig({
        "VECTOR_DIMENSION": 32, "DATA_DIR": temp_dir,
        "INDEX_DTYPE": "int8", "VECTOR_STORE_AUTOSAVE_INTERVAL": 0,
    }))
    assert store._rerank_enabled()
    vecs = rng.standard_normal((300, 32)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
    store.batch_store({f"v{i}": v for i, v in enumerate(vecs)})
    hits = store.search(vecs[7], limit=5)
    assert hits[0][0] == "v7"
    # re-ranked similarity is exact f32 (int8 scores carry ~1% error)
    assert abs(hits[0][1] - 1.0) < 1e-5
    # RERANK=False keeps quantized scores
    store.rerank = False
    hits2 = store.search(vecs[7], limit=5)
    assert hits2[0][0] == "v7"


def test_rerank_pair_path_matches_matmul_path(temp_dir, rng):
    """The adaptive re-rank (per-pair einsum when candidate sets are
    disjoint across a batch, BLAS unique-matmul when they overlap) must
    be invisible: batched search results equal the single-query results
    that take the matmul branch."""
    from wdbx_tpu_torch.core.config import WDBXConfig
    from wdbx_tpu_torch.store.vector_store import VectorStore

    store = VectorStore(WDBXConfig({
        "VECTOR_DIMENSION": 32, "DATA_DIR": temp_dir,
        "INDEX_DTYPE": "int8", "VECTOR_STORE_AUTOSAVE_INTERVAL": 0,
    }))
    assert store._rerank_enabled()
    vecs = rng.standard_normal((600, 32)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
    store.batch_store({f"v{i}": v for i, v in enumerate(vecs)})
    # 16 well-separated queries: candidate sets are mostly disjoint, so
    # uniq > 4 * kf and the batch takes the per-pair branch; the b == 1
    # calls take the matmul branch. Results must agree exactly.
    queries = vecs[::40][:16]
    batched = store.search_batch(queries, limit=5)
    for qi, q in enumerate(queries):
        single = store.search(q, limit=5)
        assert [h[0] for h in single] == [h[0] for h in batched[qi]]
        for hs, hb in zip(single, batched[qi]):
            assert abs(hs[1] - hb[1]) < 1e-5
        assert batched[qi][0][0] == f"v{qi * 40}"
        assert abs(batched[qi][0][1] - 1.0) < 1e-5


def test_local_embeddings_plugin(temp_dir, rng):
    """Demo-mode local embedder: deterministic, unit-norm, chain-ready."""
    import asyncio

    from wdbx_tpu_torch import WDBX
    from wdbx_tpu_torch.plugins.local_embeddings import LocalEmbeddingsPlugin

    db = WDBX(vector_dimension=16, data_dir=temp_dir, enable_plugins=False)
    db.config.set("SENTENCETRANSFORMERS_DEMO", True)  # demo is opt-in
    plugin = LocalEmbeddingsPlugin(db)
    assert plugin._demo()
    e1 = asyncio.run(plugin.create_embedding("hello"))
    e2 = asyncio.run(plugin.create_embedding("hello"))
    e3 = asyncio.run(plugin.create_embedding("world"))
    assert e1 == e2 and e1 != e3 and len(e1) == 16
    assert abs(np.linalg.norm(e1) - 1.0) < 1e-5
    batch = asyncio.run(plugin.create_embeddings_batch(["hello", "world"]))
    assert batch[0] == e1 and batch[1] == e3
    # without the demo flag or a model path, the plugin refuses loudly
    db.config.set("SENTENCETRANSFORMERS_DEMO", False)
    strict = LocalEmbeddingsPlugin(db)
    from wdbx_tpu_torch.plugins import PluginError

    with pytest.raises(PluginError, match="no local model configured"):
        asyncio.run(strict.create_embedding("x"))


def test_store_tune_reports_per_shard(temp_dir, rng):
    store = make_store(
        temp_dir, dim=16, shards=1, INDEX_TYPE="ivf_clustered",
        IVF_TRAIN_THRESHOLD=64, IVF_NLIST=8, IVF_NPROBE=1,
    )
    vecs = {}
    for i in range(400):
        v = rng.standard_normal(16).astype(np.float32)
        vecs[f"v{i}"] = v / np.linalg.norm(v)
    store.batch_store(vecs)
    store.optimize()
    report = store.tune(target_recall=0.9)
    assert report["achieved"] >= 0.9
    assert report["shards"][0]["nprobe"] >= 1
    # flat stores are always exact
    flat = make_store(temp_dir + "_f", dim=8, shards=1)
    flat.store("a", rng.standard_normal(8).astype(np.float32))
    assert flat.tune()["achieved"] == 1.0


def test_store_tune_learns_fetch_factor(temp_dir, rng):
    """tune() on a quantized store also picks the smallest re-rank
    over-fetch factor whose re-ranked top-k converges to the deep
    (64x) pool — replacing the static int4 default of 20."""
    store = make_store(
        temp_dir, dim=16, shards=1, INDEX_TYPE="flat", INDEX_DTYPE="int4",
    )
    vecs = {}
    for i in range(300):
        v = rng.standard_normal(16).astype(np.float32)
        vecs[f"v{i}"] = v / np.linalg.norm(v)
    store.batch_store(vecs)
    assert store._rerank_fetch_factor() == 20  # static int4 default
    report = store.tune(target_recall=0.9)
    ff = report["fetch_factor"]
    assert ff is not None and ff["factor"] in (2, 4, 8, 16, 32, 64)
    assert store._rerank_fetch_factor() == ff["factor"]
    assert store._fetch_factor_force is None  # probe pin released
    # explicit config still wins over the tuned value
    store.config.set("RERANK_FETCH_FACTOR", 7)
    assert store._rerank_fetch_factor() == 7
    # unquantized stores don't tune a factor (no rerank)
    flat = make_store(temp_dir + "_f32", dim=8, shards=1)
    flat.store("a", rng.standard_normal(8).astype(np.float32))
    assert "fetch_factor" not in flat.tune()


def test_tuned_fetch_factor_survives_restart(temp_dir, rng):
    """The factor tune() learned must come back after save + reload —
    the nprobe learned by the same tune() call rides the index
    checkpoint, and a restart reverting only the over-fetch silently
    changes recall/latency."""
    store = make_store(
        temp_dir, dim=16, shards=1, INDEX_TYPE="flat", INDEX_DTYPE="int4",
    )
    vecs = {}
    for i in range(200):
        v = rng.standard_normal(16).astype(np.float32)
        vecs[f"v{i}"] = v / np.linalg.norm(v)
    store.batch_store(vecs)
    report = store.tune(target_recall=0.9)
    factor = report["fetch_factor"]["factor"]
    store.save()
    store2 = make_store(
        temp_dir, dim=16, shards=1, INDEX_TYPE="flat", INDEX_DTYPE="int4",
    )
    assert store2._tuned_fetch_factor == factor
    assert store2._rerank_fetch_factor() == factor
