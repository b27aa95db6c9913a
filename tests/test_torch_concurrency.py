"""The cases of ``tests/test_concurrency.py`` on the port, on the CPU.

A translated copy of that file: the same classes, functions,
parametrisations and asserts, run on ``wdbx_tpu_torch``. Each
``wdbx_tpu`` import names its ``wdbx_tpu_torch`` counterpart; the
autouse fixture asks for the CPU through
``test_torch_ops.port_on_cpu`` (the default device and mesh of one
test), so the package keeps the card as its own default.

Translated, every case (7 cases):
TestConcurrency: test_parallel_writers, test_readers_during_writes,
test_mixed_delete_add_slot_consistency; TestSearchOverlap:
test_concurrent_searches_overlap, test_writer_waits_for_readers;
test_search_retries_on_slot_recycle;
test_clustered_search_during_mutation_and_rebuild.

Changed beyond the imports and the fixture: nothing. Left out: nothing.

The reference file's description:

Thread-safety stress tests.

The reference mutates shared dicts from thread pools with no locking
(SURVEY.md §5.2 — GIL roulette). Our store serializes mutation under an
RLock; these tests hammer it from many threads and assert invariants.
"""

import threading

import numpy as np

from wdbx_tpu_torch.core.config import WDBXConfig
from wdbx_tpu_torch.store.vector_store import VectorStore

import pytest
from test_torch_ops import port_on_cpu


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    port_on_cpu(monkeypatch)


def make_store(temp_dir, dim=8, shards=2):
    return VectorStore(
        WDBXConfig(
            {
                "VECTOR_DIMENSION": dim,
                "NUM_SHARDS": shards,
                "DATA_DIR": temp_dir,
                "VECTOR_STORE_AUTOSAVE_INTERVAL": 0,  # no mid-test saves
            }
        )
    )


class TestConcurrency:
    def test_parallel_writers(self, temp_dir):
        store = make_store(temp_dir)
        rng = np.random.default_rng(0)
        vecs = rng.standard_normal((200, 8)).astype(np.float32)
        errors = []

        def writer(t):
            try:
                for i in range(50):
                    store.store(f"t{t}-v{i}", vecs[(t * 50 + i) % 200])
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=writer, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errors
        assert store.count() == 200
        # every id resolves and round-trips
        for t in range(4):
            assert store.get(f"t{t}-v49") is not None

    def test_readers_during_writes(self, temp_dir):
        store = make_store(temp_dir)
        rng = np.random.default_rng(1)
        vecs = rng.standard_normal((100, 8)).astype(np.float32)
        store.batch_store({f"seed{i}": vecs[i] for i in range(50)})
        errors = []
        stop = threading.Event()

        def reader():
            try:
                while not stop.is_set():
                    hits = store.search(vecs[0], limit=5)
                    for vid, score, meta in hits:
                        assert isinstance(vid, str)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        def writer():
            try:
                for i in range(50, 100):
                    store.store(f"w{i}", vecs[i])
                    if i % 7 == 0:
                        store.delete(f"w{i}")
            except Exception as e:  # pragma: no cover
                errors.append(e)

        readers = [threading.Thread(target=reader) for _ in range(3)]
        w = threading.Thread(target=writer)
        for th in readers:
            th.start()
        w.start()
        w.join()
        stop.set()
        for th in readers:
            th.join()
        assert not errors

    def test_mixed_delete_add_slot_consistency(self, temp_dir):
        store = make_store(temp_dir, shards=1)
        rng = np.random.default_rng(2)
        vecs = rng.standard_normal((300, 8)).astype(np.float32)
        store.batch_store({f"v{i}": vecs[i] for i in range(100)})
        errors = []

        def deleter():
            try:
                for i in range(0, 100, 2):
                    store.delete(f"v{i}")
            except Exception as e:  # pragma: no cover
                errors.append(e)

        def adder():
            try:
                for i in range(100, 200):
                    store.store(f"v{i}", vecs[i])
            except Exception as e:  # pragma: no cover
                errors.append(e)

        t1, t2 = threading.Thread(target=deleter), threading.Thread(target=adder)
        t1.start(); t2.start(); t1.join(); t2.join()
        assert not errors
        assert store.count() == 150
        # slot table consistent: every surviving id searchable at top-1
        for vid in ("v1", "v99", "v100", "v199"):
            hits = store.search(np.asarray(store.get(vid)[0]), limit=1)
            assert hits[0][0] == vid


class TestSearchOverlap:
    def test_concurrent_searches_overlap(self, temp_dir):
        """Two searches must be inside device compute simultaneously —
        the store lock covers only bookkeeping and the index lock is
        read-shared (VERDICT r1 weak #4: the old store serialized all
        searches under one RLock for the whole device round trip)."""
        from wdbx_tpu_torch.index.flat import FlatIndex

        store = make_store(temp_dir, shards=1)
        rng = np.random.default_rng(0)
        vecs = rng.standard_normal((256, 8)).astype(np.float32)
        store.batch_store({f"v{i}": v for i, v in enumerate(vecs)})

        barrier = threading.Barrier(2, timeout=10)
        orig = FlatIndex._resolve_topk
        entered = []

        def instrumented(self):
            # both threads must reach this point (inside the index read
            # lock) at the same time; a serialized path deadlocks the
            # barrier and raises BrokenBarrierError
            entered.append(threading.get_ident())
            barrier.wait()
            return orig(self)

        FlatIndex._resolve_topk = instrumented
        errors = []

        def searcher():
            try:
                store.search(vecs[0], limit=5)
            except Exception as e:
                errors.append(e)

        try:
            threads = [threading.Thread(target=searcher) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=20)
        finally:
            FlatIndex._resolve_topk = orig
        assert not errors, errors
        assert len(set(entered)) == 2

    def test_writer_waits_for_readers(self, temp_dir):
        """A mutation during an in-flight search must not invalidate the
        search's buffers (donation safety) — it blocks on the write lock
        until the search materializes, and both succeed."""
        store = make_store(temp_dir, shards=1)
        rng = np.random.default_rng(1)
        vecs = rng.standard_normal((512, 8)).astype(np.float32)
        store.batch_store({f"v{i}": v for i, v in enumerate(vecs)})
        stop = threading.Event()
        errors = []

        def searcher():
            try:
                while not stop.is_set():
                    hits = store.search(vecs[3], limit=5)
                    assert hits, "search returned nothing"
            except Exception as e:
                errors.append(e)

        def writer():
            try:
                for i in range(30):
                    store.store(f"w{i}", vecs[i % 512])
                    store.delete(f"w{i}")
            except Exception as e:
                errors.append(e)
            finally:
                stop.set()

        ts = [threading.Thread(target=searcher) for _ in range(3)]
        tw = threading.Thread(target=writer)
        for t in ts:
            t.start()
        tw.start()
        tw.join(timeout=60)
        stop.set()
        for t in ts:
            t.join(timeout=30)
        assert not errors, errors


def test_search_retries_on_slot_recycle(temp_dir):
    """A slot recycled (delete+store) between the id-table snapshot and
    the merge must not mispair the old score with the new id — the
    epoch-validated search retries (review finding r2)."""
    store = make_store(temp_dir, shards=1)
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((64, 8)).astype(np.float32)
    store.batch_store({f"v{i}": v for i, v in enumerate(vecs)})

    from wdbx_tpu_torch.index.flat import FlatIndex

    orig = FlatIndex.search
    raced = {"done": False}

    def racing_search(self, queries, k, slot_mask=None):
        out = orig(self, queries, k, slot_mask)
        if not raced["done"]:
            raced["done"] = True
            # mutate AFTER the snapshot, DURING the "device" phase:
            # recycle v0's slot as brand-new id "vNEW"
            store.delete("v0")
            store.store("vNEW", vecs[0])
            out = orig(self, queries, k, slot_mask)  # post-mutation slab
        return out

    FlatIndex.search = racing_search
    try:
        hits = store.search(vecs[0], limit=1)
    finally:
        FlatIndex.search = orig
    # the top hit is v0's vector; after the recycle its id is vNEW — any
    # answer must pair consistently (vNEW), never the stale v0 label
    assert hits[0][0] == "vNEW", hits


def test_clustered_search_during_mutation_and_rebuild(temp_dir):
    """Clustered index under concurrent search + add/delete churn: the
    rebuild permutes the slab mid-stream, so this exercises the write
    lock around the permute, the stable-slot mapping, and the store's
    epoch-validated retries all at once."""
    store = VectorStore(
        WDBXConfig(
            {
                "VECTOR_DIMENSION": 8,
                "NUM_SHARDS": 1,
                "DATA_DIR": temp_dir,
                "VECTOR_STORE_AUTOSAVE_INTERVAL": 0,
                "INDEX_TYPE": "ivf_clustered",
                "IVF_TRAIN_THRESHOLD": 64,
                "IVF_NLIST": 4,
                "IVF_NPROBE": 4,
                "IVF_REBUILD_FRACTION": 0.05,  # rebuild often
            }
        )
    )
    rng = np.random.default_rng(0)
    base = rng.standard_normal((200, 8)).astype(np.float32)
    store.batch_store({f"v{i}": base[i] for i in range(200)})
    store.optimize()  # initial build
    errors = []
    stop = threading.Event()

    def churner():
        try:
            r = np.random.default_rng(1)
            for i in range(60):
                store.store(f"c{i}", r.standard_normal(8).astype(np.float32))
                if i % 3 == 0:
                    store.delete(f"v{i}")
                if i % 10 == 0:
                    store.optimize()  # forces compact/rebuild
        except Exception as e:  # pragma: no cover
            errors.append(e)
        finally:
            stop.set()

    def searcher():
        try:
            while not stop.is_set():
                hits = store.search(base[150], limit=5)
                ids = [h[0] for h in hits]
                assert len(ids) == len(set(ids)), f"dup results {ids}"
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=churner)] + [
        threading.Thread(target=searcher) for _ in range(3)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    # stable ids: an untouched row still resolves by search
    hits = store.search(base[150], limit=1)
    assert hits[0][0] == "v150"
    assert store.get("c59") is not None
