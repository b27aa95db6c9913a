"""The cases of ``tests/test_store_pipelined.py`` on the port, on the CPU.

A translated copy of that file: the same classes, functions,
parametrisations and asserts, run on ``wdbx_tpu_torch``. Each
``wdbx_tpu`` import names its ``wdbx_tpu_torch`` counterpart; the
autouse fixture asks for the CPU through
``test_torch_ops.port_on_cpu`` (the default device and mesh of one
test), so the package keeps the card as its own default.

Translated, every case (7 cases):
test_submit_resolve_matches_search_batch;
test_submit_with_filter_falls_back_sync;
test_mutation_between_submit_and_resolve_is_safe;
test_batcher_uses_pipelined_path; test_get_many_matches_get.

Changed beyond the imports and the fixture: nothing. Left out: nothing.

The reference file's description:

Store-level pipelined serving (VERDICT r4 ask #4): submit/resolve
must match search_batch exactly, survive mutations between submit and
resolve, and batch the metadata attach.
"""

import asyncio

import numpy as np
import pytest

from wdbx_tpu_torch.core.config import WDBXConfig
from wdbx_tpu_torch.store.vector_store import VectorStore
from test_torch_ops import port_on_cpu


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    port_on_cpu(monkeypatch)


def _store(tmp_path, **over):
    cfg = {
        "VECTOR_DIMENSION": 16,
        "DATA_DIR": str(tmp_path),
        "VECTOR_STORE_AUTOSAVE_INTERVAL": 0,
        "INDEX_TYPE": "flat",
    }
    cfg.update(over)
    return VectorStore(WDBXConfig(cfg))


def _fill(store, n, dim=16, seed=0):
    r = np.random.default_rng(seed)
    vecs = r.standard_normal((n, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
    store.bulk_load(
        [f"v{i:04d}" for i in range(n)], vecs,
        metadata_columns={"num": np.arange(n)},
    )
    return vecs


def _q(b, dim=16, seed=9):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, dim)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("index_type,extra", [
    ("flat", {}),
    ("flat", {"INDEX_DTYPE": "int8", "RAW_STORE": "memmap"}),
    # full probe width: the clustered scan covers every bucket, so the
    # pipelined result is exact and comparable to the sync path (which
    # may route small batches through the flat fallback)
    ("ivf_clustered", {"IVF_NLIST": 16, "IVF_TRAIN_THRESHOLD": 16,
                       "IVF_NPROBE": 16}),
])
def test_submit_resolve_matches_search_batch(tmp_path, index_type, extra):
    store = _store(tmp_path, INDEX_TYPE=index_type, **extra)
    _fill(store, 200)
    for b in (1, 3, 8):  # 3 exercises the pow2 padding
        q = _q(b)
        want = store.search_batch(q, limit=5)
        got = store.search_batch_resolve(
            store.search_batch_submit(q, limit=5)
        )
        assert len(got) == b
        for w_row, g_row in zip(want, got):
            assert [h[0] for h in g_row] == [h[0] for h in w_row]
            assert [h[2] for h in g_row] == [h[2] for h in w_row]
            np.testing.assert_allclose(
                [h[1] for h in g_row], [h[1] for h in w_row], atol=1e-5
            )


def test_submit_with_filter_falls_back_sync(tmp_path):
    store = _store(tmp_path)
    _fill(store, 50)
    handle = store.search_batch_submit(
        _q(2), limit=50, filter_metadata={"num": {"$lt": 10}}
    )
    assert handle[0] == "sync"
    got = store.search_batch_resolve(handle)
    assert all(h[2]["num"] < 10 for row in got for h in row)
    assert len(got[0]) == 10


def test_mutation_between_submit_and_resolve_is_safe(tmp_path):
    store = _store(tmp_path)
    _fill(store, 100)
    q = _q(4)
    handle = store.search_batch_submit(q, limit=5)
    # delete + re-insert: slots recycle, epoch moves
    for i in range(20):
        store.delete(f"v{i:04d}")
    r = np.random.default_rng(5)
    for i in range(20):
        v = r.standard_normal(16).astype(np.float32)
        store.store(f"n{i}", v / np.linalg.norm(v), {"num": 1000 + i})
    got = store.search_batch_resolve(handle)
    want = store.search_batch(q, limit=5)
    for w_row, g_row in zip(want, got):
        assert [h[0] for h in g_row] == [h[0] for h in w_row]
        # metadata pairing must be the live row's own metadata
        for h in g_row:
            live = store.get(h[0])
            assert live is not None and h[2] == live[1]


def test_batcher_uses_pipelined_path(tmp_path):
    from wdbx_tpu_torch.api.batching import QueryBatcher

    store = _store(tmp_path)
    _fill(store, 100)
    calls = {"submit": 0}
    orig = store.search_batch_submit

    def spy(*a, **kw):
        calls["submit"] += 1
        return orig(*a, **kw)

    store.search_batch_submit = spy
    q = _q(6)

    async def run():
        batcher = QueryBatcher(store, max_batch=4, max_wait_ms=1.0)
        hits = await asyncio.gather(
            *(batcher.search(q[i], limit=3) for i in range(6))
        )
        return hits

    hits = asyncio.run(run())
    assert calls["submit"] >= 1
    want = store.search_batch(q, limit=3)
    for w_row, g_row in zip(want, hits):
        assert [h[0] for h in g_row] == [h[0] for h in w_row]


def test_get_many_matches_get(tmp_path):
    store = _store(tmp_path)
    _fill(store, 64)
    store.update_metadata("v0003", {"x": "yes", "n": 3})
    store.delete("v0005")
    slots = np.arange(-2, 70)
    got = store.meta.get_many(0, slots)
    for slot, m in zip(slots, got):
        assert m == store.meta.get(0, int(slot))
