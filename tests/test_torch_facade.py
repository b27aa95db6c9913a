"""The cases of ``tests/test_facade.py`` on the port, on the CPU.

A translated copy of that file: the same classes, functions,
parametrisations and asserts, run on ``wdbx_tpu_torch``. Each
``wdbx_tpu`` import names its ``wdbx_tpu_torch`` counterpart; the
autouse fixture asks for the CPU through
``test_torch_ops.port_on_cpu`` (the default device and mesh of one
test), so the package keeps the card as its own default.

Translated, every case (12 cases):
TestFacade: test_sync_store_search, test_custom_id,
test_sync_method_not_shadowed, test_dim_validation, test_crud,
test_batch_and_clear, test_stats, test_async_lifecycle_and_ops,
test_persistence_across_instances, test_register_plugin,
test_batch_search; TestDropInAttributes: test_version_and_plugins_attrs.

Changed beyond the imports and the fixture: nothing. Left out: nothing.

The reference file's description:

WDBX facade tests — intended-surface parity with the reference facade
(reference tests/test_core.py:112-259 semantics, minus its shadowing bug).
"""

import numpy as np
import pytest

from wdbx_tpu_torch import WDBX
from test_torch_ops import port_on_cpu


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    port_on_cpu(monkeypatch)


@pytest.fixture
def db(temp_dir):
    return WDBX(
        vector_dimension=4,
        num_shards=2,
        data_dir=temp_dir,
        enable_plugins=False,
    )


class TestFacade:
    def test_sync_store_search(self, db):
        vid = db.vector_store([0.1, 0.2, 0.3, 0.4], {"tag": "t"})
        assert isinstance(vid, str) and vid
        hits = db.vector_search([0.1, 0.2, 0.3, 0.4], limit=5)
        assert hits[0][0] == vid and hits[0][1] > 0.99

    def test_custom_id(self, db):
        assert db.vector_store([1, 0, 0, 0], id="my-id") == "my-id"
        assert db.get_vector("my-id") is not None

    def test_sync_method_not_shadowed(self, db):
        # The reference's wdbx.vector_store is shadowed by an attribute
        # and raises TypeError (reference wdbx/core/wdbx.py:120); ours
        # must stay callable.
        assert callable(db.vector_store)
        assert callable(type(db).vector_store)

    def test_dim_validation(self, db):
        with pytest.raises(ValueError, match="dimension mismatch"):
            db.vector_store([1.0, 2.0])
        with pytest.raises(ValueError, match="dimension mismatch"):
            db.vector_search([1.0, 2.0])

    def test_crud(self, db):
        vid = db.vector_store([1, 0, 0, 0], {"a": 1})
        vec, meta = db.get_vector(vid)
        np.testing.assert_allclose(vec, [1, 0, 0, 0])
        assert meta == {"a": 1}
        assert db.update_metadata(vid, {"a": 2})
        assert db.get_vector(vid)[1] == {"a": 2}
        assert db.delete_vector(vid)
        assert db.get_vector(vid) is None
        assert db.count_vectors() == 0

    def test_batch_and_clear(self, db, rng):
        vecs = {f"v{i}": rng.standard_normal(4).astype(np.float32) for i in range(8)}
        assert db.batch_store(vecs) == 8
        assert db.count_vectors() == 8
        assert db.clear() == 8

    def test_stats(self, db):
        db.vector_store([1, 0, 0, 0])
        stats = db.get_stats()
        assert stats["vector_count"] == 1
        assert stats["num_shards"] == 2
        assert stats["vector_dimension"] == 4
        assert "version" in stats
        assert len(stats["indices"]) == 2

    async def test_async_lifecycle_and_ops(self, temp_dir):
        db = WDBX(
            vector_dimension=4, num_shards=2, data_dir=temp_dir,
            enable_plugins=False,
        )
        await db.initialize()
        vid = await db.vector_store_async([0.5, 0.5, 0, 0], {"x": 1})
        hits = await db.vector_search_async([0.5, 0.5, 0, 0], limit=3)
        assert hits[0][0] == vid
        assert (await db.get_vector_async(vid))[1] == {"x": 1}
        assert await db.update_metadata_async(vid, {"x": 2})
        assert await db.delete_vector_async(vid)
        await db.shutdown()

    def test_persistence_across_instances(self, temp_dir, rng):
        db = WDBX(vector_dimension=8, num_shards=2, data_dir=temp_dir,
                  enable_plugins=False)
        vecs = {f"v{i}": rng.standard_normal(8).astype(np.float32) for i in range(10)}
        db.batch_store(vecs, {f"v{i}": {"i": i} for i in range(10)})
        db.store.save()
        db2 = WDBX(vector_dimension=8, num_shards=2, data_dir=temp_dir,
                   enable_plugins=False)
        assert db2.count_vectors() == 10
        hits = db2.vector_search(vecs["v4"], limit=1)
        assert hits[0][0] == "v4"

    def test_register_plugin(self, db):
        from wdbx_tpu_torch.plugins import WDBXPlugin

        class Dummy(WDBXPlugin):
            name = "dummy"
            description = "d"
            version = "1.0"

        db.register_plugin(Dummy(db))
        assert db.get_plugin("dummy") is not None
        assert db.get_plugin("missing") is None

    def test_batch_search(self, db, rng):
        vecs = {f"v{i}": rng.standard_normal(4).astype(np.float32) for i in range(12)}
        db.batch_store(vecs)
        queries = np.stack([vecs["v1"], vecs["v5"]])
        res = db.vector_search_batch(queries, limit=1)
        assert [r[0][0] for r in res] == ["v1", "v5"]


class TestDropInAttributes:
    def test_version_and_plugins_attrs(self, db):
        # reference users read wdbx.version and wdbx.plugins directly
        assert isinstance(db.version, str) and db.version
        assert db.plugins == {}
        from wdbx_tpu_torch.plugins import WDBXPlugin

        class P(WDBXPlugin):
            name = "p1"
            description = "d"
            version = "1"

        db.register_plugin(P(db))
        assert "p1" in db.plugins
