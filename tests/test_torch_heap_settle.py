"""The store settles the interpreter's heap at its set-up edges
(``wdbx_tpu_torch.utils.heap``).

A settle is one full collection and ``gc.freeze()``. It runs at store
construction, at the end of ``bulk_load`` and at the end of ``warm()``,
never in a search or a per-row write, and not at all while the
collector is off. What it moves out of the collector's reach is counted
in objects, not timed: the ``heap.settle`` spans a started tracer
records, the permanent generation's size and the tracked objects left.
The answers do not change, and a dropped facade, plugins and all, still
frees its index at ``del`` with the collector off: the facade holds no
reference cycle that a settle could freeze.
"""

import gc
import weakref

import numpy as np
import pytest

from wdbx_tpu_torch import WDBX
from wdbx_tpu_torch.plugins.ollama import OllamaPlugin
from wdbx_tpu_torch.utils.metrics import TRACER

DIM = 8
ROWS = 256


@pytest.fixture(autouse=True)
def _tracer_left_off():
    TRACER.stop()
    TRACER.drain()
    yield
    TRACER.stop()
    TRACER.drain()


def open_db(path, shards=1, kind="bare"):
    """``bare``: no plugins, no autosave; ``plugins``: the default
    facade (plugins on, default autosave); ``registered``: a bare facade
    with a plugin built against it and registered by hand."""
    if kind == "plugins":
        return WDBX(vector_dimension=DIM, num_shards=shards,
                    data_dir=str(path), device="cpu", log_level="WARNING")
    db = WDBX(vector_dimension=DIM, num_shards=shards, data_dir=str(path),
              config={"VECTOR_STORE_AUTOSAVE_INTERVAL": 0},
              enable_plugins=False, device="cpu", log_level="WARNING")
    if kind == "registered":
        db.register_plugin(OllamaPlugin(db))
    return db


def bulk_load(db, rows=ROWS, first=0, seed=0):
    rng = np.random.default_rng(seed)
    ids = range(first, first + rows)
    db.store.bulk_load(
        [f"v{i}" for i in ids],
        rng.standard_normal((rows, DIM)).astype(np.float32),
        {"tag": np.asarray(ids) % 3, "name": [f"n{i}" for i in ids]},
    )


def queries(n=8, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, DIM)).astype(np.float32)


def traced(fn):
    """``fn()``'s result and the edges of the settles it ran, read from
    the ``heap.settle`` spans of a started tracer."""
    TRACER.start()
    try:
        out = fn()
    finally:
        TRACER.stop()
    return out, [s.attrs["edge"] for s in TRACER.drain()
                 if s.name == "heap.settle"]


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("resumed", [False, True], ids=["fresh", "resumed"])
def test_each_setup_edge_settles_once_and_freezes_the_heap(
        tmp_path, shards, resumed):
    first = 0
    if resumed:  # a data_dir saved before: _load() restores it
        db = open_db(tmp_path, shards)
        bulk_load(db, seed=7)
        db.store.save()
        del db
        first = ROWS
    gc.unfreeze()
    gc.collect()
    tracked = len(gc.get_objects())

    db, edges = traced(lambda: open_db(tmp_path, shards))
    assert edges == ["init"]
    assert db.count_vectors() == first
    _, edges = traced(lambda: bulk_load(db, first=first))
    assert edges == ["bulk_load"]
    assert db.count_vectors() == first + ROWS
    assert gc.get_freeze_count() >= tracked
    assert len(gc.get_objects()) < 0.05 * tracked


@pytest.mark.parametrize("shards", [1, 2])
def test_answers_are_the_same_after_a_further_settle(tmp_path, shards):
    db = open_db(tmp_path, shards)
    bulk_load(db)
    q = queries()
    before = db.vector_search_batch(q, limit=5)
    tag1 = {"tag": 1}
    filtered = db.vector_search_batch(q, limit=5, filter_metadata=tag1)
    served, edges = traced(lambda: db.store.warm(max_batch=16, limit=5))
    assert served == 1 and edges == ["warm"]
    after = db.vector_search_batch(q, limit=5)
    assert after == before  # ids, scores and metadata dicts
    assert db.vector_search_batch(q, limit=5,
                                  filter_metadata=tag1) == filtered
    assert all(len(hits) == 5 for hits in after)


def test_an_empty_store_warms_nothing_and_does_not_settle(tmp_path):
    db = open_db(tmp_path)
    assert traced(db.store.warm) == (0, [])


@pytest.mark.parametrize("kind", ["bare", "plugins", "registered"])
@pytest.mark.parametrize("shards", [1, 2])
def test_a_dropped_facade_frees_its_index_with_the_collector_off(
        tmp_path, shards, kind):
    was = gc.isenabled()
    frozen = []
    try:
        for i in range(10):
            gc.enable()
            db = open_db(tmp_path / f"db{i}", shards, kind)
            bulk_load(db, seed=i)  # settled at init and bulk_load
            gc.disable()
            assert len(db.vector_search_batch(queries(), limit=3)[0]) == 3
            alive = [weakref.ref(db), weakref.ref(db.store)]
            for index in db.store.indices:
                alive += [weakref.ref(index), weakref.ref(index._slab),
                          weakref.ref(index._valid)]
            if kind != "bare":
                manager = db.plugin_manager
                assert manager.plugins
                for owner in (manager, *manager.plugins.values()):
                    assert isinstance(owner.wdbx, weakref.ProxyType)
                alive.append(weakref.ref(manager))
                del manager, owner
            del db, index
            assert [r for r in alive if r() is not None] == []
            frozen.append(gc.get_freeze_count())
    finally:
        if was:
            gc.enable()
        else:
            gc.disable()
    assert abs(frozen[-1] - frozen[0]) <= 100


def test_a_plugin_outliving_its_facade_raises(tmp_path):
    db = open_db(tmp_path, kind="registered")
    plugin = db.get_plugin("ollama")
    assert plugin.wdbx.vector_dim == DIM
    del db
    with pytest.raises(ReferenceError):
        plugin.wdbx.vector_dim


def test_writes_and_searches_do_not_settle(tmp_path):
    db = open_db(tmp_path, shards=2)
    bulk_load(db)
    frozen = gc.get_freeze_count()
    rng = np.random.default_rng(3)

    def writes_and_searches():
        assert db.store.store("w0", rng.standard_normal(DIM), {"tag": 1})
        assert db.store.batch_store(
            {f"w{i}": rng.standard_normal(DIM) for i in (1, 2)},
            {f"w{i}": {"tag": i} for i in (1, 2)},
        ) == 2
        assert db.store.update_metadata("w1", {"tag": 5})
        assert db.store.delete("w2")
        db.store.search(queries(1)[0], limit=3)
        db.store.search_batch(queries(), limit=3)
        db.store.search_batch_resolve(
            db.store.search_batch_submit(queries()))

    assert traced(writes_and_searches)[1] == []
    # nothing was frozen since (frozen objects that died left it)
    assert gc.get_freeze_count() <= frozen


def test_a_process_with_the_collector_off_is_not_settled(tmp_path):
    was = gc.isenabled()
    gc.disable()
    try:
        frozen = gc.get_freeze_count()

        def set_up():
            db = open_db(tmp_path)
            bulk_load(db)
            assert db.store.warm(max_batch=8) == 1

        assert traced(set_up)[1] == []
        assert gc.get_freeze_count() == frozen
    finally:
        if was:
            gc.enable()


@pytest.mark.parametrize("edge", ["init", "bulk_load", "warm"])
def test_a_traced_settle_is_one_span_with_its_edge(tmp_path, edge):
    db = None
    if edge != "init":
        db = open_db(tmp_path)
        bulk_load(db, first=0 if edge == "bulk_load" else ROWS)
    TRACER.start()
    if edge == "init":
        db = open_db(tmp_path)
    elif edge == "bulk_load":
        bulk_load(db, first=ROWS)
    else:
        db.store.warm(max_batch=8)
    TRACER.stop()
    spans = TRACER.drain()
    (s,) = [s for s in spans if s.name == "heap.settle"]
    assert s.attrs["edge"] == edge
    assert s.attrs["collected"] >= 0 and s.attrs["frozen"] >= 0
    if edge != "warm":  # a new store, a grown index: new objects frozen
        assert s.attrs["frozen"] > 0
    # the settle's own full collection is a gc.collect span inside it
    full = [g for g in spans if g.name == "gc.collect"
            and g.attrs["generation"] == 2 and g.parent == s.id]
    assert len(full) == 1 and full[0].attrs["collected"] == \
        s.attrs["collected"]
