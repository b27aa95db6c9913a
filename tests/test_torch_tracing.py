"""The search path's tracer (``wdbx_tpu_torch.utils.metrics.TRACER``).

Off by default: span sites record nothing and the interpreter's
collections are not hooked. Started, the spans of one ``search_batch``
nest and share a call id (across the store's fan-out pool too), their
CPU time is the thread's own, ``lock_wait_ns`` grows behind a writer,
collections become ``gc.collect`` spans, and the bounded buffer drops
its oldest span and counts it. The store's latency reservoir is fed
either way, each op name timing what it says. The clustered engine's
probe, dedup, residual merge and result copy nest under its
``index.search`` on both CPU routes; K3's live block count is counted
only while the tracer runs and read only when it is drained.
"""

import gc
import sys
import threading
import time

import numpy as np
import pytest

from wdbx_tpu_torch import WDBX
from wdbx_tpu_torch.utils import metrics
from wdbx_tpu_torch.utils.metrics import TRACER, span

DIM = 16
CALLERS = 4


@pytest.fixture(autouse=True)
def _tracer_left_off():
    TRACER.stop()
    TRACER.drain()
    yield
    TRACER.stop()
    TRACER.drain()


def make_db(temp_dir, shards=1, rows=512):
    db = WDBX(vector_dimension=DIM, num_shards=shards, data_dir=temp_dir,
              config={"VECTOR_STORE_AUTOSAVE_INTERVAL": 0},
              enable_plugins=False, device="cpu", log_level="WARNING")
    rng = np.random.default_rng(0)
    db.store.bulk_load([str(i) for i in range(rows)],
                       rng.standard_normal((rows, DIM)).astype(np.float32))
    return db


def queries(n=8, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, DIM)).astype(np.float32)


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_off_records_nothing_and_hooks_no_collections(temp_dir):
    db = make_db(temp_dir)
    assert not TRACER.on
    assert span("x", a=1) is metrics._NOOP
    assert TRACER.current() is None
    assert TRACER.adopt(None) is metrics._NOOP
    assert TRACER.clock() == 0
    db.vector_search_batch(queries(), limit=5)
    gc.collect()
    assert TRACER.drain() == []
    assert TRACER._on_gc not in gc.callbacks
    TRACER.start()
    assert TRACER._on_gc in gc.callbacks
    TRACER.stop()
    assert TRACER._on_gc not in gc.callbacks


@pytest.mark.parametrize("shards", [1, 2], ids=["one_shard", "fan_out"])
def test_spans_nest_with_parent_and_call_across_threads(temp_dir, shards):
    db = make_db(temp_dir, shards=shards)
    go = threading.Barrier(CALLERS)
    errors = []

    def caller(j):
        try:
            go.wait(timeout=30)
            for n in range(3):
                db.vector_search_batch(queries(8, seed=10 * j + n), limit=5)
        except Exception as e:  # handed to the test's thread
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # threads interleave inside span sites
    TRACER.start()
    try:
        threads = [threading.Thread(target=caller, args=(j,))
                   for j in range(CALLERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        TRACER.stop()
        sys.setswitchinterval(switch)
    assert not errors and not any(t.is_alive() for t in threads)
    spans = [s for s in TRACER.drain() if s.name != "gc.collect"]
    calls = by_name(spans, "store.search_batch")
    assert len(calls) == CALLERS * 3
    assert len({s.tid for s in calls}) == CALLERS
    by_id = {s.id: s for s in spans}
    for root in calls:
        assert root.parent == 0 and root.call == root.id
        assert root.attrs == {"b": 8, "k": 5, "shards": shards,
                              "attempts": 1}
        mine = [s for s in spans if s.call == root.id]
        names = sorted(s.name for s in mine)
        assert names == sorted(["store.search_batch", "store.prep",
                                "store.merge"]
                               + ["index.search", "index.d2h"] * shards)
        for s in mine:
            assert root.t0 <= s.t0 <= s.t1 <= root.t1
            if s.name in ("store.prep", "store.merge", "index.search"):
                assert s.parent == root.id
            if s.name in ("store.prep", "store.merge"):
                assert s.tid == root.tid
            if s.name == "index.d2h":
                outer = by_id[s.parent]
                assert outer.name == "index.search"
                assert outer.tid == s.tid
        searches = by_name(mine, "index.search")
        assert all(s.attrs["engine"] == "FlatIndex" for s in searches)
        assert all(s.attrs["lock_wait_ns"] >= 0 for s in searches)
        # the fan-out pool's threads carry the call
        assert ({s.tid for s in searches} == {root.tid}) == (shards == 1)
        assert by_name(mine, "store.merge")[0].attrs == {"hits": 8 * 5}


@pytest.mark.parametrize("work", ["sleep", "busy"])
def test_cpu_time_is_the_threads_own(work):
    TRACER.start()
    with span("work"):
        if work == "sleep":
            time.sleep(0.05)
        else:
            end = time.perf_counter() + 0.05
            while time.perf_counter() < end:
                pass
    TRACER.stop()
    (s,) = by_name(TRACER.drain(), "work")
    wall = s.t1 - s.t0
    assert wall >= 50_000_000
    if work == "sleep":
        assert s.cpu_ns < 10_000_000
    else:
        # the loop never waits; another process may take the core for a
        # while, so half the wall is the floor
        assert s.cpu_ns >= 0.5 * wall
        assert s.cpu_ns <= wall + 1_000_000


def test_lock_wait_grows_behind_the_index_writer(temp_dir):
    db = make_db(temp_dir)
    index = db.store.indices[0]
    q = queries()
    TRACER.start()
    db.vector_search_batch(q, limit=5)
    held, release = threading.Event(), threading.Event()

    def writer():
        with index._mu.write():
            held.set()
            release.wait(timeout=30)

    t = threading.Thread(target=writer)
    t.start()
    assert held.wait(timeout=30)
    threading.Timer(0.1, release.set).start()
    db.vector_search_batch(q, limit=5)
    t.join(timeout=30)
    TRACER.stop()
    assert not t.is_alive()
    spans = TRACER.drain()
    free, blocked = [s.attrs["lock_wait_ns"]
                     for s in by_name(spans, "index.search")]
    assert blocked >= 80_000_000 > free
    # the store's own lock was free both times
    assert all(s.attrs["lock_wait_ns"] < 80_000_000
               for s in by_name(spans, "store.prep"))


def test_a_forced_collection_is_one_gc_span_of_generation_2():
    TRACER.start()
    with span("outer") as outer:
        gc.collect()
    TRACER.stop()
    spans = TRACER.drain()
    collected = [s for s in by_name(spans, "gc.collect")
                 if s.attrs["generation"] == 2]
    assert len(collected) == 1
    (s,) = collected
    assert s.parent == outer.id and s.call == outer.id
    assert s.attrs["collected"] >= 0 and s.t1 >= s.t0


def test_the_buffer_keeps_its_bound_and_counts_what_it_drops(monkeypatch):
    small = metrics.Tracer(capacity=4)
    monkeypatch.setattr(metrics, "TRACER", small)
    was = gc.isenabled()
    gc.disable()  # no collection spans among the counted ones
    try:
        small.start()
        for i in range(10):
            with span("s", i=i):
                pass
        small.stop()
    finally:
        if was:
            gc.enable()
    spans = small.drain()
    assert [s.attrs["i"] for s in spans] == [6, 7, 8, 9]
    assert small.dropped == 6
    assert small.drain() == []


@pytest.mark.parametrize("traced", [False, True], ids=["off", "on"])
def test_latency_ops_time_what_they_say(temp_dir, traced):
    db = make_db(temp_dir)
    if traced:
        TRACER.start()
    db.store.store("a", queries(1)[0])
    db.store.search(queries(1)[0])
    db.store.search_batch(queries(4), limit=3)
    TRACER.stop()
    latency = db.store.get_stats()["latency"]
    assert latency["store"]["count"] == 1
    assert latency["search"]["count"] == 1
    assert latency["search_batch"]["count"] == 1
    assert latency["merge"]["count"] == 2
    assert latency["search_prep"]["count"] == 2
    spans = TRACER.drain()
    assert len(by_name(spans, "store.search_batch")) == (2 if traced else 0)
    assert len(by_name(spans, "store")) == (1 if traced else 0)


CLUSTERED_SPANS = ("index.probe", "index.dedup", "index.residual_merge",
                   "index.d2h")


def make_clustered_db(temp_dir, route, rows=2048):
    db = WDBX(vector_dimension=DIM, num_shards=1, data_dir=temp_dir,
              config={"VECTOR_STORE_AUTOSAVE_INTERVAL": 0,
                      "INDEX_TYPE": "ivf", "INDEX_DTYPE": "int8",
                      "IVF_NLIST": 16, "IVF_NPROBE": 2,
                      "IVF_TRAIN_THRESHOLD": 256},
              enable_plugins=False, device="cpu", log_level="WARNING")
    index = db.store.indices[0]
    index.ivf_kernel = route
    index.block_bytes_target = 256 * DIM
    index.batch_flat_fallback = False
    rng = np.random.default_rng(0)
    db.store.bulk_load([str(i) for i in range(rows)],
                       rng.standard_normal((rows, DIM)).astype(np.float32))
    index.build()
    assert type(index).__name__ == "ClusteredIVFIndex" and index.is_trained
    return db


@pytest.mark.parametrize("route", ["pallas", "lax"])
def test_clustered_spans_nest_under_index_search(temp_dir, route):
    db = make_clustered_db(temp_dir, route)
    TRACER.start()
    db.vector_search_batch(queries(8), limit=5)
    TRACER.stop()
    spans = [s for s in TRACER.drain() if s.name != "gc.collect"]
    (root,) = by_name(spans, "store.search_batch")
    (search,) = by_name(spans, "index.search")
    assert search.attrs["engine"] == "ClusteredIVFIndex"
    assert search.parent == root.id
    assert {s.call for s in spans} == {root.id}
    for name in CLUSTERED_SPANS:
        (s,) = by_name(spans, name)
        assert s.parent == search.id and s.tid == search.tid
        assert search.t0 <= s.t0 <= s.t1 <= search.t1
    probe, dedup, merge, d2h = (by_name(spans, n)[0]
                                for n in CLUSTERED_SPANS)
    assert probe.t1 <= dedup.t0 and dedup.t1 <= merge.t0 <= merge.t1 <= d2h.t0
    # no K3 launch on the CPU: its plain version runs unspanned
    assert not by_name(spans, "kernel.k3")


def test_clustered_search_records_nothing_while_off(temp_dir):
    db = make_clustered_db(temp_dir, "pallas")
    db.vector_search_batch(queries(8), limit=5)
    db.store.indices[0].search_pipelined(queries(8)[None], 5)
    assert TRACER.drain() == []


def test_k3_live_count_is_read_only_while_on_and_after_the_copy():
    import torch

    from wdbx_tpu_torch.kernels.clustered_scan import k3_span

    ok = torch.tensor([1, 1, 0, 1, 0], dtype=torch.int32)
    # off: the shared no-op, nothing counted
    assert k3_span(ok, u=5) is metrics._NOOP
    TRACER.start()
    with k3_span(ok, slab="int8", u=5) as sp:
        pass
    TRACER.stop()
    # a device value until the drain reads it
    assert isinstance(sp.attrs["live"], torch.Tensor)
    (s,) = by_name(TRACER.drain(), "kernel.k3")
    assert s.attrs == {"slab": "int8", "u": 5, "live": 3}
    assert type(s.attrs["live"]) is int
    assert s.parent == 0 and s.call == s.id


def test_drain_reads_tensor_attributes_and_leaves_the_rest():
    import torch

    TRACER.start()
    with metrics.span("any.site", n=7, kind="x",
                      total=torch.tensor(2.5), count=torch.tensor(4)):
        pass
    TRACER.stop()
    (s,) = by_name(TRACER.drain(), "any.site")
    assert s.attrs == {"n": 7, "kind": "x", "total": 2.5, "count": 4}
    assert [type(s.attrs[k]) for k in ("total", "count")] == [float, int]
    assert TRACER.drain() == []
