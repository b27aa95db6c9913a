"""The port's REST API (wdbx_tpu_torch.api) on the CPU.

The cases of ``tests/test_api.py`` run on the port through aiohttp's test
client — all 13 reference routes plus the batched-search extension —
with every facade built with ``device="cpu"``. One case is changed, not
left out: ``TestWarmup`` asserts the port's one width (nothing compiles
per batch width; JAX traces 8). Then the port's QueryBatcher
(``test_store_pipelined.py::test_batcher_uses_pipelined_path``, bursts
and flushes longer than ``max_batch``, stores during searches) and one
request script through a JAX-backed and a port-backed server whose JSON
bodies must agree."""

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from wdbx_tpu_torch import WDBX as _WDBX
from wdbx_tpu_torch.api.server import WDBXAPIServer
from wdbx_tpu_torch.plugins import WDBXPlugin


def WDBX(**kw):
    """The port's facade on the CPU."""
    return _WDBX(device="cpu", **kw)


class FakeEmbedder(WDBXPlugin):
    name = "ollama"
    description = "fake"
    version = "0"

    async def create_embedding(self, text):
        rng = np.random.default_rng(abs(hash(text)) % 2**32)
        return rng.standard_normal(4).astype(float).tolist()


async def make_client(temp_dir, **server_kw):
    db = WDBX(vector_dimension=4, num_shards=2, data_dir=temp_dir,
              enable_plugins=False)
    db.register_plugin(FakeEmbedder(db))
    await db.initialize()
    server = WDBXAPIServer(db, **server_kw)
    client = TestClient(TestServer(server.app))
    await client.start_server()
    return client, db


class TestAPI:
    async def test_health(self, temp_dir):
        client, _ = await make_client(temp_dir)
        resp = await client.get("/api/v1/health")
        assert resp.status == 200
        body = await resp.json()
        assert body["status"] == "healthy" and "version" in body
        await client.close()

    async def test_vector_crud_routes(self, temp_dir):
        client, _ = await make_client(temp_dir)
        resp = await client.post(
            "/api/v1/vectors",
            json={"vector": [1, 0, 0, 0], "metadata": {"t": 1}, "id": "v1"},
        )
        assert resp.status == 200
        assert (await resp.json())["vector_id"] == "v1"

        resp = await client.post(
            "/api/v1/vectors/search",
            json={"query_vector": [1, 0, 0, 0], "limit": 5},
        )
        results = (await resp.json())["results"]
        assert results[0]["vector_id"] == "v1"
        assert results[0]["similarity"] > 0.99
        assert results[0]["metadata"] == {"t": 1}

        resp = await client.get("/api/v1/vectors/v1")
        body = await resp.json()
        assert body["vector"] == [1.0, 0.0, 0.0, 0.0]

        resp = await client.put(
            "/api/v1/vectors/v1/metadata", json={"metadata": {"t": 2}}
        )
        assert (await resp.json())["success"]

        resp = await client.delete("/api/v1/vectors/v1")
        assert (await resp.json())["success"]
        assert (await client.get("/api/v1/vectors/v1")).status == 404
        assert (await client.delete("/api/v1/vectors/v1")).status == 404
        await client.close()

    async def test_batch_search_route(self, temp_dir):
        client, db = await make_client(temp_dir)
        for i in range(4):
            vec = [0.0] * 4
            vec[i] = 1.0
            db.vector_store(vec, id=f"e{i}")
        resp = await client.post(
            "/api/v1/vectors/search/batch",
            json={"query_vectors": [[1, 0, 0, 0], [0, 0, 1, 0]], "limit": 1},
        )
        body = await resp.json()
        assert body["results"][0][0]["vector_id"] == "e0"
        assert body["results"][1][0]["vector_id"] == "e2"
        await client.close()

    async def test_stats_and_clear(self, temp_dir):
        client, db = await make_client(temp_dir)
        db.vector_store([1, 0, 0, 0])
        resp = await client.get("/api/v1/stats")
        assert (await resp.json())["vector_count"] == 1
        resp = await client.post("/api/v1/clear")
        assert (await resp.json())["removed_vectors"] == 1
        await client.close()

    async def test_embeddings_routes(self, temp_dir):
        client, _ = await make_client(temp_dir)
        resp = await client.post("/api/v1/embeddings", json={"text": "hi"})
        assert resp.status == 200
        assert len((await resp.json())["embedding"]) == 4
        resp = await client.post(
            "/api/v1/embeddings/batch", json={"texts": ["a", "b"]}
        )
        assert len((await resp.json())["embeddings"]) == 2
        await client.close()

    async def test_embeddings_501_when_no_plugin(self, temp_dir):
        db = WDBX(vector_dimension=4, data_dir=temp_dir, enable_plugins=False)
        server = WDBXAPIServer(db)
        client = TestClient(TestServer(server.app))
        await client.start_server()
        resp = await client.post("/api/v1/embeddings", json={"text": "x"})
        assert resp.status == 501
        await client.close()

    async def test_plugins_routes(self, temp_dir):
        client, _ = await make_client(temp_dir)
        resp = await client.get("/api/v1/plugins")
        plugins = (await resp.json())["plugins"]
        assert any(p["name"] == "ollama" for p in plugins)
        resp = await client.get("/api/v1/plugins/ollama")
        assert (await resp.json())["name"] == "ollama"
        assert (await client.get("/api/v1/plugins/nope")).status == 404
        await client.close()

    async def test_api_key_auth(self, temp_dir):
        client, _ = await make_client(temp_dir, api_key="sekrit")
        assert (await client.get("/api/v1/health")).status == 200  # exempt
        assert (await client.get("/api/v1/stats")).status == 401
        resp = await client.get(
            "/api/v1/stats", headers={"X-API-Key": "sekrit"}
        )
        assert resp.status == 200
        await client.close()

    async def test_cors_preflight(self, temp_dir):
        client, _ = await make_client(
            temp_dir, api_key="sekrit", cors_origins=["http://app.example"]
        )
        # preflight is unauthenticated and answers Allow-* headers
        resp = await client.options(
            "/api/v1/vectors/v1/metadata",
            headers={
                "Origin": "http://app.example",
                "Access-Control-Request-Method": "PUT",
                "Access-Control-Request-Headers": "X-API-Key",
            },
        )
        assert resp.status == 204
        assert (
            resp.headers["Access-Control-Allow-Origin"] == "http://app.example"
        )
        assert "PUT" in resp.headers["Access-Control-Allow-Methods"]
        assert "X-API-Key" in resp.headers["Access-Control-Allow-Headers"]
        # disallowed origin gets no CORS headers
        resp = await client.options(
            "/api/v1/stats", headers={"Origin": "http://evil.example"}
        )
        assert resp.status == 204
        assert "Access-Control-Allow-Origin" not in resp.headers
        # actual responses still carry Allow-Origin
        resp = await client.get(
            "/api/v1/stats",
            headers={"X-API-Key": "sekrit", "Origin": "http://app.example"},
        )
        assert resp.headers["Access-Control-Allow-Origin"] == "http://app.example"
        await client.close()

    async def test_validation_errors(self, temp_dir):
        client, _ = await make_client(temp_dir)
        assert (await client.post("/api/v1/vectors", json={})).status == 422
        resp = await client.post(
            "/api/v1/vectors", json={"vector": [1.0, 2.0]}
        )
        assert resp.status == 400  # dim mismatch → ValueError → 400
        await client.close()


class TestQueryBatching:
    async def test_concurrent_requests_coalesce(self, temp_dir):
        import asyncio

        client, db = await make_client(temp_dir)
        for i in range(4):
            vec = [0.0] * 4
            vec[i] = 1.0
            db.vector_store(vec, id=f"b{i}")

        async def one(i):
            vec = [0.0] * 4
            vec[i % 4] = 1.0
            resp = await client.post(
                "/api/v1/vectors/search",
                json={"query_vector": vec, "limit": 1},
            )
            return (await resp.json())["results"][0]["vector_id"]

        results = await asyncio.gather(*(one(i) for i in range(16)))
        assert results == [f"b{i % 4}" for i in range(16)]
        resp = await client.get("/api/v1/stats")
        batching = (await resp.json())["query_batching"]
        assert batching["requests"] == 16
        assert batching["batches"] < 16  # actually coalesced
        await client.close()

    async def test_batching_respects_param_groups(self, temp_dir):
        import asyncio

        client, db = await make_client(temp_dir)
        for i in range(8):
            db.vector_store(
                np.eye(4)[i % 4].tolist(), id=f"p{i}", metadata={"v": i}
            )

        async def q(limit, flt):
            body = {"query_vector": [1, 0, 0, 0], "limit": limit}
            if flt:
                body["filter_metadata"] = flt
            resp = await client.post("/api/v1/vectors/search", json=body)
            return (await resp.json())["results"]

        r1, r2 = await asyncio.gather(q(1, None), q(5, {"v": {"$lt": 4}}))
        assert len(r1) == 1
        assert all(h["metadata"]["v"] < 4 for h in r2)
        await client.close()


class TestVisualize:
    async def test_visualize_html_json_png(self, temp_dir):
        client, db = await make_client(temp_dir)
        rng = np.random.default_rng(0)
        for i in range(20):
            await db.vector_store_async(
                rng.standard_normal(4).tolist(), {"g": i % 2}, f"v{i}"
            )
        resp = await client.get("/api/v1/visualize")
        assert resp.status == 200
        html = await resp.text()
        assert resp.content_type == "text/html"
        assert "WDBX live dashboard" in html and "<canvas" in html
        resp = await client.get("/api/v1/visualize?format=json")
        spec = await resp.json()
        assert len(spec["points"]) == 20 and spec["components"] == 2
        resp = await client.get("/api/v1/visualize?format=png")
        body = await resp.json()
        import base64

        png = base64.b64decode(body["image_base64"])
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        await client.close()

    async def test_visualize_dashboard_controls_round_trip(self, temp_dir):
        """The reference Dash app's controls (method / components /
        filter — reference wdbx/utils/visualization.py:560-680) map to
        query params; the rendered page echoes the selected state."""
        client, db = await make_client(temp_dir)
        rng = np.random.default_rng(0)
        for i in range(24):
            await db.vector_store_async(
                rng.standard_normal(4).tolist(),
                {"source": "web" if i % 2 else "file"}, f"v{i}"
            )
        # t-SNE + 3D + key=value filter
        resp = await client.get(
            "/api/v1/visualize?method=tsne&components=3&filter=source=web"
        )
        assert resp.status == 200
        html = await resp.text()
        assert 'name="method"' in html and 'name="components"' in html
        assert '<option value="tsne" selected' in html
        assert '<option value="3" selected' in html
        assert '"components": 3' in html
        # json format honors method/components/filter too
        resp = await client.get(
            "/api/v1/visualize?format=json&components=3"
            '&filter={"source": "web"}'
        )
        spec = await resp.json()
        assert spec["components"] == 3
        assert len(spec["points"]) == 12  # half match the filter
        assert len(spec["points"][0]) == 3
        # validation
        resp = await client.get("/api/v1/visualize?method=lle")
        assert resp.status == 400
        resp = await client.get("/api/v1/visualize?components=5")
        assert resp.status == 400
        resp = await client.get("/api/v1/visualize?filter=no-equals-sign")
        assert resp.status == 400
        await client.close()

    async def test_visualize_empty_store_404(self, temp_dir):
        client, _ = await make_client(temp_dir)
        resp = await client.get("/api/v1/visualize")
        assert resp.status == 404
        resp = await client.get("/api/v1/visualize?format=bogus")
        assert resp.status in (400, 404)
        await client.close()


class TestWarmup:
    async def test_warmup_traces_batch_widths(self, temp_dir):
        client, db = await make_client(temp_dir)
        rng = np.random.default_rng(0)
        for i in range(20):
            db.vector_store(rng.standard_normal(4).tolist(), id=f"w{i}")
        server = WDBXAPIServer(db)
        n = await server.warmup()
        assert n == 1  # one width: nothing compiles per batch width
        # empty store short-circuits
        db2 = WDBX(vector_dimension=4, data_dir=temp_dir + "/e",
                   enable_plugins=False)
        assert await WDBXAPIServer(db2).warmup() == 0
        await client.close()


class TestOpsRoutes:
    async def test_metrics_prometheus_format(self, temp_dir):
        client, db = await make_client(temp_dir)
        db.vector_store([1, 0, 0, 0], id="m1")
        await client.post(
            "/api/v1/vectors/search",
            json={"query_vector": [1, 0, 0, 0], "limit": 1},
        )
        resp = await client.get("/api/v1/metrics")
        assert resp.status == 200
        text = await resp.text()
        assert "wdbx_vector_count 1" in text
        assert 'wdbx_op_latency_ms{op="' in text
        assert "wdbx_batcher_requests" in text
        await client.close()

    async def test_save_route_checkpoints(self, temp_dir):
        client, db = await make_client(temp_dir)
        db.vector_store([0, 1, 0, 0], id="s1")
        resp = await client.post("/api/v1/save")
        assert (await resp.json())["saved"]
        # a fresh instance sees the checkpoint
        db2 = WDBX(vector_dimension=4, num_shards=2, data_dir=temp_dir,
                   enable_plugins=False)
        assert db2.get_vector("s1") is not None
        await client.close()


async def test_tune_endpoint(temp_dir):
    import numpy as np

    db = WDBX(vector_dimension=16, num_shards=1, data_dir=temp_dir,
              enable_plugins=False,
              config={"INDEX_TYPE": "ivf_clustered",
                      "IVF_TRAIN_THRESHOLD": 64, "IVF_NLIST": 4,
                      "IVF_NPROBE": 1})
    await db.initialize()
    server = WDBXAPIServer(db)
    client = TestClient(TestServer(server.app))
    await client.start_server()
    rng = np.random.default_rng(0)
    for i in range(200):
        v = rng.standard_normal(16)
        db.vector_store((v / np.linalg.norm(v)).tolist(), {"i": i}, f"v{i}")
    db.optimize()
    resp = await client.post("/api/v1/tune", json={"target_recall": 0.9})
    assert resp.status == 200
    report = await resp.json()
    assert report["achieved"] >= 0.9
    assert report["shards"]
    await client.close()


# -- the port's QueryBatcher -------------------------------------------------
def _port_store(tmp_path, n=100, dim=16, **over):
    from wdbx_tpu_torch.core.config import WDBXConfig
    from wdbx_tpu_torch.store.vector_store import VectorStore

    cfg = {"VECTOR_DIMENSION": dim, "DATA_DIR": str(tmp_path),
           "VECTOR_STORE_AUTOSAVE_INTERVAL": 0, "INDEX_TYPE": "flat"}
    cfg.update(over)
    store = VectorStore(WDBXConfig(cfg), device="cpu")
    r = np.random.default_rng(0)
    vecs = r.standard_normal((n, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
    store.bulk_load([f"v{i:04d}" for i in range(n)], vecs,
                    metadata_columns={"num": np.arange(n)})
    return store


def _queries(b, dim=16, seed=9):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, dim)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _ids(rows):
    return [[h[0] for h in row] for row in rows]


def test_batcher_uses_pipelined_path(tmp_path):
    """test_store_pipelined.py's batcher case, on the port."""
    import asyncio

    from wdbx_tpu_torch.api.batching import QueryBatcher

    store = _port_store(tmp_path)
    calls = {"submit": 0}
    orig = store.search_batch_submit

    def spy(*a, **kw):
        calls["submit"] += 1
        return orig(*a, **kw)

    store.search_batch_submit = spy
    q = _queries(6)

    async def run():
        batcher = QueryBatcher(store, max_batch=4, max_wait_ms=1.0)
        return await asyncio.gather(
            *(batcher.search(q[i], limit=3) for i in range(6))
        )

    hits = asyncio.run(run())
    assert calls["submit"] >= 1
    assert _ids(hits) == _ids(store.search_batch(q, limit=3))


@pytest.mark.parametrize("index_type", ["flat", "ivf_clustered"])
async def test_batcher_flush_longer_than_max_batch(tmp_path, index_type):
    """A burst of 10 against max_batch=4 whose flush gathers all 10
    (the first full batch's flush waits for the lock behind the other
    submissions): nothing is padded, and every caller gets its own row
    of a direct search_batch of its flush's queries (the clustered
    engine scans the union of a batch's probed blocks, so a query's
    answer depends on its batch)."""
    import asyncio

    from wdbx_tpu_torch.api.batching import QueryBatcher

    over = {}
    if index_type == "ivf_clustered":
        over = {"INDEX_TYPE": "ivf_clustered", "IVF_TRAIN_THRESHOLD": 64,
                "IVF_NLIST": 8, "IVF_NPROBE": 2}
    store = _port_store(tmp_path, n=400, **over)
    store.optimize()
    for index in store.indices:
        # a direct search of a batch whose blocks cover the corpus takes
        # the exact scan; the pipelined path (the batcher's) never does
        index.batch_flat_fallback = False
    sizes = []
    orig = store.search_batch_submit

    def spy(queries, *a, **kw):
        sizes.append(len(queries))
        return orig(queries, *a, **kw)

    store.search_batch_submit = spy
    q = _queries(10)
    batcher = QueryBatcher(store, max_batch=4, max_wait_ms=1000.0)
    await batcher._lock.acquire()
    tasks = [asyncio.ensure_future(batcher.search(q[i], limit=5))
             for i in range(10)]
    await asyncio.sleep(0)  # every search now waits on the lock
    batcher._lock.release()
    hits = await asyncio.wait_for(asyncio.gather(*tasks), 30)
    assert sizes == [10]
    assert batcher.get_stats()["avg_batch_size"] == 10
    assert _ids(hits) == _ids(store.search_batch(q, limit=5))
    # a burst longer than max_batch without the held lock: full batches
    hits = await asyncio.wait_for(asyncio.gather(
        *(batcher.search(q[i], limit=5) for i in range(10))), 30)
    assert sizes[1:] == [4, 4, 2]
    want = [row for lo, hi in ((0, 4), (4, 8), (8, 10))
            for row in store.search_batch(q[lo:hi], limit=5)]
    assert _ids(hits) == _ids(want)


async def test_batcher_flushes_a_query_that_arrives_mid_flush(tmp_path):
    """A query that arrives while the only flush awaits the device, with
    no query after it, is flushed by a timer of its own (the JAX
    batcher arms its timer only while no flush task runs, and leaves
    such a query waiting for a later arrival)."""
    import asyncio
    import threading

    from wdbx_tpu_torch.api.batching import QueryBatcher

    store = _port_store(tmp_path)
    orig = store.search_batch_submit
    entered, release = threading.Event(), threading.Event()

    def held(*a, **kw):
        entered.set()
        if not release.wait(30):
            raise TimeoutError("the test never released the first flush")
        return orig(*a, **kw)

    store.search_batch_submit = held
    q = _queries(2)
    batcher = QueryBatcher(store, max_batch=8, max_wait_ms=1.0)
    first = asyncio.ensure_future(batcher.search(q[0], limit=3))
    assert await asyncio.to_thread(entered.wait, 30)  # flush 1 in flight
    second = asyncio.ensure_future(batcher.search(q[1], limit=3))
    await asyncio.sleep(0.05)  # past max_wait: the second's timer fired
    store.search_batch_submit = orig
    release.set()
    hits = await asyncio.wait_for(asyncio.gather(first, second), 30)
    assert _ids(hits) == _ids(store.search_batch(q, limit=3))
    assert batcher.get_stats()["batches"] == 2


async def test_batcher_serves_through_concurrent_stores(tmp_path):
    """Stores land while batched searches are in flight. The stored rows
    live in the half of the space the queries do not touch (score 0), so
    every answer must equal the direct search_batch, whatever the order
    of the writes and the flushes."""
    import asyncio

    from wdbx_tpu_torch.api.batching import QueryBatcher

    dim = 16
    store = _port_store(tmp_path, n=300, dim=dim)
    r = np.random.default_rng(5)
    q = _queries(64, dim)
    q[:, dim // 2:] = 0.0
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    want = store.search_batch(q, limit=4)
    batcher = QueryBatcher(store, max_batch=8, max_wait_ms=1.0)

    async def writer(w):
        for i in range(10):
            v = np.zeros(dim, np.float32)
            v[dim // 2:] = r.standard_normal(dim // 2)
            await asyncio.to_thread(store.store, f"w{w}_{i}", v, {"w": w})

    async def searches():
        return await asyncio.gather(
            *(batcher.search(q[i], limit=4) for i in range(64))
        )

    got, *_ = await asyncio.wait_for(asyncio.gather(
        searches(), *(writer(w) for w in range(3))), 60)
    assert store.count() == 300 + 30
    assert _ids(got) == _ids(want)
    for g_row, w_row in zip(got, want):
        np.testing.assert_allclose([h[1] for h in g_row],
                                   [h[1] for h in w_row], atol=1e-6)
    assert _ids(store.search_batch(q, limit=4)) == _ids(want)
    assert batcher.get_stats()["batches"] < 64


# -- one request script, JAX-backed and port-backed --------------------------
PARITY_DIM = 8
PARITY_TOL = 1e-5


def _same_results(ref, got):
    """Hit lists agree: the same length (absent entries in the same
    places), similarities within PARITY_TOL, the same ids except where
    two candidates tie at the last place, equal metadata."""
    assert len(ref) == len(got)
    np.testing.assert_allclose([h["similarity"] for h in got],
                               [h["similarity"] for h in ref],
                               atol=PARITY_TOL, rtol=0)
    rs = {h["vector_id"]: h for h in ref}
    gs = {h["vector_id"]: h for h in got}
    edge = min((h["similarity"] for h in ref), default=0.0)
    for vid in set(rs) ^ set(gs):
        h = rs.get(vid) or gs.get(vid)
        assert abs(h["similarity"] - edge) <= PARITY_TOL, vid
    for vid in set(rs) & set(gs):
        assert rs[vid]["metadata"] == gs[vid]["metadata"]


async def _script(client):
    """Drive one server; returns every (request, status, body)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((60, PARITY_DIM)).astype(np.float32)
    q = rng.standard_normal((6, PARITY_DIM)).astype(np.float32)
    out = []

    async def call(method, path, body=None):
        resp = await client.request(method, path, json=body)
        data = await resp.json() if resp.status != 204 else None
        out.append(((method, path, body), resp.status, data))
        return data

    for i in range(60):
        await call("POST", "/api/v1/vectors",
                   {"vector": x[i].tolist(), "id": f"v{i}",
                    "metadata": {"g": i % 3, "n": i, "tag": f"t{i % 5}"}})
    searches = [{"query_vector": qq.tolist(), "limit": 5} for qq in q]
    searches += [
        {"query_vector": q[0].tolist(), "limit": 7,
         "filter_metadata": {"g": 1}},
        {"query_vector": q[1].tolist(), "limit": 7,
         "filter_metadata": {"n": {"$lt": 20}}},
        {"query_vector": q[2].tolist(), "limit": 100},  # past the count
        {"query_vector": q[3].tolist(), "limit": 10, "threshold": 0.3},
    ]
    # one at a time through each batcher: a query that reaches the JAX
    # batcher while its flush awaits the device waits for a later
    # arrival (the port's batcher arms a timer for it; see
    # test_batcher_flushes_a_query_that_arrives_mid_flush)
    for body in searches:
        await call("POST", "/api/v1/vectors/search", body)
    await call("POST", "/api/v1/vectors/search/batch",
               {"query_vectors": q.tolist(), "limit": 6})
    await call("POST", "/api/v1/vectors/search/batch",
               {"query_vectors": q.tolist(), "limit": 6,
                "filter_metadata": {"tag": "t2"}})
    await call("GET", "/api/v1/vectors/v3")
    await call("PUT", "/api/v1/vectors/v3/metadata",
               {"metadata": {"g": 9, "note": "moved"}})
    await call("GET", "/api/v1/vectors/v3")
    await call("DELETE", "/api/v1/vectors/v5")
    await call("DELETE", "/api/v1/vectors/v5")
    await call("GET", "/api/v1/vectors/v5")
    await call("POST", "/api/v1/vectors/search",
               {"query_vector": x[5].tolist(), "limit": 3})
    await call("POST", "/api/v1/vectors/search",
               {"query_vector": x[3].tolist(), "limit": 3,
                "filter_metadata": {"g": 9}})
    await call("POST", "/api/v1/vectors", {"vector": [1.0, 2.0]})
    await call("POST", "/api/v1/vectors/search", {"limit": 3})
    await call("GET", "/api/v1/stats")
    return out


async def test_api_matches_jax_server(temp_dir):
    from wdbx_tpu import WDBX as JWDBX
    from wdbx_tpu.api.server import WDBXAPIServer as JServer

    bodies = []
    for pkg, server_cls in ((JWDBX, JServer), (WDBX, WDBXAPIServer)):
        db = pkg(vector_dimension=PARITY_DIM, num_shards=2,
                 data_dir=f"{temp_dir}/{pkg.__module__}",
                 enable_plugins=False,
                 config={"VECTOR_STORE_AUTOSAVE_INTERVAL": 0})
        await db.initialize()
        client = TestClient(TestServer(server_cls(db).app))
        await client.start_server()
        try:
            bodies.append(await _script(client))
        finally:
            await client.close()
            await db.shutdown()
    ref, got = bodies
    assert len(ref) == len(got)
    for (req, rs, rb), (req2, gs, gb) in zip(ref, got):
        assert req == req2
        assert rs == gs, (req[:2], rs, gs)
        if req[1] == "/api/v1/stats":
            assert set(gb) == set(rb)
            for key in ("vector_count", "metadata_count",
                        "vector_dimension", "num_shards", "plugins",
                        "initialized", "raw_store"):
                assert gb[key] == rb[key], key
            assert gb["query_batching"]["requests"] == \
                rb["query_batching"]["requests"]
        elif rs == 200 and "results" in rb:
            rows = rb["results"]
            if rows and isinstance(rows[0], list):
                assert len(gb["results"]) == len(rows)
                for r_row, g_row in zip(rows, gb["results"]):
                    _same_results(r_row, g_row)
            else:
                _same_results(rows, gb["results"])
        elif rs == 200 and "vector" in rb:
            assert gb["vector_id"] == rb["vector_id"]
            assert gb["metadata"] == rb["metadata"]
            np.testing.assert_allclose(gb["vector"], rb["vector"],
                                       atol=1e-7, rtol=0)
        else:
            assert gb == rb, req[:2]
