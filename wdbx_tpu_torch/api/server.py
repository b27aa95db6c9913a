"""REST API server.

Route-for-route parity with the reference FastAPI app (reference
wdbx/api/server.py:104-278): the same 13 ``/api/v1`` endpoints with the
same request/response JSON shapes, optional ``X-API-Key`` auth
(reference wdbx/api/server.py:87-101) and CORS. Built on aiohttp.web
(FastAPI/uvicorn are not dependencies; aiohttp is) — and built ONCE:
the reference constructs every route twice, verbatim, in ``__init__``
and again in ``initialize()`` (reference wdbx/api/server.py:69-278 vs
:280-490); here ``initialize()`` is idempotent.

Extensions beyond the reference: ``POST /vectors/search/batch`` exposes
the batched query path (one kernel launch pair for the whole batch).

Torch port of ``wdbx_tpu/api/server.py``: the same routes and JSON
shapes over the port's facade. An engine or kernel error is answered
with a 500 by the middleware; no handler carries on from a plain path.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
from typing import TYPE_CHECKING, Any

from aiohttp import web

if TYPE_CHECKING:
    from wdbx_tpu_torch.core.wdbx import WDBX

logger = logging.getLogger("wdbx_tpu_torch.api")

from wdbx_tpu_torch.plugins import (  # noqa: E402 (re-export for compat)
    EMBEDDING_PLUGIN_PRIORITY,
    iter_embedding_plugins,
)


def _json_error(status: int, detail: str) -> web.Response:
    return web.json_response({"detail": detail}, status=status)


class WDBXAPIServer:
    """aiohttp application exposing the WDBX facade."""

    def __init__(
        self,
        wdbx: "WDBX",
        host: str | None = None,
        port: int | None = None,
        api_key: str | None = None,
        cors_origins: list[str] | None = None,
    ):
        self.wdbx = wdbx
        cfg = wdbx.config
        self.host = host or cfg.get("API_HOST", "127.0.0.1")
        self.port = int(port or cfg.get("API_PORT", 8000))
        self.api_key = api_key if api_key is not None else cfg.get("API_KEY")
        self.cors_origins = (
            cors_origins
            if cors_origins is not None
            else cfg.get_typed("API_CORS_ORIGINS", list, default=None)
        )
        self.batcher = None
        if cfg.get("API_BATCHING", True):
            from wdbx_tpu_torch.api.batching import QueryBatcher

            self.batcher = QueryBatcher(
                wdbx.store,
                max_batch=int(cfg.get("API_BATCH_MAX", 128)),
                max_wait_ms=float(cfg.get("API_BATCH_WAIT_MS", 3.0)),
            )
        self.app = self._build_app()
        self._runner: web.AppRunner | None = None
        self._thread: threading.Thread | None = None
        self._thread_loop: asyncio.AbstractEventLoop | None = None

    # -- app construction --------------------------------------------------
    def _build_app(self) -> web.Application:
        app = web.Application(middlewares=[self._auth_middleware])
        r = app.router
        p = "/api/v1"
        r.add_get(f"{p}/health", self.health)
        r.add_post(f"{p}/vectors", self.store_vector)
        r.add_post(f"{p}/vectors/search", self.search_vectors)
        r.add_post(f"{p}/vectors/search/batch", self.search_vectors_batch)
        r.add_get(f"{p}/vectors/{{vector_id}}", self.get_vector)
        r.add_delete(f"{p}/vectors/{{vector_id}}", self.delete_vector)
        r.add_put(f"{p}/vectors/{{vector_id}}/metadata", self.update_metadata)
        r.add_get(f"{p}/stats", self.get_stats)
        r.add_post(f"{p}/clear", self.clear_database)
        r.add_post(f"{p}/embeddings", self.create_embedding)
        r.add_post(f"{p}/embeddings/batch", self.create_embeddings_batch)
        r.add_get(f"{p}/plugins", self.list_plugins)
        r.add_get(f"{p}/plugins/{{plugin_name}}", self.get_plugin_info)
        r.add_get(f"{p}/visualize", self.visualize)
        r.add_get(f"{p}/metrics", self.metrics)
        r.add_post(f"{p}/save", self.save_checkpoint)
        r.add_post(f"{p}/tune", self.tune_indexes)
        if self.cors_origins:
            # Browser preflight: aiohttp 405s unrouted OPTIONS, which
            # breaks clients sending X-API-Key or using PUT/DELETE.
            r.add_route("OPTIONS", "/{tail:.*}", self._preflight)
        return app

    def _cors_allowed(self, request: web.Request) -> str | None:
        if not self.cors_origins:
            return None
        if "*" in self.cors_origins:
            return "*"
        origin = request.headers.get("Origin")
        return origin if origin in self.cors_origins else None

    async def _preflight(self, request: web.Request) -> web.Response:
        resp = web.Response(status=204)
        allowed = self._cors_allowed(request)
        if allowed:
            resp.headers["Access-Control-Allow-Origin"] = allowed
            resp.headers["Access-Control-Allow-Methods"] = (
                "GET, POST, PUT, DELETE, OPTIONS"
            )
            resp.headers["Access-Control-Allow-Headers"] = (
                "Content-Type, X-API-Key"
            )
            resp.headers["Access-Control-Max-Age"] = "600"
        return resp

    @web.middleware
    async def _auth_middleware(self, request: web.Request, handler):
        if request.method == "OPTIONS":
            return await handler(request)  # preflight is unauthenticated
        if self.api_key and request.path != "/api/v1/health":
            import hmac

            # bytes on both sides: compare_digest raises TypeError on
            # non-ASCII str input (remote-triggerable 500), and env
            # config may type-infer the key to an int
            supplied = request.headers.get("X-API-Key", "").encode(
                "utf-8", "surrogateescape"
            )
            expected = str(self.api_key).encode("utf-8")
            if not hmac.compare_digest(supplied, expected):
                return _json_error(401, "Invalid or missing API key")
        try:
            response = await handler(request)
        except web.HTTPException:
            raise
        except ValueError as e:
            response = _json_error(400, str(e))
        except Exception as e:
            logger.exception("unhandled API error")
            response = _json_error(500, str(e))
        allowed = self._cors_allowed(request)
        if allowed:
            response.headers["Access-Control-Allow-Origin"] = allowed
        return response

    # -- handlers ----------------------------------------------------------
    async def health(self, request: web.Request) -> web.Response:
        from wdbx_tpu_torch import __version__

        return web.json_response({"status": "healthy", "version": __version__})

    async def store_vector(self, request: web.Request) -> web.Response:
        data = await request.json()
        if "vector" not in data:
            return _json_error(422, "field 'vector' is required")
        vector_id = await self.wdbx.vector_store_async(
            data["vector"], data.get("metadata"), data.get("id")
        )
        return web.json_response({"vector_id": vector_id})

    async def search_vectors(self, request: web.Request) -> web.Response:
        data = await request.json()
        if "query_vector" not in data:
            return _json_error(422, "field 'query_vector' is required")
        if len(data["query_vector"]) != self.wdbx.vector_dim:
            return _json_error(
                400,
                f"Vector dimension mismatch: expected {self.wdbx.vector_dim}",
            )
        if self.batcher is not None:
            # coalesce concurrent requests into one device batch
            results = await self.batcher.search(
                data["query_vector"],
                data.get("limit", 10),
                data.get("threshold", 0.0),
                data.get("filter_metadata"),
            )
        else:
            results = await self.wdbx.vector_search_async(
                data["query_vector"],
                data.get("limit", 10),
                data.get("threshold", 0.0),
                data.get("filter_metadata"),
            )
        return web.json_response(
            {
                "results": [
                    {"vector_id": vid, "similarity": sim, "metadata": meta}
                    for vid, sim, meta in results
                ]
            }
        )

    async def search_vectors_batch(self, request: web.Request) -> web.Response:
        data = await request.json()
        if "query_vectors" not in data:
            return _json_error(422, "field 'query_vectors' is required")
        batches = await self.wdbx.vector_search_batch_async(
            data["query_vectors"],
            data.get("limit", 10),
            data.get("threshold", 0.0),
            data.get("filter_metadata"),
        )
        return web.json_response(
            {
                "results": [
                    [
                        {"vector_id": vid, "similarity": sim, "metadata": meta}
                        for vid, sim, meta in hits
                    ]
                    for hits in batches
                ]
            }
        )

    async def get_vector(self, request: web.Request) -> web.Response:
        vector_id = request.match_info["vector_id"]
        result = await self.wdbx.get_vector_async(vector_id)
        if result is None:
            return _json_error(404, f"Vector with ID {vector_id} not found")
        vector, metadata = result
        return web.json_response(
            {"vector_id": vector_id, "vector": vector, "metadata": metadata}
        )

    async def delete_vector(self, request: web.Request) -> web.Response:
        vector_id = request.match_info["vector_id"]
        if not await self.wdbx.delete_vector_async(vector_id):
            return _json_error(404, f"Vector with ID {vector_id} not found")
        return web.json_response({"success": True})

    async def update_metadata(self, request: web.Request) -> web.Response:
        vector_id = request.match_info["vector_id"]
        data = await request.json()
        if "metadata" not in data:
            return _json_error(422, "field 'metadata' is required")
        if not await self.wdbx.update_metadata_async(vector_id, data["metadata"]):
            return _json_error(404, f"Vector with ID {vector_id} not found")
        return web.json_response({"success": True})

    async def get_stats(self, request: web.Request) -> web.Response:
        stats = self.wdbx.get_stats()
        if self.batcher is not None:
            stats["query_batching"] = self.batcher.get_stats()
        return web.json_response(stats)

    async def clear_database(self, request: web.Request) -> web.Response:
        count = await self.wdbx.clear_async()
        return web.json_response({"removed_vectors": count})

    def _embedding_plugins(self):
        return iter_embedding_plugins(self.wdbx.plugin_manager)

    async def create_embedding(self, request: web.Request) -> web.Response:
        data = await request.json()
        if "text" not in data:
            return _json_error(422, "field 'text' is required")
        for plugin in self._embedding_plugins():
            try:
                embedding = await plugin.create_embedding(data["text"])
                return web.json_response({"embedding": list(embedding)})
            except Exception as e:
                logger.error("embedding via %s failed: %s", plugin.name, e)
        return _json_error(501, "No embedding plugin available")

    async def create_embeddings_batch(self, request: web.Request) -> web.Response:
        data = await request.json()
        if "texts" not in data:
            return _json_error(422, "field 'texts' is required")
        for plugin in self._embedding_plugins():
            try:
                embeddings = await plugin.create_embeddings_batch(data["texts"])
                return web.json_response(
                    {"embeddings": [list(e) for e in embeddings]}
                )
            except Exception as e:
                logger.error("batch embedding via %s failed: %s", plugin.name, e)
        return _json_error(501, "No embedding plugin available")

    async def list_plugins(self, request: web.Request) -> web.Response:
        manager = self.wdbx.plugin_manager
        plugins = manager.plugins.values() if manager else []
        return web.json_response(
            {
                "plugins": [
                    {
                        "name": p.name,
                        "description": p.description,
                        "version": p.version,
                    }
                    for p in plugins
                ]
            }
        )

    async def get_plugin_info(self, request: web.Request) -> web.Response:
        name = request.match_info["plugin_name"]
        manager = self.wdbx.plugin_manager
        plugin = manager.get(name) if manager else None
        if plugin is None:
            return _json_error(404, f"Plugin {name} not found")
        return web.json_response(
            {
                "name": plugin.name,
                "description": plugin.description,
                "version": plugin.version,
                "stats": plugin.get_stats(),
            }
        )

    async def metrics(self, request: web.Request) -> web.Response:
        """Prometheus text-format metrics: per-op latency percentiles,
        counts, corpus size, and batcher coalescing stats — the pull
        endpoint a production scrape loop needs (the JSON equivalent
        lives in GET /stats)."""
        lines = [
            "# TYPE wdbx_vector_count gauge",
            f"wdbx_vector_count {self.wdbx.count_vectors()}",
        ]
        for op, st in self.wdbx.store.metrics.summary().items():
            safe = op.replace("-", "_")
            lines.append(f'wdbx_op_count{{op="{safe}"}} {st["count"]}')
            for q in ("p50_ms", "p95_ms", "p99_ms", "mean_ms"):
                lines.append(
                    f'wdbx_op_latency_ms{{op="{safe}",stat="{q[:-3]}"}} '
                    f'{st[q]}'
                )
        if self.batcher is not None:
            for key, val in self.batcher.stats.items():
                lines.append(f"wdbx_batcher_{key} {val}")
        return web.Response(
            text="\n".join(lines) + "\n",
            content_type="text/plain",
        )

    async def save_checkpoint(self, request: web.Request) -> web.Response:
        """Trigger a full checkpoint (ops endpoint; heal() restores from
        the latest one)."""
        await asyncio.to_thread(self.wdbx.store.save)
        return web.json_response({"saved": True})

    async def tune_indexes(self, request: web.Request) -> web.Response:
        """Tune ANN probe counts to a recall target (ops endpoint)."""
        try:
            data = await request.json()
        except Exception:
            data = {}
        if not isinstance(data, dict):
            return _json_error(422, "body must be a JSON object")
        try:
            target = float(data.get("target_recall", 0.95))
        except (TypeError, ValueError):
            return _json_error(422, "target_recall must be a number")
        if not (0.0 < target <= 1.0):
            return _json_error(422, "target_recall must be in (0, 1]")
        report = await self.wdbx.tune_async(target)
        return web.json_response(report)

    async def visualize(self, request: web.Request) -> web.Response:
        """Live dashboard / plot data from current store contents.
        ?format=html (interactive page, default) | json (plot spec) |
        png (base64), with the reference Dash app's control set as query
        params: ?method=pca|tsne|umap &components=2|3
        &filter=key=value|{json} &max_vectors=N (reference
        wdbx/utils/visualization.py:525-818, controls :560-680), served
        by the existing API instead of a second dash server."""
        from wdbx_tpu_torch.utils.visualization import VectorVisualizer

        fmt = request.query.get("format", "html")
        method = request.query.get("method", "pca").lower().replace("-", "")
        if method not in ("pca", "tsne", "umap"):
            return _json_error(400, f"unknown method: {method}")
        try:
            max_vectors = int(request.query.get("max_vectors", 500))
            components = int(request.query.get("components", 2))
        except ValueError:
            return _json_error(
                400, "max_vectors/components must be integers"
            )
        if components not in (2, 3):
            return _json_error(400, "components must be 2 or 3")
        filt_raw = request.query.get("filter", "").strip()
        filter_metadata = None
        if filt_raw:
            try:  # JSON dict, else a single key=value shorthand
                filter_metadata = json.loads(filt_raw)
                if not isinstance(filter_metadata, dict):
                    raise ValueError
            except ValueError:
                if "=" not in filt_raw:
                    return _json_error(
                        400, "filter must be key=value or a JSON object"
                    )
                key, _, value = filt_raw.partition("=")
                filter_metadata = {key.strip(): value.strip()}
        viz = VectorVisualizer(self.wdbx)
        try:
            if fmt == "html":
                html = await asyncio.to_thread(
                    viz.dashboard_html, max_vectors, method=method,
                    components=components, filter_metadata=filter_metadata,
                )
                return web.Response(text=html, content_type="text/html")
            vectors, ids, _ = await asyncio.to_thread(
                viz._pull_vectors, max_vectors, filter_metadata
            )
            if fmt == "json":
                spec = await asyncio.to_thread(
                    viz.scatter_data, vectors, ids,
                    method, components,
                )
                return web.json_response(spec)
            if fmt == "png":
                fig = await asyncio.to_thread(
                    viz.scatter_plot, vectors, None, method, components
                )
                b64 = viz.to_base64_png(fig)
                return web.json_response({"image_base64": b64})
        except ValueError as e:
            return _json_error(404, str(e))
        return _json_error(400, f"unknown format: {fmt}")

    # -- lifecycle ---------------------------------------------------------
    async def initialize(self) -> None:
        """Idempotent; the app is already built."""

    async def warmup(self, k: int = 10) -> int:
        """Serve one batch at the batcher's coalesce limit before taking
        traffic, so that the first live request does not pay the
        kernels' build at first use and the device libraries' set-up.
        Nothing compiles per batch width in the port, so one width is
        served. Delegates to ``VectorStore.warm``; returns the number of
        widths served (1; 0 on an empty store). Enabled by
        API_WARMUP=true or the ``warm`` flag of ``cli serve``."""
        max_b = self.batcher.max_batch if self.batcher else 64
        n = await asyncio.to_thread(
            self.wdbx.store.warm, max_b, k
        )
        logger.info("warmed %d batch width(s) (limit %d)", n, max_b)
        return n

    async def start(self) -> None:
        # warm BEFORE the socket opens: a load balancer health-checking
        # the port must not mark the instance ready mid-build
        if self.wdbx.config.get("API_WARMUP", False):
            await self.warmup()
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        logger.info("API server listening on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None

    async def serve_forever(self) -> None:
        await self.start()
        try:
            while True:
                await asyncio.sleep(3600)
        finally:
            await self.stop()

    def start_in_thread(self) -> threading.Thread:
        """Daemon thread with its own event loop (parity: reference
        wdbx/api/server.py:523-539)."""

        def run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._thread_loop = loop
            loop.run_until_complete(self.start())
            loop.run_forever()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self._thread

    def stop_thread(self) -> None:
        loop = self._thread_loop
        if loop is not None:
            asyncio.run_coroutine_threadsafe(self.stop(), loop).result(timeout=10)
            loop.call_soon_threadsafe(loop.stop)
