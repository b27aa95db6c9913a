"""WDBX facade — the single public entry point.

Parity with the reference facade (reference wdbx/core/wdbx.py:21):
constructor knobs, two-phase init (sync ``__init__`` + async
``initialize()``), dimension validation raising ``ValueError``
(reference wdbx/core/wdbx.py:258-262), uuid4 ids (reference
wdbx/core/wdbx.py:265), merged stats (reference wdbx/core/wdbx.py:480-502),
and the full data surface sync + async.

Deliberately fixed from the reference: the store object lives at
``self.store`` so the *method* ``vector_store()`` is callable — the
reference shadows it with an attribute of the same name, breaking its
own documented sync API (reference wdbx/core/wdbx.py:120 vs :241-270).
``enable_gpu`` becomes ``device``: the torch device the shard indexes
live on — the CUDA device by default (raising when there is none),
``"cpu"`` on request.

Torch port of ``wdbx_tpu/core/wdbx.py``; plugins come from
``wdbx_tpu_torch.plugins``. ``enable_distributed`` builds a
``ShardEngine`` over the facade's device (``parallel/shard_engine.py``),
which ``heal()`` uses for liveness, recovery plans and re-meshing. With
``WDBX_COORDINATOR_ADDRESS`` set, the engine joins its group before the
store is built, so a sharded store lays its index on the global mesh
(every rank then makes the same calls, ``heal()`` included).
"""

from __future__ import annotations

import asyncio
import logging
import os
import uuid
from typing import Any

from wdbx_tpu_torch.core.config import WDBXConfig
from wdbx_tpu_torch.store.vector_store import SearchHit, VectorStore

logger = logging.getLogger("wdbx_tpu_torch")


class WDBX:
    """Vector database on a CUDA device (PyTorch)."""

    def __init__(
        self,
        vector_dimension: int | None = 384,
        num_shards: int | None = 1,
        data_dir: str | None = "./wdbx_data",
        config: dict[str, Any] | WDBXConfig | None = None,
        enable_plugins: bool = True,
        enable_distributed: bool = False,
        device: str | None = None,
        log_level: str = "INFO",
    ):
        self._setup_logging(log_level)
        if isinstance(config, WDBXConfig):
            self.config = config
        else:
            self.config = WDBXConfig(config)
        # Explicit constructor args override config-file/env values
        # (runtime wins, reference precedence wdbx/core/config.py:61-81);
        # pass None to defer to env/file config (the CLI does this so
        # WDBX_VECTOR_DIMENSION et al. are honored when flags are
        # omitted).
        if vector_dimension is not None:
            self.config.set("VECTOR_DIMENSION", vector_dimension)
        if num_shards is not None:
            self.config.set("NUM_SHARDS", num_shards)
        if data_dir is not None:
            self.config.set("DATA_DIR", data_dir)
        self.vector_dim = int(self.config.get("VECTOR_DIMENSION", 384))
        self.num_shards = int(self.config.get("NUM_SHARDS", 1))
        self.data_dir = str(self.config.get("DATA_DIR", "./wdbx_data"))
        data_dir = self.data_dir
        self.device = device
        self.enable_distributed = enable_distributed

        os.makedirs(data_dir, exist_ok=True)
        self.shard_engine = None
        if enable_distributed:
            from wdbx_tpu_torch.parallel.shard_engine import ShardEngine

            self.shard_engine = ShardEngine(self.config, device=device)
            # join the group (WDBX_COORDINATOR_ADDRESS) before the store
            # exists: a sharded index then lays out on the global mesh
            self.shard_engine.join()
        self.store = VectorStore(self.config, data_dir=data_dir, device=device)

        self.plugin_manager = None
        if enable_plugins and self.config.get("PLUGINS_ENABLED", True):
            from wdbx_tpu_torch.plugins import load_plugins

            self.plugin_manager = load_plugins(self)

        self._initialized = False

    def _setup_logging(self, log_level: str) -> None:
        root = logging.getLogger()
        if not root.handlers:
            logging.basicConfig(
                level=getattr(logging, log_level.upper(), logging.INFO),
                format="%(asctime)s %(name)s %(levelname)s %(message)s",
            )

    # -- lifecycle ---------------------------------------------------------
    async def initialize(self) -> None:
        """Concurrent async init of store, plugins and shard engine
        (parity: reference wdbx/core/wdbx.py:151-173)."""
        if self._initialized:
            return
        tasks = [self.store.initialize()]
        if self.plugin_manager:
            tasks.append(self.plugin_manager.initialize_all())
        if self.shard_engine:
            tasks.append(self.shard_engine.initialize())
        await asyncio.gather(*tasks)
        self._initialized = True

    async def shutdown(self) -> None:
        tasks = [self.store.shutdown()]
        if self.plugin_manager:
            tasks.append(self.plugin_manager.shutdown_all())
        await asyncio.gather(*tasks)
        # after the store's final save: on a mesh spanning ranks that
        # save is collective, and the engine leaves the group
        if self.shard_engine:
            await self.shard_engine.shutdown()
        self._initialized = False

    # -- validation --------------------------------------------------------
    def _check_dim(self, vector: Any) -> None:
        if len(vector) != self.vector_dim:
            raise ValueError(
                f"Vector dimension mismatch: expected {self.vector_dim}, "
                f"got {len(vector)}"
            )

    # -- data surface (sync) -------------------------------------------------
    def vector_store(
        self,
        vector: list[float],
        metadata: dict[str, Any] | None = None,
        id: str | None = None,
    ) -> str:
        self._check_dim(vector)
        vector_id = id or str(uuid.uuid4())
        self.store.store(vector_id, vector, metadata)
        return vector_id

    def vector_search(
        self,
        query_vector: list[float],
        limit: int = 10,
        threshold: float = 0.0,
        filter_metadata: dict[str, Any] | None = None,
    ) -> list[SearchHit]:
        self._check_dim(query_vector)
        return self.store.search(
            query_vector, limit=limit, threshold=threshold,
            filter_metadata=filter_metadata,
        )

    def vector_search_batch(
        self,
        query_vectors: Any,
        limit: int = 10,
        threshold: float = 0.0,
        filter_metadata: dict[str, Any] | None = None,
    ) -> list[list[SearchHit]]:
        """Batched search: one kernel launch pair scores the whole query
        batch."""
        return self.store.search_batch(
            query_vectors, limit=limit, threshold=threshold,
            filter_metadata=filter_metadata,
        )

    def batch_store(
        self,
        vectors: dict[str, list[float]],
        metadata: dict[str, dict[str, Any]] | None = None,
    ) -> int:
        for vec in vectors.values():
            self._check_dim(vec)
        return self.store.batch_store(vectors, metadata)

    def get_vector(
        self, vector_id: str
    ) -> tuple[list[float], dict[str, Any]] | None:
        return self.store.get(vector_id)

    def delete_vector(self, vector_id: str) -> bool:
        return self.store.delete(vector_id)

    def update_metadata(self, vector_id: str, metadata: dict[str, Any]) -> bool:
        return self.store.update_metadata(vector_id, metadata)

    def count_vectors(self) -> int:
        return self.store.count()

    def clear(self) -> int:
        return self.store.clear()

    def tune(self, target_recall: float = 0.95) -> dict[str, Any]:
        """Tune ANN shards' probe counts to a recall target against
        their own exact oracles (stored vectors as the query sample)."""
        return self.store.tune(target_recall)

    def optimize(self, background: bool | None = None) -> bool:
        return self.store.optimize(background)

    def heal(self, allow_remesh: bool | None = None) -> dict[str, Any]:
        """Failure detection + checkpoint recovery: probe every mesh
        position, and re-host any shard whose primary is unhealthy from
        its last checkpoint (consuming the ShardEngine's replica plan).

        ``allow_remesh`` (default: config ``MESH_AUTO_REMESH``) escalates
        to LIVE RE-MESHING when positions stay unhealthy: sharded indexes
        re-stripe onto a mesh of only the surviving positions (slot ids
        are mesh-independent, so the store's registries are untouched)
        and serving continues degraded. Once every position of the mesh
        the engine started on answers again, a later ``heal`` with
        ``allow_remesh`` re-stripes back onto it
        (``ShardEngine.restored_mesh``).

        On a global mesh every rank calls ``heal`` and every layer runs
        on every rank in step: the integrity verdicts are agreed
        (``store.verify``), the health map is gathered, so every rank
        derives the same plan and degraded mesh, a live remesh raises on
        every rank together or on none, and each rank then takes the
        same branch (``rehost``: ``"live"`` or ``"cold"`` a store
        shard). A rank whose positions are all down is left without one
        on the degraded mesh and keeps serving: it joins every
        collective with empty blocks, and answers as the others do. A
        lost process ends the group (an elastic restart, not ported:
        ``ROADMAP.md`` queue 1)."""
        # Layer 1: bookkeeping integrity — registry / index divergence
        # (state corruption with healthy devices) recovers per shard.
        integrity = self.store.verify()
        recovered = []
        unrecovered = []
        for entry in integrity["shards"]:
            if not entry["ok"]:
                # state is already inconsistent: clearing on a failed
                # restore is acceptable (consistent-but-empty beats torn)
                if self.store.recover(entry["shard"], clear_on_failure=True):
                    recovered.append(entry["shard"])
                else:
                    unrecovered.append(entry["shard"])
        if self.shard_engine is None:
            integrity["recovered_shards"] = recovered
            integrity["unrecovered_shards"] = unrecovered
            return integrity
        # Layer 2: position liveness — a dead position can hold rows of
        # EVERY store shard (slabs stripe over the whole mesh), so a
        # non-empty plan re-hosts all shards from their checkpoints. The
        # plan keys are mesh positions, NOT store shards.
        health = self.shard_engine.health_check()
        plan = self.shard_engine.plan_recovery(health)
        if allow_remesh is None:
            allow_remesh = bool(self.config.get("MESH_AUTO_REMESH", False))
        remeshed_to: list[str] = []
        rehost: dict[str, str] = {}
        # Layer 3 runs FIRST when positions are unreachable: re-hosting
        # onto the old mesh would write to the dead device. The re-mesh
        # moves live data when the "dead" position still answers, and
        # falls back to a cold re-host (empty tensors on the survivors +
        # checkpoint reload) when it does not.
        target = None
        if allow_remesh:
            # down positions: the survivors; none: the way back, once the
            # positions a degraded mesh left out answer again
            target = (self.shard_engine.degraded_mesh(health) if plan
                      else self.shard_engine.restored_mesh())
        if target is not None and target is not self.shard_engine.mesh:
            for shard, index in enumerate(self.store.indices):
                if not hasattr(index, "remesh"):
                    continue
                try:
                    index.remesh(target)
                    rehost[str(shard)] = "live"
                except Exception:
                    # old mesh unreachable: cold re-host from disk
                    logger.warning("live remesh of shard %d failed; "
                                   "re-hosting it cold", shard,
                                   exc_info=True)
                    rehost[str(shard)] = "cold"
                    try:
                        index.adopt_mesh(target)
                        if not self.store.recover(
                            shard, clear_on_failure=False
                        ):
                            unrecovered.append(shard)
                    except Exception:
                        unrecovered.append(shard)
            self.shard_engine.adopt_mesh(target)
            remeshed_to = list(target.names)
        if plan and not remeshed_to:
            for shard in range(len(self.store.indices)):
                if shard in recovered:
                    continue
                # a flapping position must never wipe live unsaved rows:
                # restore only when a checkpoint actually loads, and a
                # dead device must not abort the whole heal
                try:
                    ok = self.store.recover(shard, clear_on_failure=False)
                except Exception:
                    ok = False
                if ok:
                    recovered.append(shard)
                else:
                    unrecovered.append(shard)
        return {
            "healthy": health["healthy"] and integrity["consistent"],
            "devices": health["devices"],
            "integrity": integrity["shards"],
            "device_plan": {str(s): t for s, t in plan.items()},
            "recovered_shards": recovered,
            "unrecovered_shards": unrecovered,
            "remeshed_to": remeshed_to,
            "rehost": rehost,
        }

    # -- data surface (async) ------------------------------------------------
    async def vector_store_async(
        self,
        vector: list[float],
        metadata: dict[str, Any] | None = None,
        id: str | None = None,
    ) -> str:
        self._check_dim(vector)
        vector_id = id or str(uuid.uuid4())
        await self.store.store_async(vector_id, vector, metadata)
        return vector_id

    async def vector_search_async(
        self,
        query_vector: list[float],
        limit: int = 10,
        threshold: float = 0.0,
        filter_metadata: dict[str, Any] | None = None,
    ) -> list[SearchHit]:
        self._check_dim(query_vector)
        return await self.store.search_async(
            query_vector, limit=limit, threshold=threshold,
            filter_metadata=filter_metadata,
        )

    async def vector_search_batch_async(
        self,
        query_vectors: Any,
        limit: int = 10,
        threshold: float = 0.0,
        filter_metadata: dict[str, Any] | None = None,
    ) -> list[list[SearchHit]]:
        return await self.store.search_batch_async(
            query_vectors, limit=limit, threshold=threshold,
            filter_metadata=filter_metadata,
        )

    async def batch_store_async(
        self,
        vectors: dict[str, list[float]],
        metadata: dict[str, dict[str, Any]] | None = None,
    ) -> int:
        for vec in vectors.values():
            self._check_dim(vec)
        return await self.store.batch_store_async(vectors, metadata)

    async def get_vector_async(self, vector_id: str):
        return await self.store.get_async(vector_id)

    async def delete_vector_async(self, vector_id: str) -> bool:
        return await self.store.delete_async(vector_id)

    async def update_metadata_async(
        self, vector_id: str, metadata: dict[str, Any]
    ) -> bool:
        return await self.store.update_metadata_async(vector_id, metadata)

    async def clear_async(self) -> int:
        return await self.store.clear_async()

    async def tune_async(self, target_recall: float = 0.95):
        return await self.store.tune_async(target_recall)

    async def optimize_async(self, background: bool | None = None) -> bool:
        return await self.store.optimize_async(background)

    # -- drop-in attributes --------------------------------------------------
    @property
    def version(self) -> str:
        """Parity: reference exposes ``wdbx.version`` (reference
        wdbx/core/wdbx.py:62, used by its API server)."""
        from wdbx_tpu_torch import __version__

        return __version__

    @property
    def plugins(self) -> dict:
        """Parity: reference exposes ``wdbx.plugins`` as a name→plugin
        dict (reference wdbx/core/wdbx.py:82)."""
        if self.plugin_manager is None:
            return {}
        return dict(self.plugin_manager.plugins)

    # -- plugins ------------------------------------------------------------
    def get_plugin(self, name: str):
        if self.plugin_manager is None:
            return None
        return self.plugin_manager.get(name)

    def register_plugin(self, plugin) -> None:
        if self.plugin_manager is None:
            from wdbx_tpu_torch.plugins import PluginManager

            self.plugin_manager = PluginManager(self)
        self.plugin_manager.register(plugin)

    # -- stats ---------------------------------------------------------------
    def get_stats(self) -> dict[str, Any]:
        from wdbx_tpu_torch import __version__

        stats = {
            "version": __version__,
            "vector_dimension": self.vector_dim,
            "num_shards": self.num_shards,
            "data_dir": self.data_dir,
            "initialized": self._initialized,
            "plugins": (
                sorted(self.plugin_manager.plugins) if self.plugin_manager else []
            ),
        }
        stats.update(self.store.get_stats())
        if self.shard_engine:
            stats["shard_engine"] = self.shard_engine.get_stats()
        return stats
