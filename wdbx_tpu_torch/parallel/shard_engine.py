"""Shard control plane.

Torch port of ``wdbx_tpu/parallel/shard_engine.py``: the topology, the
shard -> position placement, the replication factor and liveness, as
small host-side JSON state. The data plane is not here: a sharded search
is one process launching each shard's scan on its own device and merging
the partials (``parallel/sharded_flat.py``).

Hosts join through ``torch.distributed`` when ``WDBX_COORDINATOR_ADDRESS``
is set (with ``WDBX_NUM_PROCESSES`` and ``WDBX_PROCESS_ID``), the
counterpart of ``jax.distributed.initialize``. The group is gloo. Once
joined, the default mesh is global (``parallel/mesh.py``): it lists
every rank's positions, a shard is local to the rank that owns its
position, the health probe runs on a rank's own positions and the ranks
exchange the statuses, so every rank holds the same map and derives
the same degraded mesh from it: the survivors keep their names and
owners, and the ranks own unequal blocks of it, or none (a rank whose
positions are all down keeps joining every collective with empty
blocks). Once the positions answer again, ``restored_mesh`` gives the
mesh the engine started on back. A lost rank ends a gloo group, as a
lost process ends ``jax.distributed``: recovering from it is an
elastic restart, not ported (``ROADMAP.md`` queue 1).

Every map here is keyed on the mesh's position names (``"cuda:0#3"``),
never on ``str(device)``: positions of one card share their device.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import socket
import time
from typing import Any

import torch

from wdbx_tpu_torch.parallel import collective
from wdbx_tpu_torch.parallel.mesh import Mesh, make_mesh

logger = logging.getLogger("wdbx_tpu_torch.parallel")

#: seconds init_process_group waits for the other processes (and the
#: group's collectives for each other)
JOIN_TIMEOUT_S = 120


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


class ShardEngine:
    """Owns the device mesh and shard placement metadata."""

    def __init__(self, config: Any, mesh: Mesh | None = None,
                 device: Any = None):
        self.config = config
        self.axis = str(config.get("MESH_AXIS", "shard"))
        self.replication_factor = int(
            config.get("DISTRIBUTED_REPLICATION_FACTOR", 1)
        )
        self.node_id = f"{socket.gethostname()}_{int(time.time())}"
        self.mesh = mesh
        #: the mesh the engine started on (``restored_mesh``)
        self.home = mesh
        #: where ``make_mesh`` lays the default mesh (None: the CUDA devices)
        self.device = device
        self._initialized = False
        self._joined = False  # this engine created the process group

    def _mesh(self) -> Mesh:
        if self.mesh is None:
            self.mesh = make_mesh(axis=self.axis, device=self.device)
        if self.home is None:
            self.home = self.mesh
        return self.mesh

    def join(self) -> None:
        """Join the group that ``WDBX_COORDINATOR_ADDRESS`` names, if it
        is set and no group is up yet. ``WDBX`` joins before it builds
        its store, so a sharded index lays out on the global mesh."""
        import torch.distributed as dist

        coord = os.environ.get("WDBX_COORDINATOR_ADDRESS")
        if coord and dist.is_available() and not dist.is_initialized():
            try:
                dist.init_process_group(
                    backend="gloo", init_method=_init_method(coord),
                    world_size=int(os.environ.get("WDBX_NUM_PROCESSES", "1")),
                    rank=int(os.environ.get("WDBX_PROCESS_ID", "0")),
                    timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S),
                )
                self._joined = True
            except Exception as e:
                logger.warning("torch.distributed join failed: %s", e)
        # the background rebuilds' group, made at the same point on
        # every rank
        collective.open_background_group(JOIN_TIMEOUT_S)

    async def initialize(self) -> None:
        if self._initialized:
            return
        self.join()
        self._mesh()
        self._persist_allocation()
        self._initialized = True

    async def shutdown(self) -> None:
        if self._joined:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
            collective.forget_groups()
            self._joined = False
        self._initialized = False

    @staticmethod
    def _process() -> tuple[int, int]:
        return collective.rank_world()

    # -- placement metadata ------------------------------------------------
    def allocation(self) -> dict[str, Any]:
        """Shard -> position map. Positions replace the reference's
        'nodes'; replication means the same logical shard present on r
        positions (recomputed from checkpoint on failure)."""
        names = self._mesh().names
        rank, world = self._process()
        return {
            "axis": self.axis,
            "node_id": self.node_id,
            "process_index": rank,
            "process_count": world,
            "replication_factor": self.replication_factor,
            "shards": {
                str(i): {
                    "primary": name,
                    "replicas": [
                        names[(i + r) % len(names)]
                        for r in range(1, self.replication_factor)
                    ],
                }
                for i, name in enumerate(names)
            },
        }

    def _persist_allocation(self) -> None:
        data_dir = self.config.get("DATA_DIR", "./wdbx_data")
        try:
            os.makedirs(data_dir, exist_ok=True)
            with open(os.path.join(data_dir, "shard_allocation.json"), "w") as f:
                json.dump(self.allocation(), f, indent=2)
        except OSError as e:
            logger.warning("failed to persist shard allocation: %s", e)

    def is_local_shard(self, shard: int) -> bool:
        """Whether this process owns the shard's position."""
        mesh = self._mesh()
        return mesh.owners[shard % mesh.size] == mesh.rank

    def health_check(self, mesh: Mesh | None = None) -> dict[str, Any]:
        """Per-position liveness of ``mesh`` (default: the engine's): an
        8x8 product on each position's device, then a synchronization of
        that device, so an asynchronous CUDA fault counts against the
        position that ran. A rank probes its own positions (maybe none);
        on a global mesh the ranks then exchange their statuses, so
        every rank holds the whole map."""
        mesh = mesh or self._mesh()
        statuses = {mesh.names[p]: self._probe(mesh.names[p],
                                               mesh.devices[p])
                    for p in mesh.local_positions}
        if mesh.is_global:
            merged = {}
            for part in collective.all_gather_object(statuses):
                merged.update(part)
            statuses = {name: merged[name] for name in mesh.names}
        healthy = all(v == "ok" for v in statuses.values())
        return {"healthy": healthy, "devices": statuses}

    def _probe(self, name: str, device: torch.device) -> str:
        """Position ``name``'s status: ``"ok"``, ``"bad-result"`` or the
        error its probe raised."""
        try:
            out = torch.ones((8, 8), device=device) @ torch.ones(
                (8, 8), device=device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            ok = float(out[0, 0]) == 8.0
        except Exception as e:
            return f"error: {e}"
        return "ok" if ok else "bad-result"

    def plan_recovery(
        self, health: dict[str, Any] | None = None
    ) -> dict[int, str]:
        """For every shard whose primary position is unhealthy, the
        first healthy replica (else any healthy position): ``{shard:
        target position}``. The caller re-hosts from the checkpoint."""
        health = health or self.health_check()
        healthy = {n for n, s in health["devices"].items() if s == "ok"}
        plan: dict[int, str] = {}
        for shard_s, placement in self.allocation()["shards"].items():
            if placement["primary"] in healthy:
                continue
            target = next(
                (r for r in placement["replicas"] if r in healthy), None
            )
            if target is None:
                target = next(iter(sorted(healthy)), None)
            if target is not None:
                plan[int(shard_s)] = target
        return plan

    def degraded_mesh(self, health: dict[str, Any] | None = None) -> Mesh:
        """Mesh of only the healthy positions, which keep their names:
        the live re-meshing target when a device is gone. Returns the
        current mesh unchanged when everything is healthy. Replica axes
        collapse: survival beats data-parallel fan-out. On a global mesh
        every rank holds the same health map (``health_check`` gathers
        it), so every rank derives the same mesh: the survivors keep
        their owners, in blocks of unequal size; a rank whose positions
        are all down owns none and joins the mesh's collectives empty."""
        health = health or self.health_check()
        mesh = self._mesh()
        keep = [i for i, n in enumerate(mesh.names)
                if health["devices"].get(n) == "ok"]
        if not keep:
            raise RuntimeError("no healthy devices to remesh onto")
        if len(keep) == mesh.size:
            return mesh
        return Mesh([mesh.devices[i] for i in keep], (self.axis,),
                    names=[mesh.names[i] for i in keep],
                    owners=([mesh.owners[i] for i in keep]
                            if mesh.is_global else None))

    def restored_mesh(self) -> Mesh:
        """The mesh the engine started on, once every position of it
        answers its probe again (heal's way back from a degraded mesh);
        the current mesh otherwise. Every rank probes its own positions
        of that mesh and the ranks exchange the statuses, so every rank
        takes the same answer."""
        mesh = self._mesh()
        if self.home is mesh:
            return mesh
        return self.home if self.health_check(self.home)["healthy"] \
            else mesh

    def adopt_mesh(self, mesh: Mesh) -> None:
        """Install a new mesh (post-remesh) and persist the allocation."""
        self.mesh = mesh
        self._persist_allocation()

    def get_stats(self) -> dict[str, Any]:
        return {
            "node_id": self.node_id,
            "axis": self.axis,
            "devices": list(self.mesh.names) if self.mesh else [],
            "replication_factor": self.replication_factor,
            "process_count": self._process()[1],
            "local_positions": (list(self.mesh.local_positions)
                                if self.mesh else []),
            "initialized": self._initialized,
        }
