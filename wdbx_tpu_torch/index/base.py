"""Index ABC — the contract the store layer programs against.

Torch port of ``wdbx_tpu/index/base.py``: the same ABC and the same
``INDEX_TYPE`` alias routing onto the port's flat, clustered, dense IVF,
sharded flat, sharded IVF and sharded clustered engines.

The reference's ``VectorIndex`` ABC (reference wdbx/core/indexing.py:18)
speaks string ids and per-vector calls because its backends are
per-element C++ graph inserts. A device index is a fixed-shape slab,
so this contract is numeric and batched: vectors in, *slot* handles out,
whole query batches scored at once. String-id bookkeeping lives one layer
up in the store (wdbx_tpu/store/vector_store.py), keeping host dict work
off the device path.
"""

from __future__ import annotations

import abc
import dataclasses
import logging
from typing import Any, Callable

import numpy as np
import torch

from wdbx_tpu_torch.utils.metrics import TRACER, span
from wdbx_tpu_torch.utils.rwlock import RWLock

logger = logging.getLogger("wdbx_tpu_torch.index")


def resolve_device(device: Any = None) -> torch.device:
    """The device an index lives on. ``None`` means the CUDA device and
    raises when there is none: the port never drops to the CPU
    silently. Pass ``device="cpu"`` to run on the CPU (the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the index on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is absent")
    return dev


def to_tensor(a: Any, device: torch.device, dtype=None) -> torch.Tensor:
    """Host array (numpy, incl. ml_dtypes bfloat16) or tensor -> tensor
    on ``device``. Half-precision host stacks stay half precision (half
    the host-to-device bytes)."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(
                np.ascontiguousarray(arr).view(np.int16)
            ).view(torch.bfloat16)
        elif arr.dtype == np.float16:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return t.to(device=device, dtype=dtype or t.dtype)


@dataclasses.dataclass
class Plan:
    """The route ``VectorIndex._plan`` picks for one batch width."""

    #: the flat scan over every row: untrained, a filter under its exact
    #: threshold, or the batch flat fallback
    exact: bool
    #: the filter in the slab's row space (slots; positions on the
    #: clustered layout), or None
    mask: Any = None
    #: planned for a pipelined stack: no filter, no batch flat fallback
    stack: bool = False
    #: the scan's probes a query and the (JAX) batch width that routes it
    nprobe: int = 0
    pad_b: int = 0


@dataclasses.dataclass
class Pending:
    """An enqueued batch (or stack) not yet synchronised: device
    ``scores`` and ``ids`` (rows, slots or positions, as the route leaves
    them), the ``k`` columns the caller gets, and ``finish``, the
    engine's host step (``_finish``) over the transferred arrays."""

    scores: torch.Tensor
    ids: torch.Tensor
    k: int
    finish: Callable[[np.ndarray, np.ndarray, int], tuple]


class VectorIndex(abc.ABC):
    """Batched, slot-addressed similarity index.

    The query path is written once, here: ``search`` and
    ``search_pipelined`` build if stale, take the read lock, plan the
    route of the batch width (``_plan``), enqueue it on the device
    (``_enqueue``, ``_enqueue_stack``) and collect it
    (``resolve_pipelined``: one transfer, then the engine's ``_finish``).
    Engines supply those hooks and never override the three entry
    points."""

    #: subclass tag used by config / factory ("flat", "ivf")
    kind: str = "base"

    def __init__(self, dim: int, metric: str = "cosine"):
        if metric not in ("cosine", "ip"):
            raise ValueError(f"unsupported metric: {metric}")
        self.dim = dim
        self.metric = metric
        #: readers-writer lock: searches hold ``_mu.read()`` through their
        #: device compute (mutators write the slab tensors in place, so a
        #: mutation would change a snapshot mid-flight); mutators hold
        #: ``_mu.write()``. Concurrent searches overlap; mutations
        #: serialize with in-flight searches only.
        self._mu = RWLock()

    # -- mutation ---------------------------------------------------------
    @abc.abstractmethod
    def add_batch(self, vectors: np.ndarray) -> np.ndarray:
        """Insert ``(n, dim)`` vectors; returns ``(n,)`` int64 slot ids."""

    @abc.abstractmethod
    def update_slots(self, slots: np.ndarray, vectors: np.ndarray) -> None:
        """Overwrite existing slots in place."""

    @abc.abstractmethod
    def remove_slots(self, slots: np.ndarray) -> None:
        """Tombstone slots: they become invisible to search immediately
        (unlike the reference's zero-vector HNSW tombstones that keep
        surfacing in results, reference wdbx/core/indexing.py:525-560)."""

    # -- query ------------------------------------------------------------
    def search(
        self,
        queries: np.ndarray,
        k: int,
        slot_mask: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k over valid slots. Returns ``(scores, slots)`` each
        ``(B, k)``; absent candidates have score ``-inf`` and slot ``-1``.
        ``slot_mask`` (bool, per slot) pre-filters on device — the
        high-selectivity alternative to the reference's host post-filter
        (reference wdbx/core/vector_store.py:414-463)."""
        with span("index.search", engine=type(self).__name__) as sp:
            self._build_if_stale()
            queries = self._prep(queries)
            # Read lock held through materialization: mutators write the
            # slab in place. Concurrent searches share the read side.
            waited = TRACER.clock()
            with self._mu.read():
                sp.set(lock_wait_ns=TRACER.clock() - waited)
                plan = self._plan(len(queries), slot_mask)
                return self.resolve_pipelined(
                    self._enqueue(queries, k, plan))

    def search_pipelined(self, qstack, k: int, materialize: bool = True):
        """Serve a (NB, B, d) stack of query batches in one call: each
        batch through the route ``search`` plans for width B, with no
        filter and no batch flat fallback; the flat engines run the whole
        stack as one launch pair. Returns (NB, B, k) scores / slots with
        absent ranks -inf / -1 (the single-device flat route returns
        ``min(k, capacity)`` columns).

        ``materialize=False`` returns the ``Pending`` device result
        without a synchronisation, for callers that keep several calls in
        flight; ``resolve_pipelined`` collects it. Resolve it before
        mutating the index: later writes are ordered after the search on
        the device's stream, but positions map to slots at resolve
        time."""
        q = to_tensor(qstack, self.device)
        if q.ndim != 3 or q.shape[-1] != self.dim:
            raise ValueError(
                f"query stack {tuple(q.shape)} is not (NB, B, {self.dim})"
            )
        self._build_if_stale()
        with self._mu.read():
            pending = self._enqueue_stack(
                q, k, self._plan(q.shape[1], None, stack=True))
            return self.resolve_pipelined(pending) if materialize else pending

    @staticmethod
    def resolve_pipelined(pending: Pending) -> tuple[np.ndarray, np.ndarray]:
        """Collect a ``Pending`` result: one transfer to the host, then
        the engine's host step."""
        with span("index.d2h"):
            scores = pending.scores.cpu().numpy()
            ids = pending.ids.cpu().numpy()
        return pending.finish(scores, ids, pending.k)

    def _build_if_stale(self) -> None:
        # build-if-stale needs the write lock (it swaps the overlay); the
        # search itself runs under read so concurrent queries overlap
        if self._needs_build():
            with self._mu.write():
                self._maybe_build()

    def _needs_build(self) -> bool:
        """Whether the next search must (re)build first; exact engines
        never do."""
        return False

    def _maybe_build(self) -> None:
        """(Re)build when ``_needs_build``, under the write lock."""

    def _enqueue_stack(self, q: torch.Tensor, k: int, plan: Plan) -> Pending:
        """A (NB, B, d) stack through ``_enqueue`` batch by batch, the
        results stacked to (NB, B, K)."""
        outs = [self._enqueue(qb, k, plan) for qb in q]
        return Pending(torch.stack([o.scores for o in outs]),
                       torch.stack([o.ids for o in outs]), k, self._finish)

    @abc.abstractmethod
    def _prep(self, queries):
        """Queries as a (B, d) batch; raises on a dimension mismatch."""

    @abc.abstractmethod
    def _plan(self, b: int, slot_mask, stack: bool = False) -> Plan:
        """The route of a batch of width ``b`` (``stack``: one batch of
        a pipelined stack)."""

    @abc.abstractmethod
    def _enqueue(self, queries, k: int, plan: Plan) -> Pending:
        """Run ``plan``'s route on one (B, d) batch without
        synchronising."""

    @abc.abstractmethod
    def _finish(self, scores: np.ndarray, ids: np.ndarray, k: int):
        """The host step of a transferred ``(..., K)`` result: ``(scores,
        slots)`` with k columns, slot -1 wherever the score is -inf."""

    @abc.abstractmethod
    def get_vectors(self, slots: np.ndarray) -> np.ndarray:
        """Read back vectors (as stored, post-normalization) by slot."""

    # -- lifecycle --------------------------------------------------------
    @abc.abstractmethod
    def clear(self) -> None: ...

    @abc.abstractmethod
    def save(self, path: str) -> None: ...

    @abc.abstractmethod
    def load(self, path: str) -> bool:
        """Load persisted state; returns False if nothing was found."""

    @abc.abstractmethod
    def count(self) -> int: ...

    @property
    @abc.abstractmethod
    def capacity(self) -> int: ...

    def optimize(self) -> None:
        """Compaction / retraining hook; default no-op (parity with
        reference wdbx/core/indexing.py:610-628)."""

    def get_stats(self) -> dict[str, Any]:
        return {
            "type": self.kind,
            "dim": self.dim,
            "metric": self.metric,
            "size": self.count(),
            "capacity": self.capacity,
        }


def _apply_kernel_knobs(idx: Any, config: Any) -> None:
    """Operator control of the clustered scan's kernel generation and
    query precision: IVF_KERNEL_VERSION auto|v1|v2 and
    IVF_KERNEL_QPREC bf16|int8 ("int8" trades raw recall for speed,
    recall-neutral through the store's exact re-rank). The retired "v3"
    coerces to auto so old configs keep loading."""
    kv = str(config.get("IVF_KERNEL_VERSION", "auto")).lower()
    if kv in ("v1", "v2"):
        idx.kernel_version = kv
    qp = str(config.get("IVF_KERNEL_QPREC", "bf16")).lower()
    if qp in ("bf16", "int8"):
        idx.kernel_qprec = qp
    # bucket-matched reuse of deleted clustered-region rows (bounds
    # capacity growth under delete/update churn between rebuilds)
    idx.recycle_holes = bool(config.get("IVF_RECYCLE_HOLES", True))
    # deepest k the clustered scan kernel serves before its portable
    # path takes over (ClusteredIVFIndex.KERNEL_K_MAX, slice 2)
    km = int(config.get("KERNEL_K_MAX", 0))
    if km > 0:
        idx.KERNEL_K_MAX = km


def create_index(
    kind: str, dim: int, config: Any = None, device: Any = None
) -> "VectorIndex":
    """Factory keyed by config, mirroring the reference's index-type
    switch (reference wdbx/core/vector_store.py:111-134 choosing
    HNSWIndex/FaissIndex from ``INDEX_TYPE``). ``device`` places the
    index (see ``resolve_device``)."""
    from wdbx_tpu_torch.index.flat import FlatIndex

    kind = (kind or "flat").lower()
    kwargs: dict[str, Any] = {}
    if config is not None:
        kwargs["metric"] = config.get("INDEX_METRIC", "cosine")
        kwargs["dtype"] = config.get("INDEX_DTYPE", "float32")
        # Declared capacity presizes the device slab (per shard), the
        # reference's HNSW_MAX_ELEMENTS semantic (reference
        # wdbx/core/indexing.py:245). Essential for bulk loads past
        # ~half of device memory: an incremental copy-grow needs old+new
        # slabs resident at once, which cannot fit there.
        declared = int(config.get(
            "INDEX_CAPACITY",
            config.get("HNSW_MAX_ELEMENTS", 0) if kind == "hnsw" else 0,
        ) or 0)
        if declared > 0:
            kwargs["capacity"] = declared
    if kind == "hnsw":
        # Reference-config migration: the reference serves INDEX_TYPE=HNSW
        # via hnswlib (reference wdbx/core/indexing.py:709-758); the
        # clustered engine is its latency-serving analogue. nprobe is
        # mapped from HNSW_EF_SEARCH; HNSW_M / HNSW_EF_CONSTRUCTION have
        # no analogue and are ignored.
        from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex

        ef = int(config.get("HNSW_EF_SEARCH", 50)) if config is not None else 50
        kwargs["nprobe"] = max(4, round(ef / 6))
        if config is not None:
            kwargs["nlist"] = int(config.get("IVF_NLIST", 100))
            kwargs["train_threshold"] = int(
                config.get("IVF_TRAIN_THRESHOLD", 4096)
            )
        logger.info(
            "INDEX_TYPE=hnsw: serving via ivf_clustered (nprobe=%d mapped "
            "from HNSW_EF_SEARCH=%d)", kwargs["nprobe"], ef,
        )
        idx = ClusteredIVFIndex(dim, device=device, **kwargs)
        if config is not None:
            idx.background_rebuild = bool(
                config.get("IVF_BACKGROUND_REBUILD", False)
            )
            _apply_kernel_knobs(idx, config)
        return idx
    if kind == "faiss":
        # Reference FAISS backend: dispatch on FAISS_INDEX_TYPE ("Flat" or
        # an IVF factory string like "IVF100,Flat" — reference
        # wdbx/core/indexing.py:709-758, config.py:36-37).
        ftype = str(
            config.get("FAISS_INDEX_TYPE", "Flat") if config is not None
            else "Flat"
        )
        if ftype.lower().startswith("ivf"):
            head = ftype.split(",")[0][3:]
            nlist = int(head) if head.isdigit() else int(
                config.get("FAISS_NLIST", config.get("IVF_NLIST", 100))
                if config is not None else 100
            )
            nprobe = int(
                config.get("FAISS_NPROBE", config.get("IVF_NPROBE", 8))
            ) if config is not None else 8
            logger.info(
                "INDEX_TYPE=faiss (%s): serving via ivf_clustered "
                "(nlist=%d)", ftype, nlist,
            )
            kwargs.update(nlist=nlist, nprobe=nprobe)
            kind = "ivf_clustered"
        else:
            logger.info(
                "INDEX_TYPE=faiss (%s): serving via flat exact scan", ftype,
            )
            kind = "flat"
    if kind == "flat":
        if config is not None:
            kwargs["topk_method"] = config.get("INDEX_TOPK", "auto")
        return FlatIndex(dim, device=device, **kwargs)
    if kind in ("ivf", "ivf_dense"):
        if config is not None:
            kwargs["nlist"] = int(config.get("IVF_NLIST", 100))
            kwargs["nprobe"] = int(config.get("IVF_NPROBE", 8))
            kwargs["train_threshold"] = int(
                config.get("IVF_TRAIN_THRESHOLD", 4096)
            )
            kwargs["rebuild_fraction"] = float(
                config.get("IVF_REBUILD_FRACTION", 0.2)
            )
            kwargs["assignments"] = int(config.get("IVF_ASSIGNMENTS", 1))
        if kind == "ivf" and kwargs.get("assignments", 1) <= 1:
            # "ivf" serves via ivf_clustered unless IVF_ASSIGNMENTS >= 2
            # (SOAR spilled assignment, which only the dense table has)
            logger.info(
                "INDEX_TYPE=ivf: serving via ivf_clustered "
                "(set INDEX_TYPE=ivf_dense for the dense-table engine)"
            )
            kwargs.pop("assignments", None)
            kind = "ivf_clustered"
        else:
            from wdbx_tpu_torch.index.ivf import IVFIndex

            return IVFIndex(dim, device=device, **kwargs)
    if kind == "ivf_clustered":
        from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex

        if config is not None:
            # setdefault: the faiss / ivf alias branches above may carry
            # factory-string or dense-config values that win over the
            # generic IVF_* keys
            kwargs.setdefault("nlist", int(config.get("IVF_NLIST", 100)))
            kwargs.setdefault("nprobe", int(config.get("IVF_NPROBE", 8)))
            kwargs.setdefault(
                "train_threshold",
                int(config.get("IVF_TRAIN_THRESHOLD", 4096)),
            )
            kwargs["rebuild_fraction"] = float(
                config.get("IVF_REBUILD_FRACTION", 0.2)
            )
        idx = ClusteredIVFIndex(dim, device=device, **kwargs)
        if config is not None:
            idx.background_rebuild = bool(
                config.get("IVF_BACKGROUND_REBUILD", False)
            )
            _apply_kernel_knobs(idx, config)
        return idx
    if kind == "sharded_flat":
        from wdbx_tpu_torch.parallel.sharded_flat import ShardedFlatIndex

        if config is not None:
            kwargs["axis"] = config.get("MESH_AXIS", "shard")
            kwargs["replicas"] = int(config.get("MESH_REPLICAS", 1))
        return ShardedFlatIndex(dim, device=device, **kwargs)
    if kind == "sharded_ivf":
        from wdbx_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

        if config is not None:
            kwargs["axis"] = config.get("MESH_AXIS", "shard")
            kwargs["nlist"] = int(config.get("IVF_NLIST", 128))
            kwargs["nprobe"] = int(config.get("IVF_NPROBE", 8))
            kwargs["train_threshold"] = int(
                config.get("IVF_TRAIN_THRESHOLD", 4096)
            )
        return ShardedIVFIndex(dim, device=device, **kwargs)
    if kind == "sharded_clustered":
        from wdbx_tpu_torch.parallel.sharded_clustered import (
            ShardedClusteredIndex,
        )

        if config is not None:
            kwargs["axis"] = config.get("MESH_AXIS", "shard")
            kwargs["replicas"] = int(config.get("MESH_REPLICAS", 1))
            kwargs["nlist"] = int(config.get("IVF_NLIST", 128))
            kwargs["nprobe"] = int(config.get("IVF_NPROBE", 8))
            kwargs["train_threshold"] = int(
                config.get("IVF_TRAIN_THRESHOLD", 4096)
            )
        idx = ShardedClusteredIndex(dim, device=device, **kwargs)
        if config is not None:
            idx.background_rebuild = bool(
                config.get("IVF_BACKGROUND_REBUILD", False)
            )
            _apply_kernel_knobs(idx, config)
        return idx
    raise ValueError(f"unknown index type: {kind}")
