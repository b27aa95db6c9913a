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
import logging
from typing import Any

import numpy as np
import torch

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


class VectorIndex(abc.ABC):
    """Batched, slot-addressed similarity index."""

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
    @abc.abstractmethod
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
