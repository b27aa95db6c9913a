"""Carry index state across from host arrays (e.g. a ``wdbx_tpu`` index).

``flat_index_from_arrays`` builds a port ``FlatIndex``,
``clustered_index_from_arrays`` a port ``ClusteredIVFIndex`` and
``ivf_index_from_arrays`` a port dense ``IVFIndex`` that compute the
same thing as the index their arrays came from:

    arrays = {"slab": np.asarray(jax_index._slab),
              "valid": np.asarray(jax_index._valid),
              "scales": np.asarray(jax_index._scales)}   # int8 / int4 only
    meta = {"dim": ..., "dtype": ..., "metric": ..., "size": ...,
            "next_slot": ..., "free": [...], "capacity": ...}
    index = flat_index_from_arrays(arrays, meta, device="cuda")

For a clustered index add its slot map, residual list and layout, and
the scalars of its ``.ivfc.json`` sidecar:

    arrays.update(slot_of=jax_index._slot_of,
                  residual=np.asarray(jax_index._residual),
                  centroids=np.asarray(jax_index._centroids),   # trained
                  bucket_start=jax_index._bucket_start)         # trained
    meta.update(nlist=..., nprobe=..., trained=..., built_size=...,
                residual_base=..., next_ext_slot=..., free_slots=[...],
                pos_quarantine=[...], block_rows=..., fresh_base=...)
    index = clustered_index_from_arrays(arrays, meta, device="cuda")

For a dense IVF index add its bucket tables, residual list and the
scalars of its ``.ivf.json`` sidecar (bf16 tables as ml_dtypes arrays or
uint16 bits):

    arrays.update(centroids=np.asarray(jax_index._centroids),   # trained
                  bucket_slot=np.asarray(jax_index._bucket_slot),
                  bucket_valid=np.asarray(jax_index._bucket_valid),
                  bucket_rows=np.asarray(jax_index._bucket_rows),
                  bucket_scale=np.asarray(jax_index._bucket_scale),  # int8
                  residual=np.asarray(jax_index._residual))
    meta.update(nlist=..., nprobe=..., assignments=..., built_size=...,
                residual_base=..., quarantine=[...])
    index = ivf_index_from_arrays(arrays, meta, device="cuda")

A sharded index (``wdbx_tpu.parallel``) comes over through its
slot-order host view, onto a port mesh (``wdbx_tpu_torch.parallel``);
the dense overlay of a sharded IVF index as its global tables:

    slab, valid = jax_index._host_slot_view()
    arrays = {"slab": slab, "valid": valid,
              "scales": np.asarray(jax_index._scales).T.reshape(-1)}
    index = sharded_flat_index_from_arrays(arrays, meta, make_mesh(8))
    index = sharded_ivf_index_from_arrays(arrays | overlay, meta | ivf_meta,
                                          make_mesh(8))

A sharded clustered index comes over as its per-position arrays, ``(n_dev,
rpd, ...)``, with its slot map, layout and the scalars of its
``.ivfsc.json`` sidecar:

    arrays = {"slab": np.asarray(jax_index._slab),        # (n_dev, rpd, w)
              "valid": np.asarray(jax_index._valid),      # (n_dev, rpd)
              "scales": np.asarray(jax_index._scales),    # int8 / int4 only
              "slot_of": jax_index._slot_of,
              "residual": np.asarray(jax_index._residual),
              "centroids": np.asarray(jax_index._centroids),  # trained
              "local_counts": jax_index._local_counts}         # trained
    meta.update(nlist=..., nprobe=..., trained=..., built_size=...,
                residual_base=..., next_ext_slot=..., free_slots=[...],
                pos_quarantine=[...], next_slot=..., block_rows=...,
                fresh_base=...)
    index = sharded_clustered_index_from_arrays(arrays, meta, make_mesh(8))

A bf16 slab may come as an ml_dtypes bfloat16 array or as its uint16
bits; both become a torch bfloat16 slab bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex
from wdbx_tpu_torch.index.flat import FlatIndex
from wdbx_tpu_torch.index.ivf import IVFIndex
from wdbx_tpu_torch.parallel.mesh import Mesh
from wdbx_tpu_torch.parallel.sharded_clustered import ShardedClusteredIndex
from wdbx_tpu_torch.parallel.sharded_flat import ShardedFlatIndex
from wdbx_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex


def flat_index_from_arrays(
    arrays: dict[str, np.ndarray], meta: dict[str, Any], device: Any = None
) -> FlatIndex:
    return _place_flat(FlatIndex, arrays, meta, device)


def clustered_index_from_arrays(
    arrays: dict[str, np.ndarray], meta: dict[str, Any], device: Any = None
) -> ClusteredIVFIndex:
    """The clustered state goes in as ``load`` installs a checkpoint's:
    the extents are rebuilt from ``bucket_start`` and ``block_rows``."""
    index = _place_flat(
        ClusteredIVFIndex, arrays, meta, device,
        nlist=int(meta["nlist"]), nprobe=int(meta["nprobe"]),
    )
    index._restore_clustered(arrays, meta, None)
    return index


def ivf_index_from_arrays(
    arrays: dict[str, np.ndarray], meta: dict[str, Any], device: Any = None
) -> IVFIndex:
    """The dense overlay goes in as ``load`` installs a checkpoint's;
    without ``centroids`` the index is untrained."""
    index = _place_flat(
        IVFIndex, arrays, meta, device, nlist=int(meta["nlist"]),
        nprobe=int(meta["nprobe"]),
        assignments=int(meta.get("assignments", 1)),
    )
    index._built_size = int(meta.get("built_size", 0))
    index._residual_base = int(meta.get("residual_base", 0))
    index._quarantine = [int(s) for s in meta.get("quarantine", [])]
    if "centroids" in arrays:
        index._install_tables(arrays)
    return index


def sharded_flat_index_from_arrays(
    arrays: dict[str, np.ndarray], meta: dict[str, Any],
    mesh: Mesh | None = None, device: Any = None,
) -> ShardedFlatIndex:
    """A JAX ``ShardedFlatIndex``'s slot-order state striped over
    ``mesh`` (default: ``make_mesh(device=device)``); its capacity must
    be one this mesh rounds to."""
    return _place_flat(ShardedFlatIndex, arrays, meta, device, mesh=mesh)


def sharded_ivf_index_from_arrays(
    arrays: dict[str, np.ndarray], meta: dict[str, Any],
    mesh: Mesh | None = None, device: Any = None,
) -> ShardedIVFIndex:
    """As ``sharded_flat_index_from_arrays``, plus the dense overlay's
    global tables (split by shard as ``load`` splits a checkpoint's)."""
    index = _place_flat(ShardedIVFIndex, arrays, meta, device, mesh=mesh,
                        nlist=int(meta["nlist"]), nprobe=int(meta["nprobe"]))
    index._built_size = int(meta.get("built_size", 0))
    index._residual_base = int(meta.get("residual_base", 0))
    index._quarantine = [int(s) for s in meta.get("quarantine", [])]
    if "centroids" in arrays:
        index._install_tables(arrays)
    return index


def sharded_clustered_index_from_arrays(
    arrays: dict[str, np.ndarray], meta: dict[str, Any],
    mesh: Mesh | None = None, device: Any = None,
) -> ShardedClusteredIndex:
    """A JAX ``ShardedClusteredIndex``'s per-position ``(n_dev, rpd,
    ...)`` slab, validity and scales put in slot order and striped over
    ``mesh`` (slot ``row * n_dev + shard``), then its clustered state
    installed as ``load`` installs a checkpoint's: the extents from
    ``local_counts`` and ``block_rows``, rebuilt when the mesh has
    another shard count."""
    def slot_order(a):
        a = np.asarray(a)
        return a.swapaxes(0, 1).reshape((-1,) + a.shape[2:])

    flat = {key: slot_order(arrays[key])
            for key in ("slab", "valid", "scales") if key in arrays}
    index = _place_flat(ShardedClusteredIndex, flat, meta, device, mesh=mesh,
                        nlist=int(meta["nlist"]), nprobe=int(meta["nprobe"]))
    index._restore_sidecar(arrays, meta, None)
    return index


def _place_flat(cls, arrays, meta, device, **kwargs):
    slab = np.asarray(arrays["slab"])
    valid = np.asarray(arrays["valid"], bool)
    dtype = meta.get("dtype") or {
        "float32": "float32", "bfloat16": "bfloat16", "uint16": "bfloat16",
        "int8": "int8", "uint8": "int4",
    }[slab.dtype.name]
    dim = int(meta.get("dim") or (slab.shape[1] * (2 if dtype == "int4" else 1)))
    cap = int(meta.get("capacity") or slab.shape[0])
    if slab.shape[0] != cap or valid.shape != (cap,):
        raise ValueError(
            f"slab {slab.shape} / valid {valid.shape} do not match "
            f"capacity {cap}"
        )
    index = cls(
        dim, metric=meta.get("metric", "cosine"), dtype=dtype,
        capacity=cap, device=device, **kwargs,
    )
    if index.capacity != cap:
        raise ValueError(f"capacity {cap} is not a valid slab capacity")
    scales = arrays.get("scales")
    if index._is_quantized and scales is None:
        raise ValueError(f"{dtype} slabs need their per-row scales")
    index._place(
        slab, valid,
        np.asarray(scales, np.float32) if index._is_quantized else None,
    )
    index._size = int(meta.get("size", int(valid.sum())))
    index._next_slot = int(meta.get("next_slot", cap))
    index._free = [int(s) for s in meta.get("free", [])]
    return index
