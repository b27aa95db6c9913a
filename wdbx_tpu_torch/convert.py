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

A bf16 slab may come as an ml_dtypes bfloat16 array or as its uint16
bits; both become a torch bfloat16 slab bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex
from wdbx_tpu_torch.index.flat import FlatIndex
from wdbx_tpu_torch.index.ivf import IVFIndex


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
