"""Carry index state across from host arrays (e.g. a ``wdbx_tpu`` index).

``flat_index_from_arrays`` builds a port ``FlatIndex`` that computes the
same thing as the index its arrays came from:

    arrays = {"slab": np.asarray(jax_index._slab),
              "valid": np.asarray(jax_index._valid),
              "scales": np.asarray(jax_index._scales)}   # int8 / int4 only
    meta = {"dim": ..., "dtype": ..., "metric": ..., "size": ...,
            "next_slot": ..., "free": [...], "capacity": ...}
    index = flat_index_from_arrays(arrays, meta, device="cuda")

A bf16 slab may come as an ml_dtypes bfloat16 array or as its uint16
bits; both become a torch bfloat16 slab bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from wdbx_tpu_torch.index.flat import FlatIndex


def flat_index_from_arrays(
    arrays: dict[str, np.ndarray], meta: dict[str, Any], device: Any = None
) -> FlatIndex:
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
    index = FlatIndex(
        dim, metric=meta.get("metric", "cosine"), dtype=dtype,
        capacity=cap, device=device,
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
