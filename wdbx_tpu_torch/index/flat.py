"""Flat (exact) device index: one slab tensor, one scan, recall 1.0.

Torch port of ``wdbx_tpu/index/flat.py``. The whole database lives on
the index's device as a fixed-capacity slab; queries are scored by the
fused score + top-k kernel on the CUDA device (``kernels/fused_topk.py``)
and by ``exact_search`` elsewhere; mutation is a batched index write.

  * capacity slabs — power-of-two capacity below 1M rows, 1M-row steps
    above; growth copies into a slab 1.5x larger (peak old + new);
  * tombstone mask — deletes flip a validity bit; dead slots score -inf
    and are recycled by later adds;
  * int8 / int4 slabs quantize on the device at write time, with one
    float32 scale per row.

Unlike the JAX index, batches and slot lists are not padded to powers
of two (that bounded XLA recompiles; its pad slots pointed one past the
slab, which JAX drops and torch would not). Writes go in place; the
copy-on-write variants (``_cow_writes``) clone first. The on-disk
format (``<path>.npz`` + ``<path>.meta.json``) is the JAX package's, so
checkpoints move between the two.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from wdbx_tpu_torch.index.base import (
    Pending,
    Plan,
    VectorIndex,
    resolve_device,
    to_tensor,
)
from wdbx_tpu_torch.kernels.quant import (
    quantize_rows,
    quantize_rows_int4,
    unpack_int4,
)
from wdbx_tpu_torch.ops.exact_search import exact_search
from wdbx_tpu_torch.ops.normalize import l2_normalize

#: name -> STORAGE dtype. "int4" stores two signed nibbles per uint8
#: byte (kernels/quant.py packing) with a per-row f32 scale.
_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "int4": torch.uint8,
}


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def slab_to_numpy(slab: torch.Tensor) -> np.ndarray:
    """Host copy of a slab in the checkpoint's encoding (bf16 as the
    raw uint16 bits)."""
    slab = slab.detach().cpu()
    if slab.dtype == torch.bfloat16:
        return slab.view(torch.int16).numpy().view(np.uint16)
    return slab.numpy()


def slab_from_numpy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``slab_to_numpy``; takes uint16 bits or an ml_dtypes
    bfloat16 array for a bf16 slab."""
    # an owned, writable copy when needed: the slab is written in place,
    # and must never alias the caller's (possibly read-only) buffer
    arr = np.require(arr, requirements=["C", "W", "O"])
    if dtype == torch.bfloat16:
        if arr.dtype.name == "bfloat16":
            arr = arr.view(np.uint16)
        if arr.dtype == np.uint16:
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr).to(dtype)


class FlatIndex(VectorIndex):
    kind = "flat"
    #: set while a reader holds the current tensors as a snapshot: writes
    #: then go to clones instead of in place
    _cow_writes = False

    def __init__(
        self,
        dim: int,
        metric: str = "cosine",
        dtype: str = "float32",
        capacity: int = 1024,
        topk_method: str = "auto",
        device: Any = None,
    ):
        super().__init__(dim, metric)
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported slab dtype: {dtype}")
        if dtype == "int4" and dim % 2:
            raise ValueError("int4 slabs need an even dimension "
                             "(two dims pack per byte)")
        if topk_method not in ("auto", "exact", "approx", "fused"):
            raise ValueError(f"unsupported topk method: {topk_method}")
        self.device = resolve_device(device)
        #: "auto" resolves per search: the fused CUDA kernels on the card,
        #: ``exact_search`` elsewhere. "approx" selects exactly here.
        self.topk_method = topk_method
        #: "npz" (slot-order host arrays, read by both packages) or
        #: "orbax" (one file a mesh position, ``store/persist.py``)
        self.persist_backend = "npz"
        self.dtype_name = dtype
        self._dtype = _DTYPES[dtype]
        self._precision = "highest" if dtype == "float32" else "default"
        self._cap = self._round_cap(capacity)
        #: the configured INDEX_CAPACITY floor: load() must not shrink
        #: below it, or a resumed bulk ingest re-enters the incremental
        #: copy-grows the presize exists to avoid
        self._declared_cap = self._cap
        self._scales = None  # (cap,) f32 per-row scales; int8/int4 only
        #: bumps on every write: keys the filter-mask cache, since in-place
        #: writes keep the ``_valid`` tensor's identity
        self._gen = 0
        self._alloc(self._cap)
        self._size = 0
        self._free: list[int] = []
        self._next_slot = 0

    # -- storage ----------------------------------------------------------
    _CAP_CHUNK = 1 << 20

    def _round_cap(self, need: int) -> int:
        """Power-of-two below 1M rows; 1M-row granularity above (a pow2
        cap for a 10M corpus would waste 6.7M rows). Growth calls
        request 1.5x so copies stay amortized."""
        if need <= self._CAP_CHUNK:
            return _next_pow2(need)
        return -(-need // self._CAP_CHUNK) * self._CAP_CHUNK

    @property
    def _is_int8(self) -> bool:
        return self.dtype_name == "int8"

    @property
    def _is_int4(self) -> bool:
        return self.dtype_name == "int4"

    @property
    def _is_quantized(self) -> bool:
        return self._is_int8 or self._is_int4

    @property
    def _row_width(self) -> int:
        """Storage columns per row (int4 packs two dims per byte)."""
        return self.dim // 2 if self._is_int4 else self.dim

    def _alloc(self, cap: int) -> None:
        self._gen += 1
        self._slab = torch.zeros(
            (cap, self._row_width), dtype=self._dtype, device=self.device
        )
        self._valid = torch.zeros((cap,), dtype=torch.bool, device=self.device)
        if self._is_quantized:
            self._scales = torch.zeros(
                (cap,), dtype=torch.float32, device=self.device
            )

    @staticmethod
    def _grown(old: torch.Tensor, new_cap: int) -> torch.Tensor:
        out = torch.zeros(
            (new_cap,) + tuple(old.shape[1:]), dtype=old.dtype,
            device=old.device,
        )
        out[: old.shape[0]] = old
        return out

    def _grow(self, need: int) -> None:
        # device peak during a copy-grow is old + new slab; bulk loads
        # near half of device memory should presize via INDEX_CAPACITY
        new_cap = self._round_cap(max(need, int(self._cap * 1.5)))
        self._slab = self._grown(self._slab, new_cap)
        self._valid = self._grown(self._valid, new_cap)
        if self._is_quantized:
            self._scales = self._grown(self._scales, new_cap)
        self._cap = new_cap
        self._gen += 1

    def _take_slots(self, n: int) -> np.ndarray:
        slots = []
        while self._free and len(slots) < n:
            slots.append(self._free.pop())
        fresh = n - len(slots)
        if fresh:
            if self._next_slot + fresh > self._cap:
                self._grow(self._next_slot + fresh)
            slots.extend(range(self._next_slot, self._next_slot + fresh))
            self._next_slot += fresh
        return np.asarray(slots, np.int64)

    def _prep(self, vectors):
        """Tensors stay tensors (no host round trip for ingest that
        generates on the device); anything else becomes float32 numpy."""
        if not isinstance(vectors, torch.Tensor):
            vectors = np.asarray(vectors, np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        if vectors.shape[-1] != self.dim:
            raise ValueError(
                f"vector dimension {vectors.shape[-1]} != index dimension {self.dim}"
            )
        return vectors

    def _slot_tensor(self, slots: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(
            np.asarray(slots, np.int64), device=self.device
        )

    def _scatter(self, slots: np.ndarray, vectors, flag: bool) -> None:
        # quantized slabs quantize inside the write; keep floats until then
        staging = torch.float32 if self._is_quantized else self._dtype
        vecs = to_tensor(vectors, self.device, staging)
        if self.metric == "cosine":
            vecs = l2_normalize(vecs).to(staging)
        self._write_rows(self._slot_tensor(slots), vecs, flag)

    def _write_rows(self, slots: torch.Tensor, vecs: torch.Tensor,
                    flag: bool) -> None:
        """Write rows (quantizing for int8 / int4) and validity flags. In
        place, or on clones while ``_cow_writes`` is set (a reader may
        hold the current tensors as a snapshot)."""
        cow = self._cow_writes
        slab = self._slab.clone() if cow else self._slab
        valid = self._valid.clone() if cow else self._valid
        if self._is_quantized:
            quant = quantize_rows_int4 if self._is_int4 else quantize_rows
            q, s = quant(vecs)
            scales = self._scales.clone() if cow else self._scales
            slab[slots] = q
            scales[slots] = s
            self._scales = scales
        else:
            slab[slots] = vecs.to(self._dtype)
        valid[slots] = flag
        self._slab, self._valid = slab, valid
        self._gen += 1

    def _tombstone(self, slots: torch.Tensor) -> None:
        cow = self._cow_writes
        valid = self._valid.clone() if cow else self._valid
        valid[slots] = False
        self._valid = valid
        self._gen += 1

    def _place(
        self,
        slab_np: np.ndarray,
        valid_np: np.ndarray,
        scales_np: np.ndarray | None = None,
    ) -> None:
        self._slab = slab_from_numpy(slab_np, self._dtype).to(self.device)
        self._valid = torch.from_numpy(
            np.require(valid_np, bool, ["C", "W", "O"])
        ).to(self.device)
        if scales_np is not None:
            self._scales = torch.from_numpy(
                np.require(scales_np, np.float32, ["C", "W", "O"])
            ).to(self.device)
        self._gen += 1

    # -- VectorIndex ------------------------------------------------------
    def add_batch(self, vectors) -> np.ndarray:
        with self._mu.write():
            vectors = self._prep(vectors)
            slots = self._take_slots(len(vectors))
            self._scatter(slots, vectors, True)
            self._size += len(vectors)
            return slots

    def update_slots(self, slots: np.ndarray, vectors) -> None:
        with self._mu.write():
            vectors = self._prep(vectors)
            self._scatter(np.asarray(slots, np.int64), vectors, True)

    def remove_slots(self, slots: np.ndarray) -> None:
        slots = np.asarray(slots, np.int64)
        if len(slots) == 0:
            return
        with self._mu.write():
            self._tombstone(self._slot_tensor(slots))
            self._size -= len(slots)
            self._free.extend(int(s) for s in slots)

    def _plan(self, b: int, slot_mask, stack: bool = False) -> Plan:
        return Plan(exact=True, mask=slot_mask, stack=stack)

    def _enqueue(self, queries, k: int, plan: Plan) -> Pending:
        """The flat route: the fused kernels on the card, ``exact_search``
        elsewhere, over every valid row (under ``plan.mask``)."""
        valid, cap = self._valid, self._cap
        if plan.mask is not None:
            valid = self._masked_valid_dev(valid, plan.mask, cap)
        q = to_tensor(queries, self.device)
        normalize = self.metric == "cosine"
        if self._resolve_topk() == "fused":
            from wdbx_tpu_torch.kernels.fused_topk import fused_topk_search

            # the kernels unpack int4 per tile: no unpacked slab exists
            scores, idx = fused_topk_search(
                self._slab, q, valid, k=min(k, cap),
                scales=self._scales if self._is_quantized else None,
                normalize=normalize, int4=self._is_int4,
            )
        else:
            slab = unpack_int4(self._slab) if self._is_int4 else self._slab
            scores, idx = exact_search(
                slab, q, k=min(k, cap), valid=valid,
                precision=self._precision, scales=self._scales,
                normalize=normalize,
            )
        return Pending(scores, idx, k, self._finish)

    def _enqueue_stack(self, q: torch.Tensor, k: int, plan: Plan) -> Pending:
        """The flat route's stack, ``min(k, capacity)`` columns: one
        launch pair of the fused kernels over all NB*B queries on the
        card, batch by batch elsewhere (as a subclass's scan route
        always goes)."""
        if not plan.exact:
            return super()._enqueue_stack(q, k, plan)
        kk = min(k, self._cap)
        if self._resolve_topk() != "fused":
            return super()._enqueue_stack(q, kk, plan)
        from wdbx_tpu_torch.kernels.fused_topk import fused_topk_search_batched

        scores, idx = fused_topk_search_batched(
            self._slab, q, self._valid, k=kk,
            scales=self._scales if self._is_quantized else None,
            normalize=self.metric == "cosine", int4=self._is_int4,
        )
        return Pending(scores, idx, kk, self._finish)

    def _finish(self, scores: np.ndarray, ids: np.ndarray, k: int):
        """Pad to k columns (k can exceed the capacity) and -1 wherever
        the score is -inf."""
        scores = np.asarray(scores, np.float32)
        out = np.array(ids, np.int64)
        if scores.shape[-1] < k:
            pad = [(0, 0)] * (scores.ndim - 1) + [(0, k - scores.shape[-1])]
            scores = np.pad(scores, pad, constant_values=-np.inf)
            out = np.pad(out, pad, constant_values=-1)
        out[scores == -np.inf] = -1
        return scores, out

    def _resolve_topk(self) -> str:
        if self.topk_method != "auto":
            return self.topk_method
        return "fused" if self.device.type == "cuda" else "exact"

    def _masked_valid_dev(self, valid, mask_np, cap):
        """Cached device AND of ``valid`` with a host filter mask, keyed
        by the mask object's identity and the write generation (every
        write bumps ``_gen``). The cache holds the mask so its id cannot
        be recycled while cached; a few live filters at most."""
        cache = getattr(self, "_maskdev_cache", None)
        if cache is None:
            cache = self._maskdev_cache = {}
        key = (id(mask_np), id(valid), self._gen)
        hit = cache.get(key)
        if hit is not None:
            return hit[2]
        full = np.zeros(cap, bool)
        n = min(len(mask_np), cap)
        full[:n] = mask_np[:n]
        dev = torch.logical_and(valid, torch.from_numpy(full).to(self.device))
        while len(cache) >= 4:
            cache.pop(next(iter(cache)))
        cache[key] = (mask_np, valid, dev)
        return dev

    def _mask_selectivity(self, slot_mask) -> float:
        """Fraction of LIVE rows a filter mask passes (bits on assigned,
        non-freed slots only)."""
        m = np.asarray(slot_mask[: self._next_slot], bool)
        matched = int(np.count_nonzero(m))
        # dead-but-unrecycled slots: the free list plus (on IVF layouts)
        # the rebuild quarantine
        dead = list(self._free) + list(getattr(self, "_quarantine", []))
        if dead and matched:
            fr = np.asarray([s for s in dead if s < len(m)], np.int64)
            if len(fr):
                matched -= int(np.count_nonzero(m[fr]))
        return matched / max(1, self._size)

    def get_vectors(self, slots: np.ndarray) -> np.ndarray:
        slots = np.asarray(slots, np.int64)
        with self._mu.read():
            idx = self._slot_tensor(slots)
            rows = self._slab[idx]
            if self._is_int4:
                rows = unpack_int4(rows)
            host = rows.to(torch.float32)
            if self._is_quantized:
                host = host * self._scales[idx][:, None]
            return host.cpu().numpy()

    def compact(self) -> tuple[np.ndarray, np.ndarray]:
        """Repack live rows into the lowest slots. Returns
        ``(old_slots, new_slots)`` so the caller can remap its id table."""
        with self._mu.write():
            live = np.nonzero(self._host_valid_np())[0]
            n = len(live)
            old_slots = live.astype(np.int64)
            new_slots = np.arange(n, dtype=np.int64)
            moved = old_slots[old_slots != new_slots]
            if len(moved) == 0:
                self._free = []
                self._next_slot = n
                return old_slots, new_slots
            rows = self.get_vectors(old_slots)  # dequantized f32 (n, dim)
            self._alloc(self._cap)
            self._size = 0
            self._free = []
            self._next_slot = 0
            if n:
                re_slots = self.add_batch(rows)
                assert (re_slots == new_slots).all()
            return old_slots, new_slots

    def clear(self) -> None:
        with self._mu.write():
            self._alloc(self._cap)
            self._size = 0
            self._free = []
            self._next_slot = 0
            self._slab_restore_pending = False

    def count(self) -> int:
        return self._size

    def valid_count(self) -> int:
        """Rows the device validity mask marks live (``store.verify``)."""
        return int(self._valid.sum())

    def _host_valid_np(self) -> np.ndarray:
        """The validity mask on the host, in slot order."""
        return self._valid.cpu().numpy()

    @property
    def capacity(self) -> int:
        return self._cap

    # -- persistence ------------------------------------------------------
    # Layout: <path>.npz holds the slab (bf16 saved as raw uint16 bits) +
    # validity (+ scales); <path>.meta.json holds scalars — the JAX
    # package's format. ``skip_slab`` writes a SLAB-EXTERNAL checkpoint
    # (everything but the slab), rebuilt at load from the store's raw
    # rows through ``restore_slab``.
    supports_slab_external = True

    def save(self, path: str, skip_slab: bool = False) -> None:
        with self._mu.read():
            self._save_locked(path, skip_slab=skip_slab)

    def _save_locked(self, path: str, skip_slab: bool = False) -> None:
        lead = self._is_lead()
        if lead:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        hwm = self._next_slot
        if self.persist_backend == "orbax":
            # one file a mesh position, written from its device (by the
            # rank holding it)
            from wdbx_tpu_torch.store import persist

            own, total = self._positions_held()
            persist.save_arrays(path, self._position_arrays(), own, total,
                                lead=lead, split=self._split_positions())
            skip_slab = False
        else:
            # skip_slab: valid derives on the host (allocated minus
            # freed); scales regenerate through the requantize at restore
            arrays = ({"valid": self._host_valid(hwm)} if skip_slab
                      else self._npz_arrays(hwm))
            if lead:
                np.savez(path + ".npz", **arrays)
        meta = self._persist_meta()
        if skip_slab:
            meta["slab_external"] = True
        if lead:
            with open(path + ".meta.json", "w") as f:
                json.dump(meta, f)
        self._barrier()

    def _is_lead(self) -> bool:
        """Whether this process writes the files every rank shares
        (always, outside a mesh spanning ranks)."""
        return True

    def _barrier(self) -> None:
        """Wait for every rank holding this index (no one, outside a mesh
        spanning ranks)."""

    def _split_positions(self) -> bool:
        """Whether the ranks share the writing of a per-position
        checkpoint (every rank then calls ``persist.save_arrays``, with
        the files it writes, maybe none)."""
        return False

    def _npz_arrays(self, hwm: int) -> dict[str, np.ndarray]:
        """The npz checkpoint's slot-order host arrays below ``hwm``."""
        arrays = {
            "valid": self._valid[:hwm].cpu().numpy(),
            "slab": slab_to_numpy(self._slab[:hwm]),
        }
        if self._is_quantized:
            arrays["scales"] = self._scales[:hwm].cpu().numpy()
        return arrays

    def _host_valid(self, hwm: int) -> np.ndarray:
        """Validity bitmap from host bookkeeping: allocated positions are
        live unless freed."""
        valid = np.ones(hwm, bool)
        dead = [int(p) for p in self._free if p < hwm]
        if dead:
            valid[np.asarray(dead, np.int64)] = False
        return valid

    def _persist_meta(self) -> dict:
        return {
            "dim": self.dim,
            "metric": self.metric,
            "dtype": self.dtype_name,
            "size": self._size,
            "next_slot": self._next_slot,
            "free": self._free,
            "kind": self.kind,
            "backend": self.persist_backend,
            "capacity": self._cap,
        }

    def load(self, path: str) -> bool:
        with self._mu.write():
            return self._load_locked(path)

    def _load_locked(self, path: str) -> bool:
        if not os.path.exists(path + ".meta.json"):
            return False
        # storage is being replaced wholesale: an in-flight background
        # rebuild must abandon its snapshot
        self._layout_gen = getattr(self, "_layout_gen", 0) + 1
        with open(path + ".meta.json") as f:
            meta = json.load(f)
        if meta["dim"] != self.dim:
            raise ValueError(
                f"persisted index dim {meta['dim']} != configured {self.dim}"
            )
        if meta.get("backend") != "orbax" and \
                not os.path.exists(path + ".npz"):
            return False
        self.dtype_name = meta["dtype"]
        self._dtype = _DTYPES[self.dtype_name]
        self._precision = "highest" if self.dtype_name == "float32" else "default"
        if meta.get("backend") == "orbax":
            return self._load_positions(path, meta)
        data = np.load(path + ".npz")
        hwm = int(meta["next_slot"])
        self._cap = self._round_cap(
            max(hwm, 1024, getattr(self, "_declared_cap", 0))
        )
        # drop the presized slab BEFORE allocating the loaded one
        self._slab = self._valid = self._scales = None
        valid = np.asarray(data["valid"], bool)
        valid_np = np.zeros((self._cap,), bool)
        scales_np = (
            np.zeros((self._cap,), np.float32) if self._is_quantized else None
        )
        if hwm:
            valid_np[:hwm] = valid[:hwm]
            if self._is_quantized and "scales" in data:
                scales_np[:hwm] = data["scales"]
        if meta.get("slab_external"):
            # slab omitted: zeros on the device, refilled by restore_slab()
            self._alloc(self._cap)
            self._valid = torch.from_numpy(valid_np).to(self.device)
            if self._is_quantized:
                self._scales = torch.from_numpy(scales_np).to(self.device)
        else:
            self._install_loaded(data["slab"] if hwm else None, valid_np,
                                 scales_np)
        self._gen += 1
        self._size = int(meta["size"])
        self._next_slot = hwm
        self._free = [int(s) for s in meta["free"]]
        # host-side validity snapshot for restore_slab
        self._loaded_valid_np = valid_np[:hwm].copy()
        self._slab_restore_pending = bool(meta.get("slab_external"))
        return True

    def _install_loaded(self, slab_hwm, valid_np: np.ndarray,
                        scales_np: np.ndarray | None) -> None:
        """Place a loaded checkpoint: ``slab_hwm`` holds the rows below
        the high-water mark (checkpoint encoding), ``valid_np`` /
        ``scales_np`` the whole capacity."""
        self._slab = torch.zeros(
            (self._cap, self._row_width), dtype=self._dtype,
            device=self.device,
        )
        if slab_hwm is not None:
            self._slab[: len(slab_hwm)] = slab_from_numpy(
                slab_hwm, self._dtype
            ).to(self.device)
        self._valid = torch.from_numpy(valid_np).to(self.device)
        if scales_np is not None:
            self._scales = torch.from_numpy(scales_np).to(self.device)

    def _positions_held(self, writing: bool = True
                        ) -> tuple[list[int], int]:
        """The per-position checkpoint's positions that this process
        writes (``writing``) or reads, and the checkpoint's position
        count: one here."""
        return [0], 1

    def _position_arrays(self) -> dict[str, list[torch.Tensor]]:
        """The per-position checkpoint's arrays of the positions this
        process holds: one here."""
        arrays = {"slab": [self._slab], "valid": [self._valid]}
        if self._is_quantized:
            arrays["scales"] = [self._scales]
        return arrays

    def _install_positions(self, arrays: dict[str, list]) -> None:
        self._slab, self._valid = arrays["slab"][0], arrays["valid"][0]
        if self._is_quantized:
            self._scales = arrays["scales"][0]

    def _load_positions(self, path: str, meta: dict) -> bool:
        """Load a per-position (``PERSIST_BACKEND=orbax``) checkpoint
        onto this index's positions, at its saved capacity."""
        from wdbx_tpu_torch.store import persist

        own, total = self._positions_held(writing=False)
        arrays = persist.load_arrays(path, self._position_devices(), own,
                                     total)
        if arrays is None:
            return False
        self._cap = int(meta["capacity"])
        self._slab = self._valid = self._scales = None
        self._install_positions(arrays)
        self._gen += 1
        self._size = int(meta["size"])
        self._next_slot = int(meta["next_slot"])
        self._free = [int(s) for s in meta["free"]]
        self._loaded_valid_np = self._host_valid_np()[: self._next_slot]
        self._slab_restore_pending = False
        self.persist_backend = "orbax"
        return True

    def _position_devices(self) -> list[torch.device]:
        """Where a per-position checkpoint's positions load: one here."""
        return [self.device]

    def _slots_for_positions(self, positions: np.ndarray) -> np.ndarray:
        """Slab position -> external slot (the identity here; clustered
        layouts map through their slot table)."""
        return positions

    def restore_slab(self, reader, chunk: int = 262_144) -> bool:
        """Refill the device slab from a host row source after loading a
        slab-external checkpoint. ``reader(slots) -> (rows, row_scales,
        have)`` is the store's raw-row gather; int8 raw codes come with
        their scales and requantize on the device."""
        if not getattr(self, "_slab_restore_pending", False):
            return False
        pos_all = np.nonzero(self._loaded_valid_np)[0].astype(np.int64)
        slots_all = np.asarray(self._slots_for_positions(pos_all), np.int64)
        # in slot order: clustered layouts permute positions, and a
        # slot-ordered pass reads the raw store sequentially
        order = np.argsort(slots_all, kind="stable")
        pos_all, slots_all = pos_all[order], slots_all[order]
        with self._mu.write():
            for lo in range(0, len(pos_all), chunk):
                pos = pos_all[lo:lo + chunk]
                rows, row_scales, have = reader(slots_all[lo:lo + chunk])
                if not have.all():
                    raise ValueError(
                        f"slab restore: raw store is missing "
                        f"{int((~have).sum())} of {len(pos)} rows — "
                        "checkpoint unusable without its row source"
                    )
                if row_scales is not None:
                    self._scatter_requant(pos, rows, row_scales)
                else:
                    self._scatter(pos, np.asarray(rows, np.float32), True)
            self._slab_restore_pending = False
        return True

    def _scatter_requant(
        self, slots: np.ndarray, q: np.ndarray, row_scales: np.ndarray
    ) -> None:
        """Restore-path write of int8 raw codes: dequantize (and
        normalize) on the device, then quantize into the slab — only the
        int8 bytes cross from the host. ``q`` / ``row_scales`` are the
        caller's reused scratch: the copies below finish before return."""
        n = len(slots)
        codes = torch.from_numpy(np.array(q[:n], np.int8)).to(self.device)
        sc = torch.from_numpy(
            np.array(row_scales[:n], np.float32)
        ).to(self.device)
        rows = codes.to(torch.float32) * sc[:, None]
        if self.metric == "cosine":
            rows = l2_normalize(rows)
        self._write_rows(self._slot_tensor(slots), rows, True)

    def get_stats(self) -> dict:
        stats = super().get_stats()
        stats.update(
            dtype=self.dtype_name,
            tombstones=len(self._free),
            hbm_bytes=int(self._slab.numel()) * self._slab.element_size(),
            device=str(self.device),
        )
        return stats
