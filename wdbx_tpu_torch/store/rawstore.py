"""Slot-indexed raw-vector sidecar: one disk-backed memmap per shard.

Replaces the per-id host dict of float32 arrays the store used to keep
for exact re-ranking and ``get()`` round-trips (reference semantics:
the raw vector survives quantized indexing, reference
wdbx/core/vector_store.py:66-67 keeps ``self.vectors`` next to the
index). The dict could not exist at the capacity tier: 20M x 768 f32
is ~59 GB of host RAM *plus* a 20M-entry dict, and persisting it
materialized ``np.stack`` over every row (a 2x RSS spike at save).

This store is three flat files per shard under ``data_dir/vectors/``:

  * ``raw_shard{N}.bin``      — ``(cap, dim)`` rows at ``dtype``
  * ``raw_shard{N}.scale.bin`` — ``(cap,)`` f32 per-row scales (int8 only)
  * ``raw_shard{N}.ok.bin``   — ``(cap,)`` u8 written flags

indexed directly by the index's stable external slot ids, so

  * writes are row scatters into the memmap (dirty pages, no host copy);
  * the re-rank gather is one fancy-index over a contiguous array —
    page-cache-backed, never materializing the file;
  * persistence is free: the memmap IS the on-disk format (``save`` is
    an msync, not an ``np.stack`` of the corpus);
  * RSS is page cache (evictable), not anonymous heap.

Precision tiers (``RAW_STORE_DTYPE``): ``float32`` (exact — the default,
byte-identical ``get()`` round trips), ``float16`` (half the bytes,
~1e-3 relative error), ``int8`` (quarter, per-row absmax scale — ranks
within ~0.001 recall@10 of f32 for re-rank, the tier that serves the
20M x 768 int4 flagship from ~15 GB of disk).
"""

from __future__ import annotations

import json
import os

import numpy as np

_DTYPES = {
    "float32": np.float32,
    "float16": np.float16,
    "int8": np.int8,
}

_GROW_MIN = 1024


def _runs(slots: np.ndarray):
    """Yield ``(a, b)`` index ranges of consecutive-increment runs in
    ``slots`` (order-preserving; duplicates and arbitrary order are
    just runs of length 1)."""
    n = len(slots)
    if n == 0:
        return
    breaks = np.flatnonzero(np.diff(slots) != 1) + 1
    a = 0
    for b in breaks.tolist():
        yield a, b
        a = b
    yield a, n


def _round_cap(need: int) -> int:
    """Power-of-two below 1M slots, 1M multiples above (file growth is
    cheap — sparse files — but remapping views is not free)."""
    if need <= (1 << 20):
        return 1 << max(10, (need - 1).bit_length())
    return -(-need // (1 << 20)) * (1 << 20)


class RawStore:
    """Slot-indexed raw vectors, one file set per shard.

    ``backend="mmap"`` (default) writes through to disk-backed memmaps —
    constant RSS, ``save()`` is an msync of dirty pages; writes run at
    disk speed. ``backend="ram"`` keeps the arrays anonymous (fast
    first-touch) and serializes them to the same files only at
    ``flush()`` — the ingest-throughput tier when host RAM covers the
    raw set (e.g. 20M x 768 int8 = ~15 GB)."""

    def __init__(
        self,
        data_dir: str,
        num_shards: int,
        dim: int,
        dtype: str = "float32",
        backend: str = "mmap",
    ):
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported raw-store dtype: {dtype}")
        if backend not in ("mmap", "ram"):
            raise ValueError(f"unsupported raw-store backend: {backend}")
        self.dir = os.path.join(data_dir, "vectors")
        os.makedirs(self.dir, exist_ok=True)
        self.num_shards = num_shards
        self.dim = dim
        self.dtype_name = dtype
        self.backend = backend
        self._dtype = _DTYPES[dtype]
        self._rows: list[np.ndarray | None] = [None] * num_shards
        self._scales: list[np.ndarray | None] = [None] * num_shards
        self._ok: list[np.ndarray | None] = [None] * num_shards
        self._caps = [0] * num_shards
        #: fd caches for the pread/pwrite row paths (offset-explicit,
        #: so shared fds are thread-safe)
        self._rfds: dict[tuple[int, str], int] = {}
        self._wfds: dict[tuple[int, str], int] = {}
        meta_path = os.path.join(self.dir, "raw_meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("dim") != dim:
                # same operator-facing contract as the index loader: a
                # dimension mismatch is a CONFIG error — refuse to start
                raise ValueError(
                    f"data_dir raw store at {self.dir!r} holds a "
                    f"different-dimension vector set (dim {meta.get('dim')}, "
                    f"configured {dim}); pass the matching vector_dimension "
                    "/ --dimension / WDBX_VECTOR_DIMENSION"
                )
            # the persisted dtype wins: reopening with a different
            # configured precision must not reinterpret the bytes
            self.dtype_name = meta.get("dtype", dtype)
            self._dtype = _DTYPES[self.dtype_name]
            for shard in range(num_shards):
                if os.path.exists(self._path(shard, "bin")):
                    self._open(shard)
        else:
            self._write_meta()

    # -- files ------------------------------------------------------------
    def _path(self, shard: int, kind: str) -> str:
        suffix = {"bin": ".bin", "scale": ".scale.bin", "ok": ".ok.bin"}[kind]
        return os.path.join(self.dir, f"raw_shard{shard}{suffix}")

    def _write_meta(self) -> None:
        with open(os.path.join(self.dir, "raw_meta.json"), "w") as f:
            json.dump({"dim": self.dim, "dtype": self.dtype_name}, f)

    def _open(self, shard: int) -> None:
        """(Re)attach the shard's files at their current on-disk size
        (memmap views, or full reads for the ram backend)."""
        itemsize = np.dtype(self._dtype).itemsize
        nbytes = os.path.getsize(self._path(shard, "bin"))
        cap = nbytes // (self.dim * itemsize)
        if cap == 0:
            return
        rows = np.memmap(
            self._path(shard, "bin"), dtype=self._dtype, mode="r+",
            shape=(cap, self.dim),
        )
        ok = np.memmap(
            self._path(shard, "ok"), dtype=np.uint8, mode="r+", shape=(cap,)
        )
        scale = None
        if self.dtype_name == "int8":
            scale = np.memmap(
                self._path(shard, "scale"), dtype=np.float32, mode="r+",
                shape=(cap,),
            )
        if self.backend == "ram":
            rows = np.array(rows)
            ok = np.array(ok)
            scale = np.array(scale) if scale is not None else None
        self._rows[shard], self._ok[shard] = rows, ok
        self._scales[shard] = scale
        self._caps[shard] = cap

    def _ensure(self, shard: int, need_slots: int) -> None:
        if self._caps[shard] >= need_slots:
            return
        cap = _round_cap(max(need_slots, _GROW_MIN,
                             int(self._caps[shard] * 1.5)))
        itemsize = np.dtype(self._dtype).itemsize
        if self.backend == "ram":
            old = self._caps[shard]
            rows = np.zeros((cap, self.dim), self._dtype)
            ok = np.zeros(cap, np.uint8)
            if old:
                rows[:old] = self._rows[shard]
                ok[:old] = self._ok[shard]
            if self.dtype_name == "int8":
                scale = np.zeros(cap, np.float32)
                if old:
                    scale[:old] = self._scales[shard]
                self._scales[shard] = scale
            self._rows[shard], self._ok[shard] = rows, ok
            self._caps[shard] = cap
            return
        # Grow the files, then swap in fresh views WITHOUT ever nulling
        # the current ones: the re-rank path reads these arrays
        # lock-free (epoch-validated), so a None window would crash a
        # concurrent search. Extending a file under a live readonly
        # view is safe on Linux (the old mapping stays valid for its
        # original range), and readers snapshot the array references
        # locally (see read()).
        specs = [("bin", cap * self.dim * itemsize), ("ok", cap)]
        if self.dtype_name == "int8":
            specs.append(("scale", cap * 4))
        for kind, nbytes in specs:
            path = self._path(shard, kind)
            mode = "r+b" if os.path.exists(path) else "w+b"
            with open(path, mode) as f:
                f.truncate(nbytes)  # sparse extension: zero-filled
        self._open(shard)

    # -- data plane ---------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return True

    #: int8-quantize work-chunk: temporaries stay in two reused scratch
    #: buffers (~100 MB) — whole-batch temporaries at bulk_load scale
    #: allocated ~2.5 GB of fresh pages per chunk, and page first-touch
    #: on the JAX package's TPU host made RawStore.write most of ingest
    _CHUNK = 32_768

    def write(self, shard: int, slots: np.ndarray, rows: np.ndarray) -> None:
        """Scatter f32 ``rows`` at ``slots`` (quantizing per the store
        dtype). Vectorized; dirty pages flush lazily (or at save())."""
        slots = np.asarray(slots, np.int64)
        if len(slots) == 0:
            return
        self._ensure(shard, int(slots.max()) + 1)
        rows = np.asarray(rows, np.float32)
        if self.dtype_name != "int8":
            data = (
                rows if rows.dtype == self._dtype
                else rows.astype(self._dtype)
            )
            if not self._scatter_rows(shard, slots, data):
                # fancy-index assignment casts in C without a copy
                self._rows[shard][slots] = rows
            self._ok[shard][slots] = 1
            return
        ch = self._CHUNK
        # scratch sized to the actual write (<= _CHUNK): a full-chunk
        # allocation retained ~125 MB after a 10k-row update
        need = min(ch, len(slots))
        if (
            not hasattr(self, "_scratch_f")
            or len(self._scratch_f) < need
        ):
            self._scratch_f = np.empty((need, self.dim), np.float32)
            self._scratch_q = np.empty((need, self.dim), np.int8)
        for lo in range(0, len(slots), ch):
            sl = slots[lo:lo + ch]
            r = rows[lo:lo + ch]
            n = len(sl)
            buf = self._scratch_f[:n]
            np.abs(r, out=buf)
            scale = buf.max(axis=1)
            np.maximum(scale, 1e-12, out=scale)
            scale /= 127.0
            np.divide(r, scale[:, None], out=buf)
            np.rint(buf, out=buf)
            np.clip(buf, -127, 127, out=buf)
            q = self._scratch_q[:n]
            np.copyto(q, buf, casting="unsafe")
            if not self._scatter_rows(shard, sl, q):
                self._rows[shard][sl] = q
            self._scales[shard][sl] = scale
        self._ok[shard][slots] = 1

    def write_quantized(
        self,
        shard: int,
        slots: np.ndarray,
        qrows: np.ndarray,
        scales: np.ndarray,
    ) -> None:
        """Scatter rows already quantized to the store's int8 tier
        (``qrows`` int8, ``scales`` f32 per-row). The capacity-tier
        ingest path: quantization runs on device next to the slab build
        and only the int8 bytes cross the host boundary — 4x fewer
        wire bytes than shipping f32 rows to :meth:`write`."""
        if self.dtype_name != "int8":
            raise ValueError(
                "write_quantized requires an int8 raw store "
                f"(this store is {self.dtype_name})"
            )
        slots = np.asarray(slots, np.int64)
        if len(slots) == 0:
            return
        self._ensure(shard, int(slots.max()) + 1)
        q = np.asarray(qrows, np.int8)
        if not self._scatter_rows(shard, slots, q):
            self._rows[shard][slots] = q
        self._scales[shard][slots] = np.asarray(scales, np.float32)
        self._ok[shard][slots] = 1

    def read(
        self, shard: int, slots: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Gather rows by slot. Returns ``(rows_f32, have)`` — ``have``
        is False for slots never written (their rows are zeros)."""
        slots = np.asarray(slots, np.int64)
        # snapshot the view references ONCE and derive the usable
        # capacity from the arrays themselves (never self._caps): a
        # concurrent grow may swap the views mid-read, and mixing a new
        # cap with an old (smaller) view would index out of bounds.
        # Content-level races are handled by the caller's epoch retry;
        # this only has to be crash-free.
        rows_v, ok_v = self._rows[shard], self._ok[shard]
        sc_v = self._scales[shard]
        if rows_v is None or ok_v is None or len(slots) == 0:
            return (
                np.zeros((len(slots), self.dim), np.float32),
                np.zeros(len(slots), bool),
            )
        cap = min(rows_v.shape[0], len(ok_v))
        if sc_v is not None:
            cap = min(cap, len(sc_v))
        if cap == 0:
            return (
                np.zeros((len(slots), self.dim), np.float32),
                np.zeros(len(slots), bool),
            )
        safe = np.clip(slots, 0, cap - 1)
        in_range = (slots >= 0) & (slots < cap)
        have = (ok_v[safe] != 0) & in_range
        raw = np.empty((len(safe), self.dim), rows_v.dtype)
        if not self._gather_rows(shard, safe, raw):
            np.take(rows_v, safe, axis=0, out=raw)
        rows = raw.astype(np.float32)
        if self.dtype_name == "int8":
            rows *= sc_v[safe][:, None]
        rows[~have] = 0.0
        return rows, have

    def read_native(
        self,
        shard: int,
        slots: np.ndarray,
        out_q: np.ndarray | None = None,
        out_s: np.ndarray | None = None,
    ):
        """int8 stores only: gather quantized codes + per-row scales
        WITHOUT dequantizing — the slab-restore fast path ships int8
        straight to the device (4x fewer H2D bytes, no host f32
        temporaries). ``out_q``/``out_s`` are caller-reused buffers.
        Returns ``(q, scales, have)`` or None for non-int8 stores."""
        if self.dtype_name != "int8":
            return None
        slots = np.asarray(slots, np.int64)
        n = len(slots)
        rows_v, ok_v, sc_v = (
            self._rows[shard], self._ok[shard], self._scales[shard]
        )
        q = out_q[:n] if out_q is not None else np.empty(
            (n, self.dim), np.int8
        )
        s = out_s[:n] if out_s is not None else np.empty(n, np.float32)
        if rows_v is None or n == 0:
            q[:] = 0
            s[:] = 0.0
            return q, s, np.zeros(n, bool)
        cap = min(rows_v.shape[0], len(ok_v), len(sc_v))
        s0, s1 = int(slots[0]), int(slots[-1])
        # strictly-consecutive check: the span test alone misreads a
        # sorted array WITH DUPLICATES (e.g. [5,5,7] spans 3) as dense
        # and would return neighbouring rows under the wrong slots
        if (
            s1 - s0 + 1 == n and 0 <= s0 and s1 < cap
            and (n == 1 or bool((np.diff(slots) == 1).all()))
        ):
            # dense ascending range (the slot-sorted restore's common
            # case). For the mmap backend, pread INTO the caller's
            # reused scratch instead of slicing the memmap: a memmap
            # copy installs every source page in this process
            # (page faults were the slab-restore wall on the JAX
            # package's TPU host), while pread copies straight from the
            # page cache into already-touched scratch pages. The write
            # path's mapped pages ARE the page cache (shared file
            # mapping), so pread sees unflushed writes too.
            if not self._pread_into(shard, "bin", q, s0 * self.dim):
                np.copyto(q, rows_v[s0:s1 + 1])
            if not self._pread_into(shard, "scale", s, s0 * 4):
                np.copyto(s, sc_v[s0:s1 + 1])
            have = ok_v[s0:s1 + 1] != 0
        else:
            safe = np.clip(slots, 0, cap - 1)
            have = (ok_v[safe] != 0) & (slots >= 0) & (slots < cap)
            if not self._gather_rows(shard, safe, q):
                np.take(rows_v, safe, axis=0, out=q)
            np.take(sc_v, safe, out=s)
        q[~have] = 0
        s[~have] = 0.0
        return q, s, have

    def _fd(self, shard: int, kind: str, write: bool = False):
        """Cached fd for the shard's ``kind`` file (None = unavailable;
        the caller falls back to the mapped view). The mmap backend's
        files only ever grow in place (truncate extension), so a cached
        fd never goes stale; reads and writes are offset-explicit
        (pread/pwrite), so sharing across threads is safe."""
        if self.backend == "ram":
            return None
        cache = self._wfds if write else self._rfds
        key = (shard, kind)
        fd = cache.get(key)
        if fd is None:
            try:
                fd = os.open(
                    self._path(shard, kind),
                    os.O_RDWR if write else os.O_RDONLY,
                )
            except OSError:
                return None
            cache[key] = fd
        return fd

    def _pread_into(self, shard: int, kind: str, out: np.ndarray,
                    byte_off: int) -> bool:
        """``os.pread`` the exact byte range into C-contiguous ``out``.
        False when the backend is ram or the read comes up short (the
        caller falls back to the array view)."""
        fd = self._fd(shard, kind)
        if fd is None:
            return False
        mv = memoryview(out).cast("B")
        try:
            return os.preadv(fd, [mv], byte_off) == len(mv)
        except OSError:
            return False

    # -- fd-based row scatter/gather ------------------------------------
    # Random access THROUGH the row mapping is an RSS trap on large-
    # folio kernels: each fault maps the whole page-cache folio into
    # the process (on the JAX package's TPU host a 10k-row random
    # scatter at 10M x 768 added GBs of RSS; MADV_RANDOM does not
    # help). pread/pwrite
    # move the same bytes through the shared page cache without
    # mapping anything, at the same speed. Consecutive-slot runs batch
    # into single calls, so bulk loads stay one-syscall-per-chunk.

    def _scatter_rows(self, shard: int, slots: np.ndarray,
                      arr: np.ndarray) -> bool:
        """pwrite ``arr`` (n, row_width) at ``slots``; False -> caller
        falls back to the mapped view. ``arr`` dtype must already be
        the store dtype."""
        fd = self._fd(shard, "bin", write=True)
        if fd is None:
            return False
        arr = np.ascontiguousarray(arr)
        rb = arr.shape[1] * arr.dtype.itemsize
        mv = memoryview(arr).cast("B")
        try:
            for a, b in _runs(slots):
                want = (b - a) * rb
                if os.pwritev(
                    fd, [mv[a * rb:b * rb]], int(slots[a]) * rb
                ) != want:
                    return False
        except OSError:
            return False
        return True

    def _gather_rows(self, shard: int, slots: np.ndarray,
                     out: np.ndarray) -> bool:
        """pread rows at ``slots`` into C-contiguous ``out`` (n,
        row_width) of the store dtype; False -> caller falls back."""
        fd = self._fd(shard, "bin")
        if fd is None:
            return False
        rb = out.shape[1] * out.dtype.itemsize
        mv = memoryview(out).cast("B")
        try:
            for a, b in _runs(slots):
                want = (b - a) * rb
                if os.preadv(
                    fd, [mv[a * rb:b * rb]], int(slots[a]) * rb
                ) != want:
                    return False
        except OSError:
            return False
        return True

    def has(self, shard: int, slots: np.ndarray) -> np.ndarray:
        """ok-flag gather only, no row reads — the coverage gate for
        slab-external checkpoints (store skips persisting the device
        slab only when every live row is reconstructable from here)."""
        slots = np.asarray(slots, np.int64)
        ok_v = self._ok[shard]
        if ok_v is None or len(slots) == 0:
            return np.zeros(len(slots), bool)
        cap = len(ok_v)
        safe = np.clip(slots, 0, cap - 1)
        return (ok_v[safe] != 0) & (slots >= 0) & (slots < cap)

    def drop(self, shard: int, slots: np.ndarray) -> None:
        slots = np.asarray(slots, np.int64)
        cap = self._caps[shard]
        if cap == 0 or len(slots) == 0:
            return
        sel = slots[(slots >= 0) & (slots < cap)]
        self._ok[shard][sel] = 0

    def remap(self, shard: int, old: np.ndarray, new: np.ndarray) -> None:
        """Move rows after an index compaction renumbered slots
        (``old[i] -> new[i]``; compaction packs downward, so a forward
        gather into a fresh prefix is safe)."""
        old = np.asarray(old, np.int64)
        new = np.asarray(new, np.int64)
        cap = self._caps[shard]
        if cap == 0 or len(old) == 0:
            return
        keep = old < cap
        old, new = old[keep], new[keep]
        self._ensure(shard, int(new.max()) + 1 if len(new) else 1)
        rows = self._rows[shard][old].copy()
        ok = self._ok[shard][old].copy()
        self._ok[shard][:] = 0
        self._rows[shard][new] = rows
        self._ok[shard][new] = ok
        if self.dtype_name == "int8":
            sc = self._scales[shard][old].copy()
            self._scales[shard][new] = sc

    def clear(self) -> None:
        for shard in range(self.num_shards):
            if self._ok[shard] is not None:
                self._ok[shard][:] = 0

    def flush(self) -> None:
        if self.backend == "ram":
            for shard in range(self.num_shards):
                if self._rows[shard] is None:
                    continue
                self._rows[shard].tofile(self._path(shard, "bin"))
                self._ok[shard].tofile(self._path(shard, "ok"))
                if self._scales[shard] is not None:
                    self._scales[shard].tofile(self._path(shard, "scale"))
        else:
            for views in (self._rows, self._scales, self._ok):
                for mm in views:
                    if mm is not None and isinstance(mm, np.memmap):
                        mm.flush()
            # rows written via pwrite dirty the page cache, not the
            # mapping — msync above does not cover them
            for fd in self._wfds.values():
                try:
                    os.fsync(fd)
                except OSError:
                    pass
        self._write_meta()


class NullRawStore:
    """RAW_STORE=none: keeps nothing; every read reports absent."""

    dtype_name = "none"
    enabled = False

    def __init__(self, dim: int):
        self.dim = dim

    def write(self, shard, slots, rows) -> None:
        pass

    def read(self, shard, slots):
        n = len(np.asarray(slots))
        return np.zeros((n, self.dim), np.float32), np.zeros(n, bool)

    def has(self, shard, slots):
        return np.zeros(len(np.asarray(slots)), bool)

    def read_native(self, shard, slots, out_q=None, out_s=None):
        return None

    def drop(self, shard, slots) -> None:
        pass

    def remap(self, shard, old, new) -> None:
        pass

    def clear(self) -> None:
        pass

    def flush(self) -> None:
        pass


def create_raw_store(
    config, data_dir: str, num_shards: int, dim: int
):
    """RAW_STORE: "auto" (memmap when VECTOR_STORE_KEEP_RAW, else none),
    "memmap" (write-through disk pages, constant RSS), "ram"
    (anonymous arrays, serialized at save — the ingest-throughput
    tier), or "none". RAW_STORE_DTYPE picks the precision tier."""
    mode = str(config.get("RAW_STORE", "auto")).lower()
    keep = bool(config.get("VECTOR_STORE_KEEP_RAW", True))
    if mode == "auto":
        mode = "memmap" if keep else "none"
    if mode == "none":
        return NullRawStore(dim)
    if mode not in ("memmap", "ram"):
        raise ValueError(f"unsupported RAW_STORE mode: {mode}")
    dtype = str(config.get("RAW_STORE_DTYPE", "float32")).lower()
    return RawStore(
        data_dir, num_shards, dim, dtype=dtype,
        backend="ram" if mode == "ram" else "mmap",
    )
