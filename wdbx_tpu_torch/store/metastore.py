"""Columnar metadata store: slot-aligned typed columns per shard.

The reference keeps metadata as one host dict of dicts and persists it
as a single JSON blob (reference wdbx/core/vector_store.py:66-67,
:136-176). That shape has three walls at the corpus sizes the device
side reaches (10-20M rows): the dict-of-dicts costs GBs of object heap,
``json.dump``/``load`` of one blob takes minutes and spikes RSS, and
building a device filter mask walks every entry in Python per
first-seen filter.

Here metadata lives as typed numpy columns indexed by the index's
stable external slot ids, one column set per shard:

  * ``set``/``get``/``drop`` are row scatters/gathers;
  * a filter mask is a handful of vectorized numpy comparisons over the
    columns — O(N) in C, not Python (the ``$gt $lt $gte $lte $in $nin
    $exists`` + equality operator set of reference
    wdbx/core/vector_store.py:414-463);
  * persistence is one npz of columns per shard (seconds at 10M) plus a
    small JSON sidecar for non-scalar values — no single-blob spike.

Column kinds and promotion: values are typed ``bool``/``int``/``float``/
``str`` columns when homogeneous; mixed int/float promotes to float,
anything else (None, lists, dicts, mixed types) demotes the column to a
Python-object column that still vectorizes through numpy object ufuncs.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterable

import numpy as np

_GROW_MIN = 1024


def _json_default(o: Any):
    """Numpy scalars in object columns serialize as their Python value."""
    if isinstance(o, np.generic):
        return o.item()
    raise TypeError(
        f"metadata value of type {o.__class__.__name__} is not JSON "
        "serializable"
    )


def _kind_of(value: Any) -> str:
    t = type(value)
    if t is bool:
        return "bool"
    if t is int:
        return "int"
    if t is float:
        return "float"
    if t is str:
        return "str"
    return "obj"


def _empty_vals(kind: str, cap: int, width: int = 8) -> np.ndarray:
    if kind == "bool":
        return np.zeros(cap, bool)
    if kind == "int":
        return np.zeros(cap, np.int64)
    if kind == "float":
        return np.zeros(cap, np.float64)
    if kind == "str":
        return np.zeros(cap, dtype=f"U{width}")
    return np.full(cap, None, dtype=object)


def _to_py(value: Any, kind: str) -> Any:
    if kind == "bool":
        return bool(value)
    if kind == "int":
        return int(value)
    if kind == "float":
        return float(value)
    if kind == "str":
        return str(value)
    return value


class _Column:
    __slots__ = ("kind", "vals", "has")

    def __init__(self, kind: str, cap: int):
        self.kind = kind
        self.vals = _empty_vals(kind, cap)
        self.has = np.zeros(cap, bool)

    def _grow(self, cap: int) -> None:
        if len(self.has) >= cap:
            return
        vals = _empty_vals(self.kind, cap, width=self._width())
        vals[: len(self.vals)] = self.vals
        self.vals = vals
        has = np.zeros(cap, bool)
        has[: len(self.has)] = self.has
        self.has = has

    def _width(self) -> int:
        return self.vals.dtype.itemsize // 4 if self.kind == "str" else 8

    def _promote(self, kind: str) -> None:
        """Convert this column to hold ``kind`` values as well; the
        lattice is int|float -> float, everything else -> obj."""
        if self.kind == kind:
            return
        if {self.kind, kind} == {"int", "float"}:
            self.vals = self.vals.astype(np.float64)
            self.kind = "float"
            return
        out = np.full(len(self.vals), None, dtype=object)
        idx = np.nonzero(self.has)[0]
        k = self.kind
        out[idx] = [_to_py(v, k) for v in self.vals[idx]]
        self.vals = out
        self.kind = "obj"

    def _fit_str(self, width: int) -> None:
        if self.kind == "str" and self.vals.dtype.itemsize < width * 4:
            self.vals = self.vals.astype(f"U{max(width, 2 * self._width())}")

    def set_one(self, slot: int, value: Any) -> None:
        kind = _kind_of(value)
        if kind != self.kind and not (
            kind in ("int", "float") and self.kind == "float"
        ):
            self._promote(kind)
        if self.kind == "str":
            self._fit_str(len(value))
        self.vals[slot] = value
        self.has[slot] = True

    _NP_KINDS = {"b": "bool", "i": "int", "u": "int", "f": "float",
                 "U": "str"}

    def set_many(self, slots: np.ndarray, values) -> None:
        if (
            isinstance(values, np.ndarray)
            and values.dtype.kind in self._NP_KINDS
        ):
            # vectorized path: a typed numpy column assigns directly
            want = self._NP_KINDS[values.dtype.kind]
            if want != self.kind and not (
                want in ("int", "float") and self.kind == "float"
            ):
                self._promote(want)
            if self.kind == "str":
                self._fit_str(values.dtype.itemsize // 4)
                self.vals[slots] = values.astype(self.vals.dtype)
            elif self.kind == "obj":
                self.vals[slots] = values.astype(object)
            else:
                self.vals[slots] = values
            self.has[slots] = True
            return
        values = list(values)
        kinds = {_kind_of(v) for v in values}
        want = kinds.pop() if len(kinds) == 1 else (
            "float" if kinds <= {"int", "float"} else "obj"
        )
        if want != self.kind and not (
            want in ("int", "float") and self.kind == "float"
        ):
            self._promote(want)
        if self.kind == "str":
            self._fit_str(max(len(v) for v in values))
            self.vals[slots] = np.asarray(values, dtype=self.vals.dtype)
        elif self.kind == "obj":
            arr = np.full(len(values), None, dtype=object)
            arr[:] = values
            self.vals[slots] = arr
        else:
            self.vals[slots] = values
        self.has[slots] = True


def _isin_mask(vals: np.ndarray, kind: str, expected, n: int) -> np.ndarray:
    """``value in expected`` per row, matching the reference's Python
    ``in`` semantics (wdbx/core/vector_store.py:414-463). ``np.isin``
    with a heterogeneous list is WRONG, not just slow: ``np.asarray``
    promotes e.g. ``['a', 1]`` to a unicode array, so a typed int column
    never compares equal and matches are silently dropped. Fast-path
    only when the promoted dtype preserves equality; otherwise OR
    per-element vectorized equality (also the safe path for object
    columns, where np.isin's sort-based kernel can raise)."""
    exp = list(expected)
    if not exp:
        return np.zeros(n, bool)
    if kind != "obj":
        arr = np.asarray(exp)
        if arr.dtype.kind in "biuf" or (
            arr.dtype.kind == "U"
            and all(isinstance(e, str) for e in exp)
        ):
            try:
                return np.isin(vals, arr)
            except (TypeError, ValueError):
                return np.zeros(n, bool)
    m = np.zeros(n, bool)
    for e in exp:
        try:
            em = vals == e
        except (TypeError, ValueError):
            continue
        if isinstance(em, np.ndarray):  # scalar False = incomparable
            m |= em.astype(bool)
    return m


def _col_clause(col: _Column, cond: Any, n: int) -> np.ndarray:
    """Evaluate one filter clause against a column; returns (n,) bool.
    Missing values fail every operator except ``$exists: False`` and
    ``$nin`` (a row missing the key PASSES ``$nin`` — reference
    wdbx/core/vector_store.py:450-452)."""
    vals = col.vals[:n]
    has = col.has[:n]
    if isinstance(cond, dict) and any(k.startswith("$") for k in cond):
        out = np.ones(n, bool)
        for op, expected in cond.items():
            if op == "$exists":
                out &= has if expected else ~has
                continue
            if op == "$in":
                m = _isin_mask(vals, col.kind, expected, n)
            elif op == "$nin":
                out &= ~has | ~_isin_mask(vals, col.kind, expected, n)
                continue
            elif op in ("$gt", "$gte", "$lt", "$lte"):
                import operator as _op

                fn = {"$gt": _op.gt, "$gte": _op.ge,
                      "$lt": _op.lt, "$lte": _op.le}[op]
                if col.kind == "obj":
                    def safe(a, e=expected, f=fn):
                        try:
                            return bool(f(a, e))
                        except TypeError:
                            return False
                    m = np.frompyfunc(safe, 1, 1)(vals).astype(bool)
                else:
                    try:
                        m = fn(vals, expected)
                    except (TypeError, ValueError):
                        m = np.zeros(n, bool)
                    if not isinstance(m, np.ndarray):
                        m = np.zeros(n, bool)
            else:
                raise ValueError(f"unsupported filter operator: {op}")
            out &= m & has
        return out
    # plain equality
    try:
        m = vals == cond
    except (TypeError, ValueError):
        return np.zeros(n, bool)
    if not isinstance(m, np.ndarray):  # incomparable scalar broadcast
        return np.zeros(n, bool)
    return m.astype(bool) & has


class _ShardMeta:
    __slots__ = ("cap", "present", "cols", "n")

    def __init__(self):
        self.cap = 0
        self.present = np.zeros(0, bool)
        self.cols: dict[str, _Column] = {}
        self.n = 0

    def _ensure(self, need: int) -> None:
        if self.cap >= need:
            return
        cap = max(need, _GROW_MIN, int(self.cap * 2))
        present = np.zeros(cap, bool)
        present[: self.cap] = self.present
        self.present = present
        for col in self.cols.values():
            col._grow(cap)
        self.cap = cap

    def set(self, slot: int, meta: dict[str, Any]) -> None:
        self._ensure(slot + 1)
        if self.present[slot]:
            for col in self.cols.values():
                col.has[slot] = False
        else:
            self.n += 1
        self.present[slot] = True
        for key, value in meta.items():
            col = self.cols.get(key)
            if col is None:
                col = _Column(_kind_of(value), self.cap)
                self.cols[key] = col
            col.set_one(slot, value)

    def set_columns(
        self, slots: np.ndarray, columns: dict[str, list]
    ) -> None:
        """Bulk path: every slot gets the same key set, values given as
        per-key lists/arrays (vectorized; the 10M-ingest path)."""
        slots = np.asarray(slots, np.int64)
        if len(slots) == 0:
            return
        self._ensure(int(slots.max()) + 1)
        newly = ~self.present[slots]
        if not newly.all():
            reset = slots[~newly]
            for col in self.cols.values():
                col.has[reset] = False
        self.n += int(newly.sum())
        self.present[slots] = True
        for key, values in columns.items():
            col = self.cols.get(key)
            if col is None:
                if (
                    isinstance(values, np.ndarray)
                    and values.dtype.kind in _Column._NP_KINDS
                ):
                    kind = _Column._NP_KINDS[values.dtype.kind]
                else:
                    values = list(values)
                    kind = _kind_of(values[0]) if values else "obj"
                col = _Column(kind, self.cap)
                self.cols[key] = col
            col.set_many(slots, values)

    def get(self, slot: int) -> dict[str, Any] | None:
        # Called lock-free from the search merge (epoch-validated by the
        # caller), racing writers that insert columns and grow/swap the
        # backing arrays. Snapshot every reference locally and bounds-
        # check against the snapshots so this is crash-free; CONTENT
        # consistency is the caller's epoch retry's job. list(items())
        # materializes atomically under the GIL — iterating the live
        # dict would raise "dictionary changed size during iteration".
        present = self.present
        if slot < 0 or slot >= len(present) or not present[slot]:
            return None
        out: dict[str, Any] = {}
        for key, col in list(self.cols.items()):
            vals, has, kind = col.vals, col.has, col.kind
            if slot < len(has) and slot < len(vals) and has[slot]:
                try:
                    out[key] = _to_py(vals[slot], kind)
                except (TypeError, ValueError):
                    # kind/vals torn mid-promotion; raw value is the
                    # closest consistent read
                    out[key] = vals[slot]
        return out

    def get_many(self, slots: np.ndarray) -> list[dict[str, Any] | None]:
        """Vectorized row gather: one fancy-index per column instead of
        per-slot scalar reads — the serving merge attaches metadata to
        every hit, and the per-hit ``get()`` walk was the next Python
        wall once dispatch pipelining landed (VERDICT r4 ask #4).

        Same lock-free contract as ``get()``: snapshot every array
        reference, bounds-check against the snapshots, epoch-validated
        by the caller."""
        slots = np.asarray(slots, np.int64)
        n = len(slots)
        present = self.present
        inb = (slots >= 0) & (slots < len(present))
        ok = np.zeros(n, bool)
        ok[inb] = present[slots[inb]]
        out: list[dict[str, Any] | None] = [
            ({} if good else None) for good in ok
        ]
        idx = np.nonzero(ok)[0]
        if len(idx) == 0:
            return out
        sl = slots[idx]
        for key, col in list(self.cols.items()):
            vals, has, kind = col.vals, col.has, col.kind
            valid = (sl < len(has)) & (sl < len(vals))
            which = idx[valid]
            wsl = sl[valid]
            hmask = has[wsl]
            rows = vals[wsl[hmask]]
            for oi, value in zip(which[hmask], rows):
                try:
                    out[oi][key] = _to_py(value, kind)
                except (TypeError, ValueError):
                    out[oi][key] = value
        return out

    def drop(self, slot: int) -> None:
        if 0 <= slot < self.cap and self.present[slot]:
            self.present[slot] = False
            self.n -= 1
            for col in self.cols.values():
                col.has[slot] = False

    def drop_many(self, slots: np.ndarray) -> None:
        slots = np.asarray(slots, np.int64)
        slots = slots[(slots >= 0) & (slots < self.cap)]
        if len(slots) == 0:
            return
        was = self.present[slots]
        self.n -= int(was.sum())
        self.present[slots] = False
        for col in self.cols.values():
            col.has[slots] = False

    def mask(self, flt: dict[str, Any], capacity: int) -> np.ndarray:
        """Per-slot filter mask over ``capacity`` index slots.

        A slot with no metadata record behaves as ``{}`` — the reference
        evaluates filters against ``metadata.get(id, {})``, so e.g.
        ``{"k": {"$exists": False}}`` MATCHES a row stored without
        metadata (reference wdbx/core/vector_store.py:414-463). Slots
        this shard's columns never reached (beyond ``self.cap``, or
        dropped) get that empty-row verdict too; liveness is not this
        layer's job — every index ANDs the mask into its own validity.
        """
        from wdbx_tpu_torch.store.filters import matches_filter

        empty_ok = matches_filter({}, flt)
        n = min(self.cap, capacity)
        out = np.full(capacity, empty_ok, dtype=bool)
        if n == 0:
            return out
        m = np.ones(n, bool)
        for key, cond in flt.items():
            col = self.cols.get(key)
            if col is None:
                # key never seen in this shard: every row gets the
                # missing-value verdict for this clause
                if not matches_filter({}, {key: cond}):
                    return np.zeros(capacity, bool)
                continue
            m &= _col_clause(col, cond, n)
        out[:n] = m
        return out

    def remap(self, old: np.ndarray, new: np.ndarray) -> None:
        old = np.asarray(old, np.int64)
        new = np.asarray(new, np.int64)
        keep = old < self.cap
        old, new = old[keep], new[keep]
        if len(new):
            self._ensure(int(new.max()) + 1)
        present = np.zeros(self.cap, bool)
        present[new] = self.present[old]
        self.present = present
        self.n = int(present.sum())
        for col in self.cols.values():
            vals = _empty_vals(col.kind, self.cap, width=col._width())
            vals[new] = col.vals[old]
            col.vals = vals
            has = np.zeros(self.cap, bool)
            has[new] = col.has[old]
            col.has = has


class ColumnarMetadata:
    """Store-level facade over per-shard column sets."""

    def __init__(self, num_shards: int):
        self.shards = [_ShardMeta() for _ in range(num_shards)]

    def set(self, shard: int, slot: int, meta: dict[str, Any]) -> None:
        self.shards[shard].set(int(slot), dict(meta or {}))

    def set_columns(self, shard, slots, columns) -> None:
        self.shards[shard].set_columns(slots, columns)

    def get(self, shard: int, slot: int) -> dict[str, Any] | None:
        return self.shards[shard].get(int(slot))

    def get_many(self, shard: int, slots) -> list[dict[str, Any] | None]:
        return self.shards[shard].get_many(slots)

    def drop(self, shard: int, slot: int) -> None:
        self.shards[shard].drop(int(slot))

    def remap(self, shard: int, old, new) -> None:
        self.shards[shard].remap(old, new)

    def mask(self, shard: int, flt: dict, capacity: int) -> np.ndarray:
        return self.shards[shard].mask(flt, capacity)

    def count(self) -> int:
        return sum(s.n for s in self.shards)

    def __len__(self) -> int:
        return self.count()

    def clear(self) -> None:
        for i in range(len(self.shards)):
            self.shards[i] = _ShardMeta()

    # -- persistence --------------------------------------------------------
    # metadata/columns_shard{N}.npz: present + typed columns;
    # metadata/columns_shard{N}.json: manifest + object columns as
    # (slot, value) pairs. No single-blob JSON of the whole store.
    def save(self, meta_dir: str) -> None:
        os.makedirs(meta_dir, exist_ok=True)
        for i, sh in enumerate(self.shards):
            hwm = (
                int(np.nonzero(sh.present)[0][-1]) + 1
                if sh.n else 0
            )
            arrays: dict[str, np.ndarray] = {
                "present": sh.present[:hwm]
            }
            manifest: list[dict] = []
            objcols: dict[str, list] = {}
            for ci, (key, col) in enumerate(sh.cols.items()):
                manifest.append({"key": key, "kind": col.kind, "i": ci})
                if col.kind == "obj":
                    idx = np.nonzero(col.has[:hwm])[0]
                    objcols[str(ci)] = [
                        [int(s), col.vals[s]] for s in idx
                    ]
                else:
                    arrays[f"c{ci}v"] = col.vals[:hwm]
                    arrays[f"c{ci}h"] = col.has[:hwm]
            np.savez(
                os.path.join(meta_dir, f"columns_shard{i}.npz"), **arrays
            )
            with open(
                os.path.join(meta_dir, f"columns_shard{i}.json"), "w"
            ) as f:
                json.dump({"columns": manifest, "obj": objcols, "n": sh.n},
                          f, default=_json_default)

    def load(self, meta_dir: str) -> bool:
        found = False
        for i in range(len(self.shards)):
            npz_path = os.path.join(meta_dir, f"columns_shard{i}.npz")
            man_path = os.path.join(meta_dir, f"columns_shard{i}.json")
            if not (os.path.exists(npz_path) and os.path.exists(man_path)):
                continue
            found = True
            with open(man_path) as f:
                man = json.load(f)
            data = np.load(npz_path)
            sh = _ShardMeta()
            present = np.asarray(data["present"], bool)
            sh._ensure(max(len(present), 1))
            sh.present[: len(present)] = present
            sh.n = int(man.get("n", present.sum()))
            for entry in man["columns"]:
                key, kind, ci = entry["key"], entry["kind"], entry["i"]
                col = _Column(kind, sh.cap)
                if kind == "obj":
                    for slot, value in man["obj"].get(str(ci), []):
                        col.vals[int(slot)] = value
                        col.has[int(slot)] = True
                else:
                    vals = data[f"c{ci}v"]
                    has = np.asarray(data[f"c{ci}h"], bool)
                    if kind == "str":
                        col.vals = col.vals.astype(vals.dtype)
                    col.vals[: len(vals)] = vals
                    col.has[: len(has)] = has
                sh.cols[key] = col
            self.shards[i] = sh
        return found

    def load_legacy(
        self, path: str, resolve: Any
    ) -> bool:
        """Ingest a reference-format one-blob ``metadata.json``;
        ``resolve(vector_id) -> (shard, slot) | None`` supplies the
        placement (the registries, already loaded)."""
        if not os.path.exists(path):
            return False
        with open(path) as f:
            blob = json.load(f)
        for vid, meta in blob.items():
            loc = resolve(vid)
            if loc is not None:
                self.set(loc[0], loc[1], meta)
        return True

    def iter_present(self, shard: int) -> Iterable[int]:
        sh = self.shards[shard]
        return np.nonzero(sh.present)[0]
