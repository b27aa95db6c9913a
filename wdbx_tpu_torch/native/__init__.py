"""Native host-side bookkeeping with a pure-Python fallback.

``SlotRegistry`` is the id <-> slot map the store keeps per shard. The
C++ extension (slot_registry.cpp; ``make -C wdbx_tpu_torch/native``) removes
per-id Python object churn from the ingest path; if it is not built,
``PySlotRegistry`` provides identical semantics.

``build()`` compiles the extension in-tree with g++ (no pip involved).
"""

from __future__ import annotations

import logging
import os
import subprocess

logger = logging.getLogger("wdbx_tpu_torch.native")

_HERE = os.path.dirname(__file__)


class PySlotRegistry:
    """Pure-Python mirror of the native SlotRegistry API."""

    def __init__(self):
        self._id_to_slot: dict[str, int] = {}
        self._slot_to_id: dict[int, str] = {}
        self._free: list[int] = []
        self._next = 0

    def assign(self, ids):
        slots, fresh = [], []
        for vid in ids:
            existing = self._id_to_slot.get(vid)
            if existing is not None:
                slots.append(existing)
                fresh.append(False)
                continue
            slot = self._free.pop() if self._free else self._next
            if slot == self._next:
                self._next += 1
            self._id_to_slot[vid] = slot
            self._slot_to_id[slot] = vid
            slots.append(slot)
            fresh.append(True)
        return slots, fresh

    def put(self, ids, slots):
        for vid, slot in zip(ids, slots):
            slot = int(slot)
            if slot < 0:
                raise ValueError("slot ids must be >= 0")
            if not vid:
                raise ValueError("vector ids must be non-empty")
            self._id_to_slot[vid] = slot
            self._slot_to_id[slot] = vid
            if slot >= self._next:
                self._next = slot + 1

    def lookup(self, vid):
        return self._id_to_slot.get(vid)

    def id_of(self, slot):
        return self._slot_to_id.get(slot)

    def remove(self, vid):
        slot = self._id_to_slot.pop(vid, None)
        if slot is None:
            return None
        self._slot_to_id.pop(slot, None)
        self._free.append(slot)
        return slot

    def size(self):
        return len(self._id_to_slot)

    def contains(self, vid):
        return vid in self._id_to_slot

    def items(self):
        return list(self._id_to_slot.items())

    def load(self, items, next_slot, free):
        self._id_to_slot = {vid: int(slot) for vid, slot in items}
        self._slot_to_id = {int(slot): vid for vid, slot in items}
        self._next = int(next_slot)
        self._free = [int(s) for s in free]

    def state(self):
        return self._next, list(self._free)

    def id_table(self):
        """slot -> id list (None for unused), length next_slot."""
        out = [None] * self._next
        for slot, vid in self._slot_to_id.items():
            if 0 <= slot < self._next:
                out[slot] = vid
        return out


def build(force: bool = False) -> bool:
    """Compile the C++ extension in-tree. Returns True on success."""
    try:
        result = subprocess.run(
            ["make", "-C", _HERE] + (["-B"] if force else []),
            capture_output=True, text=True, timeout=120,
        )
        if result.returncode != 0:
            logger.warning("native build failed:\n%s", result.stderr)
            return False
        return True
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.warning("native build failed: %s", e)
        return False


def _load_native():
    try:
        from wdbx_tpu_torch.native import _native  # type: ignore

        return _native
    except ImportError:
        return None


_native_mod = _load_native()

# Opt-in self-bootstrap: compiling on import surprises read-only installs
# and adds up to 120s of import latency, so it only happens when
# WDBX_NATIVE_BUILD=1 is set. The supported paths are an explicit
# ``build()`` call or a build at install/image time (the Dockerfile and
# Makefile both do this); otherwise the pure-Python registry is used.
if _native_mod is None and os.environ.get("WDBX_NATIVE_BUILD") == "1":
    if build():
        _native_mod = _load_native()

if _native_mod is not None:
    SlotRegistry = _native_mod.SlotRegistry
    HAVE_NATIVE = True
else:
    SlotRegistry = PySlotRegistry
    HAVE_NATIVE = False


def use_native(force_build: bool = False) -> bool:
    """Explicitly build (if needed) and switch to the native registry.

    Returns True when the native extension is active. New registries
    created after this call use the native class; existing instances
    are unaffected.
    """
    global _native_mod, SlotRegistry, HAVE_NATIVE
    if _native_mod is None or force_build:
        if build(force=force_build):
            _native_mod = _load_native()
    if _native_mod is not None:
        SlotRegistry = _native_mod.SlotRegistry
        HAVE_NATIVE = True
    return HAVE_NATIVE
