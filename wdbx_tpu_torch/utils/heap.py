"""Settling the interpreter's heap at a store's set-up edges.

CPython's oldest-generation collection walks every tracked object that
is alive, and a process that has imported torch holds ~170k of them
that never die (the modules' functions, classes and dicts). A full
collection runs once the objects promoted since the last one exceed a
quarter of that count, so a long-lived process that serves searches
from several threads stops them all, about once a second, for a walk
of its own import heap.

``settle`` runs one full collection, so that no garbage is kept, and
then ``gc.freeze()``: everything alive moves to the permanent
generation, which later collections do not walk. The collector is the
process's, so a settle acts on the whole heap, not only the store's:
every object alive in the process at that moment is frozen. It changes
no answer and no object's life, with one exception: cyclic garbage made
of objects that were alive at a settle is never reclaimed (objects
freed by their reference count are unaffected; the facade holds no
cycle, so a dropped store is one of them). ``gc.unfreeze()`` hands the
frozen objects back to the collector. A process that has turned the
collector off (``gc.disable()``) owns its collection policy, and
``settle`` leaves it alone.

The store settles at its set-up edges only, never on the search path
or in per-row writes: after the first settle a later one walks only
what was allocated since. An application that builds long-lived state
of its own after its stores (a server's request handling, late
imports) may call ``settle`` once it is up.
"""

from __future__ import annotations

import gc

from wdbx_tpu_torch.utils.metrics import span


def settle(edge: str) -> None:
    """Collect the whole heap, then freeze what is alive; nothing while
    the collector is off. ``edge`` names the set-up edge; the
    ``heap.settle`` span also carries ``collected`` (the objects the
    collection freed) and ``frozen`` (those this settle moved to the
    permanent generation)."""
    if not gc.isenabled():
        return
    with span("heap.settle", edge=edge) as sp:
        before = gc.get_freeze_count()
        collected = gc.collect()
        gc.freeze()
        frozen = gc.get_freeze_count() - before
        sp.set(collected=collected, frozen=frozen)
