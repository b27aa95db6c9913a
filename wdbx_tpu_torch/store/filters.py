"""Mongo-style metadata filters.

Operator semantics match the reference's ``_matches_filter`` (reference
wdbx/core/vector_store.py:414-463): ``$gt $lt $gte $lte $in $nin
$exists`` plus plain equality. Missing-key verdicts per the reference's
code: ``$gt/$gte/$lt/$lte/$in`` and equality FAIL on a missing key;
``$nin`` PASSES on a missing key (reference :450-452 — ``if key in
metadata and metadata[key] in op_value: return False``); ``$exists``
matches iff presence equals the operand's truthiness.

Documented divergences from the reference (deliberate, not bugs):
  * mixed-type ordered comparison (``{"k": {"$gt": 0}}`` vs ``k="a"``)
    fails the clause here; the reference raises TypeError up through
    ``search()`` (reference :439 — uncaught).
  * an unknown ``$op`` raises ``ValueError`` here; the reference's
    if/elif chain silently treats it as always-true.
  * a dict value counts as an operator clause when ANY key starts with
    ``$``; the reference inspects only the first key (dict order).

Two execution modes (SURVEY.md §7 'metadata filtering at device speed'):
  * post-filter — apply to already-ranked results (reference semantics);
  * pre-filter  — compile the predicate to a per-slot boolean mask that
    the index ANDs into its validity mask on device, so filtered queries
    still return a full ``limit`` even under selective predicates.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import numpy as np

_MISSING = object()


def _cmp(op: str, actual: Any, expected: Any) -> bool:
    try:
        if op == "$gt":
            return actual > expected
        if op == "$gte":
            return actual >= expected
        if op == "$lt":
            return actual < expected
        if op == "$lte":
            return actual <= expected
    except TypeError:
        return False
    if op == "$in":
        return actual in expected
    if op == "$nin":
        return actual not in expected
    raise ValueError(f"unsupported filter operator: {op}")


def matches_filter(metadata: dict[str, Any], flt: dict[str, Any] | None) -> bool:
    """True iff ``metadata`` satisfies every clause of ``flt``."""
    if not flt:
        return True
    for key, cond in flt.items():
        actual = metadata.get(key, _MISSING)
        if isinstance(cond, dict) and any(k.startswith("$") for k in cond):
            for op, expected in cond.items():
                if op == "$exists":
                    if (actual is not _MISSING) != bool(expected):
                        return False
                elif op == "$nin":
                    # missing key PASSES $nin (reference
                    # wdbx/core/vector_store.py:450-452)
                    if actual is not _MISSING and not _cmp(
                        op, actual, expected
                    ):
                        return False
                elif actual is _MISSING or not _cmp(op, actual, expected):
                    return False
        else:
            if actual is _MISSING or actual != cond:
                return False
    return True


def compile_filter(flt: dict[str, Any] | None) -> Callable[[dict], bool]:
    """Pre-bind the filter for hot loops."""
    if not flt:
        return lambda _m: True
    return lambda m: matches_filter(m, flt)


def build_slot_mask(
    capacity: int,
    slot_ids: Iterable[tuple[int, str]],
    metadata: dict[str, dict[str, Any]],
    flt: dict[str, Any] | None,
) -> np.ndarray:
    """Compile ``flt`` into a per-slot boolean mask for device pre-filtering.

    ``slot_ids`` yields ``(slot, vector_id)`` pairs for one shard; slots
    not listed stay False (they are invalid anyway).
    """
    pred = compile_filter(flt)
    mask = np.zeros(capacity, dtype=bool)
    for slot, vid in slot_ids:
        meta = metadata.get(vid)
        if meta is not None and pred(meta):
            mask[slot] = True
    return mask
