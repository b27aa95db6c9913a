"""The comparison that decides ``correct``.

The answers of a share of the window's calls (the traffic's
``check_share``, the calls drawn from the seed), as their callers
received them, are held against the plain reference
(``reference/exact.py``) over the same corpus and query. The numbers
compared, each with a limit from the configuration's file:

* ``unanswered``: queries that got no answer, or an error (limit 0);
* ``malformed``: answers without exactly k hits, with an id that is not
  a row of the corpus, with an id twice, or with scores out of order
  (limit 0);
* ``rank_gap_mean``: over every hit of the checked answers, the mean
  amount by which the hit's exact float32 score at rank r lies below
  the reference's exact r-th best score (0 for an exact search in
  float32).

Reported beside them, not compared (no control separates them from the
program's own readings, ``PERF.md``): ``score_err``, the widest gap of a
reported score from the exact cosine, and ``rank_gap``, the widest of
the amounts above. ``recall`` (the share of the reference's top-k ids
among the answer's ids) is the ``recall_at_10`` metric.
"""

from __future__ import annotations

import numpy as np


class Answers:
    """Answers in arrays: ``q`` (A,) pool index, ``ids`` (A, k) rows,
    ``scores`` (A, k) reported, ``ok`` (A,) well formed. Each answer
    comes as ``(ids, scores)`` (``loops.compact``)."""

    def __init__(self, qidx, answers, k: int, n_rows: int):
        a = len(answers)
        self.q = np.asarray(qidx, np.int64)
        self.ids = np.full((a, k), -1, np.int64)
        self.scores = np.full((a, k), np.nan, np.float64)
        self.ok = np.zeros(a, bool)
        for j, (ids, scores) in enumerate(answers):
            if len(ids) != k:
                continue
            try:
                self.ids[j] = [int(i) for i in ids]
            except (TypeError, ValueError):
                continue
            self.scores[j] = scores
        ids = self.ids
        in_range = ((ids >= 0) & (ids < n_rows)).all(axis=1)
        srt = np.sort(ids, axis=1)
        unique = (srt[:, 1:] != srt[:, :-1]).all(axis=1)
        ordered = (np.diff(self.scores, axis=1) <= 0).all(axis=1)
        self.ok = in_range & unique & ordered & np.isfinite(
            self.scores).all(axis=1)

    def pairs(self) -> tuple[np.ndarray, np.ndarray]:
        """Distinct ``(query, row)`` pairs of the well-formed answers."""
        q = np.repeat(self.q[self.ok], self.ids.shape[1])
        r = self.ids[self.ok].reshape(-1)
        key = np.unique(q * (1 << 34) + r)
        return key >> 34, key & ((1 << 34) - 1)


def exact_of(answers: Answers, pq, prow, pair_score) -> np.ndarray:
    """(A', k) exact scores of the well-formed answers' hits."""
    key = pq * (1 << 34) + prow
    q = np.repeat(answers.q[answers.ok], answers.ids.shape[1])
    want = q * (1 << 34) + answers.ids[answers.ok].reshape(-1)
    return pair_score[np.searchsorted(key, want)].reshape(-1, answers.ids.shape[1])


def numbers(q, ids, scores, exact, top_v, top_i) -> dict:
    """``rank_gap_mean``, ``score_err``, ``rank_gap`` and ``recall`` of
    well-formed answers (``q`` pool index, ``ids`` / ``scores`` /
    ``exact`` (A, k))."""
    if len(q) == 0:
        return {"rank_gap_mean": 0.0, "score_err": 0.0, "rank_gap": 0.0,
                "recall": float("nan")}
    ref_v = top_v[q].astype(np.float64)
    ref_i = top_i[q]
    gap = np.maximum(0.0, ref_v - exact)
    hit = (ids[:, :, None] == ref_i[:, None, :]).any(axis=2)
    return {
        "rank_gap_mean": float(gap.mean()),
        "score_err": float(np.max(np.abs(scores - exact))),
        "rank_gap": float(gap.max()),
        "recall": float(hit.sum() / hit.size),
    }


def compare(answers: Answers, attempted: int, answered: int, ref: dict,
            pq, prow, limits: dict) -> dict:
    """The checks of one run: ``{"correct", "recall", "checks",
    "readings"}`` where ``checks`` maps each compared number to
    ``{"value", "limit"}`` and ``readings`` holds every number read."""
    exact = exact_of(answers, pq, prow, ref["pair_score"])
    got = numbers(answers.q[answers.ok], answers.ids[answers.ok],
                  answers.scores[answers.ok], exact, ref["top_v"],
                  ref["top_i"])
    values = {
        "unanswered": attempted - answered,
        "malformed": int((~answers.ok).sum()),
        "rank_gap_mean": got["rank_gap_mean"],
    }
    checks = {n: {"value": values[n], "limit": limits[n]} for n in values}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return {"correct": bool(correct), "recall": got["recall"],
            "checks": checks, "readings": {**values, **got}}
