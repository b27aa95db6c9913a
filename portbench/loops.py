"""The load: one general generator for every traffic mix.

A traffic file names its ``loop``. The one this harness drives is
``closed``: ``callers`` threads, each calling a blocking entry with
``batch`` queries back to back until the window ends; the window then
lasts until the last call returns.

The queries come from a pool made from the seed; which pool row each
call takes is drawn from the seed too, so every seed brings the same
amount of work in another order.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from portbench.reference.mixture import sub_seed

#: streams of ``sub_seed`` for the load
PICKS, KEEP = 12, 14


def compact(hits) -> tuple:
    """An answer as the caller received it, kept as ``(ids, scores)``
    tuples of strings and floats: the hit lists and their metadata
    dicts are freed at once, so answers kept for the check do not grow
    the heap the interpreter's collector walks during the window."""
    try:
        return (tuple(h[0] for h in hits), tuple(float(h[1]) for h in hits))
    except (TypeError, ValueError, IndexError):
        return ((None,), (float("nan"),))


@dataclass
class LoadResult:
    #: host ``perf_counter`` at the window's start, and its length
    t0: float = 0.0
    window_s: float = 0.0
    #: queries sent, and queries answered without an error
    attempted: int = 0
    answered: int = 0
    #: the answers kept for the check: pool row and ``compact`` answer
    qidx: list = field(default_factory=list)
    answers: list = field(default_factory=list)
    #: (start, end) of each call
    calls: list = field(default_factory=list)


def batches(traffic: dict, seed: int, pool: int) -> list[np.ndarray]:
    """The pool's rows in a seeded order, cut into calls of ``batch``."""
    order = np.random.default_rng(sub_seed(seed, PICKS)).permutation(pool)
    b = traffic["batch"]
    return [order[i:i + b] for i in range(0, pool - b + 1, b)]


def closed_loop(call, queries: np.ndarray, plan: list[np.ndarray],
                traffic: dict, seconds: float, seed: int, on_start=None,
                on_end=None) -> LoadResult:
    """``callers`` threads call ``call(q, limit=k)`` back to back; each
    first makes ``warmup_calls`` calls that are not measured. The answers
    of a share ``check_share`` of the calls, drawn from the seed, are kept
    for the check; the others are counted and dropped."""
    n_callers, k = traffic["callers"], traffic["k"]
    share = traffic.get("check_share", 1.0)
    res = LoadResult()
    ready = threading.Barrier(n_callers + 1)
    go = threading.Barrier(n_callers + 1)
    stop = [0.0]
    mu = threading.Lock()

    failed: list[BaseException] = []

    def caller(j: int) -> None:
        pos = j * len(plan) // n_callers
        keep = np.random.default_rng(sub_seed(seed, KEEP, j))
        try:
            for w in range(traffic.get("warmup_calls", 1)):
                idx = plan[(pos + w) % len(plan)]
                call(queries[idx], limit=k)
        except BaseException as e:  # handed to the main thread
            failed.append(e)
            ready.abort()
            return
        ready.wait()
        go.wait()
        while time.perf_counter() < stop[0]:
            idx = plan[pos % len(plan)]
            pos += 1
            t1 = time.perf_counter()
            try:
                hits = call(queries[idx], limit=k)
            except Exception:
                hits = None
            t2 = time.perf_counter()
            kept = None
            if hits is not None and keep.random() < share:
                kept = [compact(h) for h in hits]
            with mu:
                res.calls.append((t1, t2))
                res.attempted += len(idx)
                if hits is None:
                    continue
                res.answered += min(len(hits), len(idx))
                if kept is not None:
                    res.qidx.extend(int(i) for i in idx[:len(kept)])
                    res.answers.extend(kept)

    threads = [threading.Thread(target=caller, args=(j,), daemon=True)
               for j in range(n_callers)]
    for t in threads:
        t.start()
    try:
        ready.wait()
    except threading.BrokenBarrierError:
        for t in threads:
            t.join()
        raise failed[0] if failed else RuntimeError("a caller failed")
    if on_start is not None:
        on_start()
    res.t0 = time.perf_counter()
    stop[0] = res.t0 + seconds
    go.wait()
    for t in threads:
        t.join()
    end = max((c[1] for c in res.calls), default=res.t0)
    res.window_s = end - res.t0
    if on_end is not None:
        on_end()
    return res
