"""The program's own spans in a traced run, for the readers that read them.

Importing this module starts the program's tracer (``TRACER`` in
``wdbx_tpu_torch/utils/metrics.py``). Only readers import it, and the
harness loads readers only for a traced run, so an untraced run never
starts it. ``spans(ctx)`` drains the tracer once per run and keeps the
spans that overlap the run's window (``ctx.load.t0`` to ``t0 +
window_s``), so a second traced run in one process reads its own. Where
the program has no tracer, every reader gets None and reports nothing.

Times are ``perf_counter_ns``: the host clock ``devtrace.py`` maps the
device's timeline onto, so ``ctx.trace.gaps()`` compare directly.
"""

from __future__ import annotations

import bisect

try:
    from wdbx_tpu_torch.utils.metrics import TRACER
except ImportError:  # a program without the tracer
    TRACER = None
else:
    TRACER.start()

#: the idle device's label by the most advanced state of any thread
#: then, first matching first
STATES = ("gc", "index before launch", "index after result", "merge", "prep",
          "store, between spans", "outside the program")
_RANK = {"gc.collect": 0, "store.merge": 3, "store.prep": 4,
         "store.search_batch": 5}
_run: dict = {}


def spans(ctx) -> list | None:
    """The program's spans overlapping ``ctx``'s window, or None."""
    load = ctx.load
    if TRACER is None or load is None or load.window_s <= 0:
        return None
    if _run.get("load") is not load:
        w0 = round(load.t0 * 1e9)
        w1 = w0 + round(load.window_s * 1e9)
        _run.update(load=load, window=(w0, w1), trace=ctx.trace,
                    spans=[s for s in TRACER.drain()
                           if s.t1 > w0 and s.t0 < w1])
    return _run["spans"]


def window(ctx) -> tuple[int, int]:
    """``ctx``'s window in ns (after ``spans(ctx)`` gave spans)."""
    spans(ctx)
    return _run["window"]


def named(ctx, name: str) -> list:
    """``name``'s spans that lie wholly inside the window."""
    got = spans(ctx)
    if got is None:
        return []
    w0, w1 = window(ctx)
    return [s for s in got if s.name == name and s.t0 >= w0 and s.t1 <= w1]


def union_ns(intervals, w0: int, w1: int) -> int:
    """Nanoseconds of the union of ``intervals``, clipped to the window."""
    total, end = 0, w0
    for a, b in sorted((max(a, w0), min(b, w1)) for a, b in intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps_ns(trace, w0: int, w1: int) -> list[tuple[int, int]]:
    """The device's idle intervals, in ns, clipped to the window."""
    out = []
    for a, b in trace.gaps():
        a, b = max(round(a * 1e9), w0), min(round(b * 1e9), w1)
        if b > a:
            out.append((a, b))
    return out


def _intervals(got) -> list[tuple[int, int, int]]:
    """``(start, end, rank)`` of every state a span puts its thread in;
    an ``index.search`` is before its first ``kernel.k1`` launch on its
    thread, then after it."""
    k1 = {}
    for s in got:
        if s.name == "kernel.k1":
            k1.setdefault(s.tid, []).append(s.t0)
    for starts in k1.values():
        starts.sort()
    out = []
    for s in got:
        if s.name == "index.search":
            starts = k1.get(s.tid, [])
            i = bisect.bisect_left(starts, s.t0)
            launch = starts[i] if i < len(starts) and starts[i] <= s.t1 \
                else s.t1
            out.append((s.t0, launch, 1))
            if launch < s.t1:
                out.append((launch, s.t1, 2))
        elif s.name in _RANK:
            out.append((s.t0, s.t1, _RANK[s.name]))
    return out


def idle_by_state(got, gaps) -> tuple[dict[str, int], int]:
    """Idle ns by ``STATES``, and the idle ns in which some thread is
    inside ``index.search``. ``gaps`` are sorted, disjoint, in ns."""
    events = sorted(ev for a, b, r in _intervals(got)
                    for ev in ((a, 1, r), (b, -1, r)))
    counts = [0] * len(STATES)
    by = [0] * len(STATES)
    in_index, j = 0, 0

    def apply_upto(t):
        nonlocal j
        while j < len(events) and events[j][0] <= t:
            counts[events[j][2]] += events[j][1]
            j += 1

    for a, b in gaps:
        apply_upto(a)
        t = a
        while t < b:
            nxt = min(events[j][0], b) if j < len(events) else b
            rank = next((r for r, c in enumerate(counts) if c > 0),
                        len(STATES) - 1)
            by[rank] += nxt - t
            if counts[1] or counts[2]:
                in_index += nxt - t
            t = nxt
            apply_upto(t)
    return dict(zip(STATES, by)), in_index


def clock_check(got, trace, w0: int, w1: int) -> tuple[int, int, list]:
    """``kernel.k1`` spans starting in the window, stage-1 kernels in the
    device trace, and by how much each device kernel started before the
    launch of the same rank began, in launch order (ns; <= 0 where the
    clocks agree)."""
    import re

    from portbench.harness import reader

    stage1 = re.compile(reader("k1.roofline_share").STAGE1)
    launches = sorted(s.t0 for s in got
                      if s.name == "kernel.k1" and w0 <= s.t0 <= w1)
    kernels = sorted(round(a * 1e9) for n, a, _ in trace.ops
                     if stage1.search(n))
    return len(launches), len(kernels), [h - d for h, d in
                                         zip(launches, kernels)]
