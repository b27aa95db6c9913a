"""Latency metrics, the search path's tracer and profiling hooks.

The reference has no timers or profiler integration at all (SURVEY.md
§5.1 — its only artifact is a percentage ProgressLogger). Here every
store operation feeds a reservoir of latencies exposed through
``get_stats`` (p50/p95/p99), and ``trace`` wraps ``torch.profiler`` so a
hot path (host and CUDA activity) can be captured as a Chrome trace
with one context manager.

``TRACER`` records spans where the work happens (``span``) while an
operator has started it, and is off otherwise: an operator's tool for
asking where one process's search time goes. Off, a span site costs
one flag check; started, each span keeps its thread, its start and end
on ``time.perf_counter_ns`` (the clock ``torch.profiler``'s device
timeline can be tied to), the thread's CPU time over it
(``time.thread_time_ns``), the span open around it, the id of the
outermost span of its call and a few small attributes; the
interpreter's collections become ``gc.collect`` spans. Spans stay in a
bounded buffer in memory until ``TRACER.drain()``::

    from wdbx_tpu_torch.utils.metrics import TRACER
    TRACER.start()
    db.vector_search_batch(queries)
    spans = TRACER.drain()   # list of Span, oldest first
    TRACER.stop()

A ``LatencyRecorder.timed`` site is a span too: it feeds the reservoir
whether or not the tracer runs.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import threading
import time
from typing import Iterator

import numpy as np

_now = time.perf_counter_ns
_cpu = time.thread_time_ns


class Span:
    """One finished span. Times are ``perf_counter_ns``; ``cpu_ns`` is
    the thread's CPU time over it; ``parent`` and ``call`` are span ids
    (0 for none): the span open around it on its thread (or the one that
    handed its work to a pool thread) and the outermost one of its call."""

    __slots__ = ("id", "name", "tid", "t0", "t1", "cpu_ns", "parent",
                 "call", "attrs")

    def __init__(self, id, name, tid, t0, t1, cpu_ns, parent, call, attrs):
        self.id, self.name, self.tid = id, name, tid
        self.t0, self.t1, self.cpu_ns = t0, t1, cpu_ns
        self.parent, self.call, self.attrs = parent, call, attrs

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"call={self.call}, wall_ns={self.t1 - self.t0}, "
                f"cpu_ns={self.cpu_ns}, {self.attrs})")


class _Noop:
    """The span of every site while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _Noop()


class _Timed(_Noop):
    """A ``LatencyRecorder.timed`` site while the tracer is off."""

    __slots__ = ("rec", "op", "t0")

    def __init__(self, rec, op):
        self.rec, self.op = rec, op

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.rec.record(self.op, time.perf_counter() - self.t0)
        return False


class _Live:
    """An open span while the tracer runs (also what ``current`` gives)."""

    __slots__ = ("tracer", "name", "attrs", "rec", "op", "id", "parent",
                 "call", "t0", "c0")

    def __init__(self, tracer, name, attrs, rec=None, op=None):
        self.tracer, self.name, self.attrs = tracer, name, attrs
        self.rec, self.op = rec, op

    def __enter__(self):
        stack = self.tracer._stack()
        top = stack[-1] if stack else None
        self.id = next(self.tracer._ids)
        self.parent = top.id if top is not None else 0
        self.call = top.call if top is not None else self.id
        stack.append(self)
        self.c0 = _cpu()
        self.t0 = _now()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = _now()
        cpu = _cpu() - self.c0
        self.tracer._stack().pop()
        if self.rec is not None:
            self.rec.record(self.op, (t1 - self.t0) * 1e-9)
        self.tracer._keep(Span(self.id, self.name, threading.get_ident(),
                               self.t0, t1, cpu, self.parent, self.call,
                               self.attrs))
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


class _Adopt:
    """Runs a pool thread's work as a child of a span of another thread."""

    __slots__ = ("tracer", "origin")

    def __init__(self, tracer, origin):
        self.tracer, self.origin = tracer, origin

    def __enter__(self):
        self.tracer._stack().append(self.origin)
        return self

    def __exit__(self, *exc) -> bool:
        self.tracer._stack().pop()
        return False


class Tracer:
    """Spans of the search path in a bounded in-memory buffer, and the
    interpreter's collections as ``gc.collect`` spans while it runs.
    When the buffer is full the oldest span goes and ``dropped``
    counts it. Nothing is written anywhere."""

    def __init__(self, capacity: int = 1 << 18):
        self.on = False
        self.capacity = capacity
        #: spans dropped from the buffer since ``start``
        self.dropped = 0
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        # re-entrant: a collection, and so ``_on_gc``, can start at any
        # allocation, also one made while the buffer is held
        self._mu = threading.RLock()
        self._tls = threading.local()
        self._ids = itertools.count(1)

    def start(self) -> None:
        """Start recording (and hook the interpreter's collections)."""
        with self._mu:
            self.dropped = 0
            if self._on_gc not in gc.callbacks:
                gc.callbacks.append(self._on_gc)
            self.on = True

    def stop(self) -> None:
        """Stop recording; the buffer keeps what it holds."""
        with self._mu:
            self.on = False
            if self._on_gc in gc.callbacks:
                gc.callbacks.remove(self._on_gc)

    def drain(self) -> list[Span]:
        """The buffered spans, oldest first; the buffer is left empty.
        An attribute a site gave as a one-element tensor (a device value,
        such as K3's live block count) becomes its number here, read
        after the traced calls' own result copies have waited for it."""
        with self._mu:
            out = self._buf
            self._buf = collections.deque(maxlen=self.capacity)
        for s in out:
            for key, value in s.attrs.items():
                if hasattr(value, "item"):
                    s.attrs[key] = value.item()
        return list(out)

    def current(self) -> _Live | None:
        """This thread's innermost open span (None while off)."""
        if not self.on:
            return None
        stack = self._stack()
        return stack[-1] if stack else None

    def adopt(self, origin: _Live | None):
        """Context for a pool thread doing ``origin``'s work: its spans
        take ``origin`` as parent and share its call id."""
        if origin is None or not self.on:
            return _NOOP
        return _Adopt(self, origin)

    def clock(self) -> int:
        """``perf_counter_ns`` while the tracer runs, else 0: for a
        site's wait attributes (``lock_wait_ns``)."""
        return _now() if self.on else 0

    # -- recording --------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _keep(self, span: Span) -> None:
        with self._mu:
            if not self.on:
                return
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(span)

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._tls.gc = (_now(), _cpu())
            return
        began = getattr(self._tls, "gc", None)
        if began is None:
            return
        t1, cpu = _now(), _cpu() - began[1]
        self._tls.gc = None
        top = self.current()
        self._keep(Span(
            next(self._ids), "gc.collect", threading.get_ident(), began[0],
            t1, cpu, top.id if top is not None else 0,
            top.call if top is not None else 0,
            {"generation": info["generation"],
             "collected": info["collected"]}))


#: the process's tracer: off until an operator starts it
TRACER = Tracer()


def span(name: str, **attrs):
    """A span named ``name`` over the ``with`` block, with small int or
    str ``attrs`` (more through ``.set(...)``); a shared no-op while
    the tracer is off."""
    if not TRACER.on:
        return _NOOP
    return _Live(TRACER, name, attrs)


class LatencyRecorder:
    """Fixed-size reservoir of operation latencies (seconds)."""

    def __init__(self, capacity: int = 2048):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._data: dict[str, list[float]] = {}
        self._counts: dict[str, int] = {}

    def record(self, op: str, seconds: float) -> None:
        with self._lock:
            buf = self._data.setdefault(op, [])
            n = self._counts.get(op, 0)
            if len(buf) < self.capacity:
                buf.append(seconds)
            else:  # reservoir sampling keeps an unbiased sample
                j = np.random.randint(0, n + 1)
                if j < self.capacity:
                    buf[j] = seconds
            self._counts[op] = n + 1

    def timed(self, op: str, name: str | None = None, **attrs):
        """Time the ``with`` block into ``op``'s reservoir; while the
        tracer runs it is also a span, named ``name`` (default ``op``),
        with ``attrs``."""
        if not TRACER.on:
            return _Timed(self, op)
        return _Live(TRACER, name or op, attrs, self, op)

    def summary(self) -> dict[str, dict[str, float]]:
        with self._lock:
            out = {}
            for op, buf in self._data.items():
                if not buf:
                    continue
                arr = np.asarray(buf)
                out[op] = {
                    "count": self._counts[op],
                    "p50_ms": round(float(np.percentile(arr, 50)) * 1000, 3),
                    "p95_ms": round(float(np.percentile(arr, 95)) * 1000, 3),
                    "p99_ms": round(float(np.percentile(arr, 99)) * 1000, 3),
                    "mean_ms": round(float(arr.mean()) * 1000, 3),
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self._data.clear()
            self._counts.clear()


@contextlib.contextmanager
def trace(log_dir: str = "wdbx_trace") -> Iterator[str]:
    """Capture a torch.profiler trace of the enclosed block (CPU, plus
    CUDA when a card is present) into ``log_dir/trace.json``.

    >>> with trace("t") as d:
    ...     store.search_batch(queries)
    # then open t/trace.json in chrome://tracing or Perfetto
    """
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
