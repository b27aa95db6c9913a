"""Latency metrics and profiling hooks.

The reference has no timers or profiler integration at all (SURVEY.md
§5.1 — its only artifact is a percentage ProgressLogger). Here every
store operation feeds a reservoir of latencies exposed through
``get_stats`` (p50/p95/p99), and ``trace`` wraps ``torch.profiler`` so a
hot path (host and CUDA activity) can be captured as a Chrome trace
with one context manager.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator

import numpy as np


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

    @contextlib.contextmanager
    def timed(self, op: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(op, time.perf_counter() - t0)

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
