"""The device's side of a traced window, from ``torch.profiler``.

Only CUDA activity is traced (kernels, copies and sets, whichever
thread launched them). At the start, after a synchronisation, the
window launches one marker (a one-element fill) and notes the host's
``perf_counter`` just before: the marker's start on the device clock
ties the two clocks together, so idle gaps can be labelled by the
benchmark's spans that were open on the host at the time.

``busy_s`` is the union of the device operations' intervals inside the
window, so operations that overlap on two streams count once.
"""

from __future__ import annotations

import re
import time

import torch

#: kineto device types whose events are operations on the card
_DEVICE_TYPES = ("CUDA",)


def _short(name: str) -> str:
    """A kernel name without its return type, template and arguments."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:96] or name[:96]


def _events(prof) -> list[tuple[str, float, float]]:
    """``(name, start_s, end_s)`` of every device event, device clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).split(".")[-1] not in _DEVICE_TYPES:
            continue
        if hasattr(e, "start_ns"):
            t0 = e.start_ns() * 1e-9
            t1 = t0 + e.duration_ns() * 1e-9
        else:
            t0 = e.start_us() * 1e-6
            t1 = t0 + e.duration_us() * 1e-6
        out.append((e.name(), t0, t1))
    out.sort(key=lambda ev: ev[1])
    return out


class DeviceTrace:
    """Open with ``start()`` just before the window, ``stop()`` just
    after; then ``busy_s``, ``window_s``, ``ops`` and ``gaps()``."""

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._mark = torch.empty(1, device="cuda")
        self.h0 = time.perf_counter()
        self._mark.fill_(1.0)

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.h1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        events = _events(self._prof)
        del self._prof
        if not events:
            self.ops, self.busy_s, self.window_s = [], 0.0, self.h1 - self.h0
            return
        # the marker is the first fill: nothing else ran after the sync
        first = next((i for i, ev in enumerate(events)
                      if re.search(r"[Ff]ill", ev[0])), 0)
        d0 = events[first][1]
        self.window_s = self.h1 - self.h0
        d1 = d0 + self.window_s
        #: (name, start, end) in host seconds, clipped to the window
        self.ops = [(n, self.h0 + max(a, d0) - d0, self.h0 + min(b, d1) - d0)
                    for n, a, b in events[first + 1:] if b > d0 and a < d1]
        self.busy_s = sum(b - a for a, b in self._union())

    def _union(self) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for _, a, b in self.ops:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def gaps(self) -> list[tuple[float, float]]:
        """Idle intervals of the window, host clock."""
        out, t = [], self.h0
        for a, b in self._union():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.h0 + self.window_s > t:
            out.append((t, self.h0 + self.window_s))
        return out

    def idle_share(self) -> float | None:
        if self.busy_s <= 0 or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches."""
        rx = re.compile(pattern)
        return sum(b - a for n, a, b in self.ops if rx.search(n))

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for name, a, b in self.ops:
            key = _short(name)
            by[key] = by.get(key, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, spans, n: int = 10) -> list[list]:
        """Idle seconds by what the host was doing at each gap's middle:
        the innermost benchmark spans open then (on any thread), or
        ``no span`` (the load's own loop, the interpreter, waiting)."""
        gaps = self.gaps()
        marks = sorted(((g[0] + g[1]) / 2, i) for i, g in enumerate(gaps))
        edges = sorted([(s.t0, 0, s) for s in spans] +
                       [(s.t1, 1, s) for s in spans], key=lambda e: e[0])
        open_: dict[int, object] = {}
        by: dict[str, float] = {}
        j = 0
        for t, i in marks:
            while j < len(edges) and edges[j][0] <= t:
                _, kind, s = edges[j]
                if kind == 0:
                    open_[id(s)] = s
                else:
                    open_.pop(id(s), None)
                j += 1
            inner: dict[int, object] = {}
            for s in open_.values():
                cur = inner.get(s.tid)
                if cur is None or s.depth > cur.depth:
                    inner[s.tid] = s
            label = "+".join(sorted({s.name for s in inner.values()})) \
                or "no span"
            by[label] = by.get(label, 0.0) + (gaps[i][1] - gaps[i][0])
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
