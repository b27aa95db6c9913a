"""Spans recorded from the benchmark's side, around calls into the program.

A span target is ``"module:attr"`` or ``"module:Class.method"``: the
name is looked up where the program looks it up at call time, so a
function imported into another module is wrapped in that module. The
wrappers are installed only in a traced run, before its warm-up, and
record only while the window is open. Each span keeps its thread, its
start and end on the host's ``perf_counter`` clock, the span that was
open around it on the same thread, and what its ``meta`` function took
from the call.
"""

from __future__ import annotations

import functools
import importlib
import threading
import time
from typing import Any, Callable


class Span:
    __slots__ = ("name", "tid", "t0", "t1", "parent", "depth", "meta")

    def __init__(self, name, tid, t0, parent, depth):
        self.name, self.tid, self.t0, self.t1 = name, tid, t0, None
        self.parent, self.depth, self.meta = parent, depth, None


class SpanLog:
    def __init__(self):
        self.spans: list[Span] = []
        self.recording = False
        self._tls = threading.local()
        self._mu = threading.Lock()
        self._undo: list[tuple[Any, str, Any]] = []

    # -- recording --------------------------------------------------------
    def _open(self, name: str) -> Span | None:
        if not self.recording:
            return None
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        parent = stack[-1] if stack else None
        span = Span(name, threading.get_ident(), time.perf_counter(),
                    parent, len(stack))
        stack.append(span)
        return span

    def _close(self, span: Span) -> None:
        span.t1 = time.perf_counter()
        self._tls.stack.pop()
        with self._mu:
            self.spans.append(span)

    def wrap(self, fn: Callable, name: str, meta: Callable | None = None):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            span = self._open(name)
            if span is None:
                return fn(*args, **kwargs)
            try:
                out = fn(*args, **kwargs)
                if meta is not None:
                    span.meta = meta(args, kwargs, out)
                return out
            finally:
                self._close(span)
        return wrapper

    # -- installation -----------------------------------------------------
    def install(self, target: str, meta: Callable | None = None) -> None:
        """Wrap ``target`` (``"module:attr"`` / ``"module:Cls.attr"``);
        the span's name is the part after the colon. Installing a target
        twice wraps it once."""
        mod_name, path = target.split(":")
        owner: Any = importlib.import_module(mod_name)
        *outer, attr = path.split(".")
        for part in outer:
            owner = getattr(owner, part)
        if any(o is owner and a == attr for o, a, _ in self._undo):
            return
        orig = getattr(owner, attr)
        self._undo.append((owner, attr, orig))
        setattr(owner, attr, self.wrap(orig, path, meta))

    def uninstall(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()

    # -- reading ----------------------------------------------------------
    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self) -> dict[int, list[Span]]:
        """Direct children of each span, keyed by ``id(parent)``."""
        out: dict[int, list[Span]] = {}
        for s in self.spans:
            if s.parent is not None:
                out.setdefault(id(s.parent), []).append(s)
        return out


def self_time(span: Span, kids: dict[int, list[Span]], less: set[str]
              ) -> float:
    """Seconds of ``span`` less those of its direct children named in
    ``less``."""
    inner = sum(c.t1 - c.t0 for c in kids.get(id(span), ()) if c.name in less)
    return (span.t1 - span.t0) - inner
