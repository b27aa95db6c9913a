"""Reentrant readers-writer lock for index state.

Why not a plain RLock: index mutators write the slab tensors in place
(no slab copy per insert), so a search that snapshotted the tensors
must exclude mutators for the duration of its device compute, but two
searches never conflict: reads share, writes exclude. This is the classic RW lock, with reentrancy:

  * a thread holding write may nest read or write sections freely
    (compact() calls add_batch(); IVF wraps Flat mutators);
  * a thread holding only read may NOT upgrade to write — callers that
    might mutate (e.g. IVF's build-if-stale) must take write first or
    release-and-retry (see IVFIndex.search).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    def __init__(self):
        self._cond = threading.Condition()
        self._readers: dict[int, int] = {}  # thread ident -> hold count
        self._writer: int | None = None
        self._writer_count = 0
        self._writers_waiting = 0

    @contextmanager
    def read(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._writer_count += 1  # write implies read; stay writer
                as_writer = True
            else:
                # Writer preference: fresh readers queue behind a WAITING
                # writer (otherwise a continuous stream of overlapping
                # searches starves mutators forever). Threads already
                # holding a read section re-enter freely — blocking them
                # would deadlock the nested-read patterns in the indexes.
                while self._writer is not None or (
                    self._writers_waiting and me not in self._readers
                ):
                    self._cond.wait()
                self._readers[me] = self._readers.get(me, 0) + 1
                as_writer = False
        try:
            yield
        finally:
            with self._cond:
                if as_writer:
                    self._writer_count -= 1
                else:
                    c = self._readers[me] - 1
                    if c:
                        self._readers[me] = c
                    else:
                        del self._readers[me]
                self._cond.notify_all()

    @contextmanager
    def write(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._writer_count += 1
            else:
                if me in self._readers:
                    raise RuntimeError(
                        "read->write upgrade would deadlock; take write() "
                        "first or release the read section"
                    )
                self._writers_waiting += 1
                try:
                    while self._writer is not None or self._readers:
                        self._cond.wait()
                finally:
                    self._writers_waiting -= 1
                self._writer = me
                self._writer_count = 1
        try:
            yield
        finally:
            with self._cond:
                self._writer_count -= 1
                if self._writer_count == 0:
                    self._writer = None
                self._cond.notify_all()
