"""The cases of ``tests/test_rwlock.py`` on the port, on the CPU.

A translated copy of that file: the same classes, functions,
parametrisations and asserts, run on ``wdbx_tpu_torch``. Each
``wdbx_tpu`` import names its ``wdbx_tpu_torch`` counterpart; the
autouse fixture asks for the CPU through
``test_torch_ops.port_on_cpu`` (the default device and mesh of one
test), so the package keeps the card as its own default.

Translated, every case (6 cases):
test_readers_share; test_writer_excludes_readers;
test_write_reentrant_and_implies_read; test_read_reentrant;
test_upgrade_raises; test_writer_waits_for_reader.

Changed beyond the imports and the fixture: nothing. Left out: nothing.

The reference file's description:

Direct RWLock semantics tests (the donation-safety lock under every
index).
"""

import threading
import time

import pytest

from wdbx_tpu_torch.utils.rwlock import RWLock
from test_torch_ops import port_on_cpu


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    port_on_cpu(monkeypatch)


def test_readers_share():
    lock = RWLock()
    barrier = threading.Barrier(2, timeout=5)
    oks = []

    def reader():
        with lock.read():
            barrier.wait()  # both inside simultaneously or BrokenBarrier
            oks.append(1)

    ts = [threading.Thread(target=reader) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert oks == [1, 1]


def test_writer_excludes_readers():
    lock = RWLock()
    order = []
    in_write = threading.Event()
    release = threading.Event()

    def writer():
        with lock.write():
            in_write.set()
            release.wait(timeout=5)
            order.append("w")

    def reader():
        in_write.wait(timeout=5)
        with lock.read():
            order.append("r")

    tw = threading.Thread(target=writer)
    tr = threading.Thread(target=reader)
    tw.start()
    tr.start()
    time.sleep(0.1)
    assert order == []  # reader blocked behind the writer
    release.set()
    tw.join(timeout=5)
    tr.join(timeout=5)
    assert order == ["w", "r"]


def test_write_reentrant_and_implies_read():
    lock = RWLock()
    with lock.write():
        with lock.write():  # nested write (compact -> add_batch)
            with lock.read():  # write implies read (search under build)
                pass


def test_read_reentrant():
    lock = RWLock()
    with lock.read():
        with lock.read():
            pass


def test_upgrade_raises():
    lock = RWLock()
    with lock.read():
        with pytest.raises(RuntimeError, match="upgrade"):
            with lock.write():
                pass


def test_writer_waits_for_reader():
    lock = RWLock()
    in_read = threading.Event()
    done = []

    def reader():
        with lock.read():
            in_read.set()
            time.sleep(0.2)
            done.append("r")

    def writer():
        in_read.wait(timeout=5)
        with lock.write():
            done.append("w")

    ts = [threading.Thread(target=reader), threading.Thread(target=writer)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=5)
    assert done == ["r", "w"]
