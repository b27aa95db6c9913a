"""The readers of the program's own spans (``portbench/progtrace.py``):
each gives a hand-computed value from hand-built spans and device gaps;
on the card, the program's launches agree with the device trace."""

import types

import pytest
import torch

from portbench import harness, loops, progtrace
from wdbx_tpu_torch.utils.metrics import Span

W0 = 1_000_000_000  # the window: 1.0 s to 1.1 s on the host clock
MS = 1_000_000


def span(id, name, tid, a, b, cpu=0, parent=0, call=0, **attrs):
    return Span(id, name, tid, W0 + int(a * MS), W0 + int(b * MS),
                int(cpu * MS), parent, call, attrs)


#: two callers (threads 1 and 2), times in ms from the window's start
SPANS = [
    span(10, "store.search_batch", 1, 0, 60, call=10),
    span(11, "store.prep", 1, 0, 1, parent=10, call=10, lock_wait_ns=200_000),
    span(12, "index.search", 1, 1, 40, parent=10, call=10,
         lock_wait_ns=300_000),
    span(13, "kernel.k1", 1, 2, 3, parent=12, call=10),
    span(14, "index.d2h", 1, 30, 40, parent=12, call=10),
    span(15, "store.merge", 1, 40, 60, cpu=12, parent=10, call=10),
    span(16, "gc.collect", 1, 45, 47, parent=15, call=10, generation=0,
         collected=3),
    span(20, "store.search_batch", 2, 10, 90, call=20),
    span(21, "store.prep", 2, 10, 11, parent=20, call=20, lock_wait_ns=0),
    span(22, "index.search", 2, 11, 50, parent=20, call=20,
         lock_wait_ns=100_000),
    span(23, "kernel.k1", 2, 20, 21, parent=22, call=20),
    span(25, "store.merge", 2, 50, 90, cpu=30, parent=20, call=20),
    span(30, "gc.collect", 3, 95, 105, generation=2, collected=0),
    # before the window: not read
    span(1, "store.merge", 1, -20, -10, cpu=1, call=1),
]
#: the device's idle intervals, ms from the window's start
GAPS = [(0, 2), (5, 20), (35, 45), (55, 100)]
KERNELS = [(2.01, 2.9), (20.05, 20.9)]


class FakeTrace:
    ops = [("void fused_topk_pipe_kernel<64>(float*)", 1.0 + a / 1e3,
            1.0 + b / 1e3) for a, b in KERNELS]

    def gaps(self):
        return [(1.0 + a / 1e3, 1.0 + b / 1e3) for a, b in GAPS]


class FakeTracer:
    dropped = 0

    def __init__(self, spans):
        self.spans = list(spans)

    def drain(self):
        out, self.spans = self.spans, []
        return out


def ctx_of(trace=True):
    return types.SimpleNamespace(
        load=loops.LoadResult(t0=W0 / 1e9, window_s=0.1),
        trace=FakeTrace() if trace else None)


@pytest.fixture
def tracer(monkeypatch):
    fake = FakeTracer(SPANS)
    monkeypatch.setattr(progtrace, "TRACER", fake)
    return fake


@pytest.mark.parametrize("name,want", [
    ("store.merge_cpu_ms_per_call", (12 + 30) / 2),
    ("store.merge_offcpu_ms_per_call", ((20 - 12) + (40 - 30)) / 2),
    ("host.lock_wait_ms_per_call", ((0.2 + 0.3) + (0 + 0.1)) / 2),
    ("host.gc_pause_share", 100 * (2 + 5) / 100),
    ("device.idle_in_index_share", 100 * (1 + 15 + 10) / 100),
])
def test_reader_gives_the_hand_computed_value(tracer, name, want):
    assert harness.reader(name).read(ctx_of()) == pytest.approx(want)


def test_idle_by_state_and_the_clock_check(tracer, capsys):
    ctx = ctx_of()
    got = progtrace.spans(ctx)
    assert len(got) == len(SPANS) - 1
    w0, w1 = progtrace.window(ctx)
    by, in_index = progtrace.idle_by_state(
        got, progtrace.gaps_ns(ctx.trace, w0, w1))
    assert {k: v / MS for k, v in by.items()} == pytest.approx({
        "gc": 5, "index before launch": 1 + 9, "index after result": 6 + 10,
        "merge": 35, "prep": 1, "store, between spans": 0,
        "outside the program": 5})
    assert in_index / MS == pytest.approx(26)
    n_k1, n_kernels, leads = progtrace.clock_check(got, ctx.trace, w0, w1)
    assert (n_k1, n_kernels) == (2, 2)
    assert leads == pytest.approx([-10_000, -50_000], abs=2)
    harness.reader("device.idle_in_index_share").read(ctx)
    err = capsys.readouterr().err
    assert "index after result 0.016" in err
    assert "store.search_batch less index.search 31.000 ms over 2" in err


def test_each_run_reads_its_own_window(tracer):
    first = ctx_of()
    assert progtrace.named(first, "store.merge")
    later = [span(40, "store.merge", 1, 0, 4, cpu=1, call=40)]
    tracer.spans = later
    second = ctx_of()
    assert [s.id for s in progtrace.spans(second)] == [40]
    assert harness.reader("store.merge_cpu_ms_per_call").read(second) == 1.0


@pytest.mark.parametrize("name", ["store.merge_cpu_ms_per_call",
                                  "store.merge_offcpu_ms_per_call",
                                  "host.lock_wait_ms_per_call",
                                  "host.gc_pause_share",
                                  "device.idle_in_index_share"])
def test_nothing_to_read_gives_none(monkeypatch, name):
    monkeypatch.setattr(progtrace, "TRACER", None)  # a program without it
    assert harness.reader(name).read(ctx_of()) is None
    monkeypatch.setattr(progtrace, "TRACER", FakeTracer([]))
    assert harness.reader(name).read(ctx_of()) is None


@pytest.mark.chip
def test_launches_agree_with_the_device_trace(tiny, seed):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    line, _ = harness.run_cell("flat10m.bulk", seed, 2.0, True,
                               overrides=tiny)
    assert line["correct"] is True, line["checks"]
    assert "device.idle_in_index_share" in line["metrics"]
    got, trace = progtrace._run["spans"], progtrace._run["trace"]
    w0, w1 = progtrace._run["window"]
    n_k1, n_kernels, leads = progtrace.clock_check(got, trace, w0, w1)
    tenth = max(1, len(leads) // 10)
    print(f"kernel.k1 spans {n_k1}, stage-1 kernels {n_kernels}, lead ns: "
          f"max {max(leads, default=0)}, median of the first tenth "
          f"{sorted(leads[:tenth])[tenth // 2]}, of the last "
          f"{sorted(leads[-tenth:])[tenth // 2]}")
    assert n_k1 == n_kernels > 0
    # no device kernel starts before its launch began, within 50 us
    assert max(leads) <= 50_000
