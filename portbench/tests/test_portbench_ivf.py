"""The clustered IVF cell, ``ivf10m.bulk``: its configuration and cell
resolve, its two readers give hand-computed values from hand-built spans
(and None without them), the plain IVF reference loads nothing of the
program, and on the card the cell's own path answers as the reference
says at 10M x 768."""

import shutil
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest
import torch

from portbench import devtrace, harness, loops, progtrace, roofline
from wdbx_tpu_torch.utils.metrics import Span

BENCH = harness.spec()
CELL, CONFIG = "ivf10m.bulk", "cohere10m-ivf-int8"
READERS = ("k3.roofline_share", "clustered.enqueue_ms_per_call")
#: the flat cell's readers that read this cell too: every one but K1's
SHARED = ("store.host_ms_per_call", "device.idle_share.bulk",
          "store.merge_cpu_ms_per_call", "store.merge_offcpu_ms_per_call",
          "host.lock_wait_ms_per_call", "host.gc_pause_share",
          "device.idle_in_index_share")
W0 = 1_000_000_000  # the window: 1.0 s to 1.1 s on the host clock
MS = 1_000_000
#: a recorded K3 launch at 10M x 768, nprobe 1 (H100): 490 live blocks
#: of 1,024 int8 rows, u 1,024, B=128, k=10, and its 1.113 ms a launch
LAUNCH = dict(slab="int8", qtype="bfloat16", body="mma_pipe", c=1024, d=768,
              b=128, k=10, u=1024, parts=132, live=490)
LEAST_S = 0.11584343880597016e-3
K3_S = 1.113e-3


def test_config_and_cell_resolve():
    cell = harness.cell_of(BENCH, CELL)
    assert cell == {"name": CELL, "config": CONFIG, "traffic": "bulk-4x128",
                    "chips": 1, "why": cell["why"]}
    cfg = harness.config_of(BENCH, CONFIG)
    s = cfg["settings"]
    assert (s["INDEX_TYPE"], s["INDEX_DTYPE"], s["INDEX_METRIC"]) == \
        ("ivf", "int8", "cosine")
    assert (s["IVF_NLIST"], s["IVF_NPROBE"], s["NUM_SHARDS"]) == (4096, 8, 1)
    assert s["VECTOR_STORE_KEEP_RAW"] is False
    assert cfg["build_index"] is True and cfg["reduced"] == []
    assert cfg["control"] == {"settings": {"INDEX_DTYPE": "int4"}}
    assert (cfg["corpus"]["rows"], cfg["corpus"]["dim"]) == (10_000_000, 768)
    traffic = harness.traffic_of(cell["traffic"])
    assert (traffic["callers"], traffic["batch"], traffic["k"]) == (4, 128, 10)
    for name in READERS:
        (m,) = [m for m in BENCH["per_layer"] if m["name"] == name]
        assert m["workloads"] == [CELL] and m["moves"] == "search_qps"
    for name in SHARED:
        (m,) = [m for m in BENCH["per_layer"] if m["name"] == name]
        assert m["workloads"] == ["flat10m.bulk", CELL]
    assert {m["name"] for m in harness.metrics_of(BENCH, CELL, True)} == \
        set(READERS) | set(SHARED)


def span(id, name, t0, t1, parent=0, call=0, tid=1, **attrs):
    return Span(id, name, tid, W0 + int(t0 * MS), W0 + int(t1 * MS), 0,
                parent, call, attrs)


#: two batches of the clustered engine, times in ms from the window's
#: start; the second one's K3 has no live count
SPANS = [
    span(10, "store.search_batch", 0, 30, call=10),
    span(11, "index.search", 1, 20, parent=10, call=10,
         engine="ClusteredIVFIndex", lock_wait_ns=0),
    span(12, "index.probe", 1, 2, parent=11, call=10),
    span(13, "index.dedup", 2, 4, parent=11, call=10),
    span(14, "kernel.k3", 4, 5, parent=11, call=10, **LAUNCH),
    span(15, "index.residual_merge", 5, 6, parent=11, call=10),
    span(16, "index.d2h", 6, 18, parent=11, call=10),
    span(20, "store.search_batch", 40, 90, tid=2, call=20),
    span(21, "index.search", 41, 70, tid=2, parent=20, call=20,
         engine="ClusteredIVFIndex", lock_wait_ns=0),
    span(24, "kernel.k3", 44, 45, tid=2, parent=21, call=20,
         **{k: v for k, v in LAUNCH.items() if k != "live"}),
    span(26, "index.d2h", 50, 69, tid=2, parent=21, call=20),
    # a flat search's span is another engine's
    span(30, "index.search", 91, 99, tid=3, call=30, engine="FlatIndex"),
]


class FakeTrace:
    ops = [("void clustered_pipe_kernel<1, 1, 1, 2>(void const*)", 1.004,
            1.004 + K3_S),
           ("void topk_merge_partials_kernel<16>(float const*)", 1.006,
            1.0061),
           ("void clustered_pipe_kernel<1, 1, 1, 2>(void const*)", 1.045,
            1.045 + K3_S)]
    kernel_s = devtrace.DeviceTrace.kernel_s


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
        trace=FakeTrace() if trace else None, n_rows=10_000_000)


def test_k3_least_time_is_the_recorded_launch_bound():
    t, by = roofline.block_scan_s(*(LAUNCH[k] for k in (
        "slab", "qtype", "live", "c", "d", "b", "k", "u")))
    assert by == "bytes" and t == pytest.approx(LEAST_S, rel=1e-12)


def test_k3_roofline_share_of_hand_built_spans(monkeypatch, capsys):
    monkeypatch.setattr(progtrace, "TRACER", FakeTracer(SPANS))
    got = harness.reader("k3.roofline_share").read(ctx_of())
    # one launch with a live count: its least time over both launches'
    # device time, as a launch without the count is not known
    assert got == pytest.approx(100 * LEAST_S / (2 * K3_S))
    err = capsys.readouterr().err
    assert "1 launches (1 without a live count), 490.0 live blocks" in err
    assert "least 0.000116 s (bytes bound" in err


def test_enqueue_ms_of_hand_built_spans(monkeypatch, capsys):
    monkeypatch.setattr(progtrace, "TRACER", FakeTracer(SPANS))
    got = harness.reader("clustered.enqueue_ms_per_call").read(ctx_of())
    assert got == pytest.approx(((19 - 12) + (29 - 19)) / 2)
    err = capsys.readouterr().err
    assert "2 of 2 calls with a result copy, index.search 24.000 ms" in err
    assert "index.d2h 15.500 ms (cpu 0.000) x2" in err
    assert "kernel.k3 1.000 ms (cpu 0.000) x2" in err


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_gives_none(monkeypatch, name):
    mod = harness.reader(name)
    monkeypatch.setattr(progtrace, "TRACER", None)  # a program without it
    assert mod.read(ctx_of()) is None
    monkeypatch.setattr(progtrace, "TRACER", FakeTracer([]))
    assert mod.read(ctx_of()) is None
    # the parent's program: the engine's index.search alone, no spans
    # inside it
    monkeypatch.setattr(progtrace, "TRACER", FakeTracer(
        [s for s in SPANS if s.name in ("store.search_batch",
                                        "index.search")]))
    assert mod.read(ctx_of()) is None
    monkeypatch.setattr(progtrace, "TRACER", FakeTracer(SPANS))
    if name == "k3.roofline_share":
        assert mod.read(ctx_of(trace=False)) is None


def test_the_ivf_reference_imports_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; import portbench.reference.ivf; "
         "print(sorted({m.split('.')[0] for m in sys.modules} & "
         "{'wdbx_tpu_torch', 'wdbx_tpu', 'jax'}))"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


#: the chip test's window, and the batches whose block lists it counts
CHIP_SECONDS, CHIP_LISTS = 8.0, 16


@pytest.mark.chip
def test_cell_answers_meet_the_ivf_reference(seed):
    """The cell's own ``prepare()`` and closed loop for a short window at
    10M x 768; every answer a caller kept, held against
    ``reference/ivf.py`` over the built index's state; K3 and the dedup
    kernel served every call; the blocks the dedup listed against the
    probed buckets'; and the same batches with int8 queries fail the
    comparison."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    from portbench.reference import ivf
    from wdbx_tpu_torch.kernels.block_dedup import block_dedup
    from wdbx_tpu_torch.kernels.clustered_scan import clustered_block_partial
    from wdbx_tpu_torch.kernels.fused_topk import fused_topk_partial
    from wdbx_tpu_torch.utils.metrics import TRACER

    config = harness.config_of(BENCH, CONFIG)
    traffic = harness.traffic_of(harness.cell_of(BENCH, CELL)["traffic"])
    k, nprobe = traffic["k"], config["settings"]["IVF_NPROBE"]
    data_dir = tempfile.mkdtemp(prefix="portbench_ivf_")
    try:
        db, _, pool = harness.prepare(config, traffic, seed, "cuda",
                                      data_dir)
        index = db.store.indices[0]
        assert type(index).__name__ == "ClusteredIVFIndex"
        k3_0 = sum(clustered_block_partial.launches.values())
        k1_0 = sum(fused_topk_partial.launches.values())
        dedup_0 = block_dedup.launches
        load = harness.run_load(db, traffic, pool, seed, CHIP_SECONDS,
                                None, None)
        k3 = sum(clustered_block_partial.launches.values()) - k3_0
        k1 = sum(fused_topk_partial.launches.values()) - k1_0
        dedups = block_dedup.launches - dedup_0
        calls = len(load.calls) + traffic["callers"] * traffic["warmup_calls"]
        slots = db.store._ids_for(0)
        row_of_slot = np.array([-1 if i is None else int(i) for i in slots],
                               np.int64)
        state = ivf.state_of(index, row_of_slot)
        ids = np.array([[int(i) for i in a[0]] for a in load.answers])
        scores = np.array([a[1] for a in load.answers], np.float32)
        qidx = np.asarray(load.qidx)
        got = {"queries": 0, "dead": 0, "a": 0, "b": 0, "worst_a": 0.0,
               "worst_b": 0.0, "flipped": 0, "a_plain": 0, "b_plain": 0,
               "plain_unflipped": 0}
        for lo in range(0, len(qidx), 4096):
            part = ivf.compare(state, pool[qidx[lo:lo + 4096]],
                               ids[lo:lo + 4096], scores[lo:lo + 4096], k,
                               nprobe)
            for key in got:
                got[key] = (max(got[key], part[key]) if key.startswith("worst")
                            else got[key] + part[key])

        # the dedup's block list against the probed buckets' blocks
        plan = loops.batches(traffic, seed, len(pool))[:CHIP_LISTS]
        c = index._c
        probed = []
        q_all, _ = ivf._query(state, pool)
        for idx in plan:
            blocks = set()
            for i in idx:
                p = torch.topk(state.centroids @ q_all[i], nprobe).indices
                lo_b = (state.bucket_start[p] // c).tolist()
                hi_b = ((state.bucket_start[p + 1] + c - 1) // c).tolist()
                for a, b in zip(lo_b, hi_b):
                    blocks.update(range(a, b))
            probed.append(len(blocks))
        was_on = TRACER.on  # importing progtrace started it
        TRACER.start()
        TRACER.drain()
        try:
            for idx in plan:
                db.vector_search_batch(pool[idx], limit=k)
        finally:
            if not was_on:
                TRACER.stop()
        listed = [s.attrs.get("live") for s in TRACER.drain()
                  if s.name == "kernel.k3"]

        # the planted fault at full size: queries in int8, one precision
        # below the stated bf16, still fail rule (a) with the slack on
        qprec = getattr(index, "kernel_qprec", "bf16")
        index.kernel_qprec = "int8"
        try:
            low = [loops.compact(h) for idx in plan
                   for h in db.vector_search_batch(pool[idx], limit=k)]
        finally:
            index.kernel_qprec = qprec
        low_got = ivf.compare(
            state, pool[np.concatenate(plan)],
            np.array([[int(i) for i in a[0]] for a in low]),
            np.array([a[1] for a in low], np.float32), k, nprobe)
        print(f"ivf10m.bulk at 10M x 768: {got['queries']} checked queries, "
              f"failing (a) {got['a']}, (b) {got['b']}, dead {got['dead']}; "
              f"widest score difference {got['worst_a']:.3e}, widest "
              f"shortfall {got['worst_b']:.3e} (tolerance {ivf.TOL:g}); "
              f"{got['flipped']} queries with an ambiguous bf16 rounding; "
              f"without the slack (a) {got['a_plain']}, (b) "
              f"{got['b_plain']}, of them unambiguous "
              f"{got['plain_unflipped']}; "
              f"K3 launches {k3} and dedup launches {dedups} for {calls} "
              f"calls, K1 launches {k1}; "
              f"blocks listed a call {min(listed)}-{max(listed)} against "
              f"probed {min(probed)}-{max(probed)}, "
              f"{sum(a != b for a, b in zip(listed, probed))} of "
              f"{len(probed)} differ; int8 queries: of "
              f"{low_got['queries']}, (a) {low_got['a']}, (b) "
              f"{low_got['b']}, widest score difference "
              f"{low_got['worst_a']:.3e}; "
              f"{torch.cuda.get_device_name(0)}")
        assert got["queries"] > 0
        assert got["dead"] == got["a"] == got["b"] == 0, got
        assert got["plain_unflipped"] == 0, got
        assert k3 == dedups == calls and k1 == 0
        assert listed == probed
        assert low_got["a"] > 0, low_got
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
