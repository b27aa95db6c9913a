"""The clustered IVF engine against the plain reference of its semantics.

``portbench/reference/ivf.py`` probes, scans the probed buckets' live
rows and the residual rows, and scores (int8 codes times row scale)
against the bf16-rounded query, over the built index's own trained
state. ``ClusteredIVFIndex`` over int8 codes, cosine, is held to it on
both CPU routes: the kernel path's plain version (``ivf_kernel=
"pallas"``) and the portable scan (``"lax"``), at a batch of 128 and a
batch of 1, after a residual add and a delete. Three planted faults
fail the comparison: int8 queries, a dedup cut to one block, one row
scale altered.

Data: the benchmark's seeded unit-norm mixture at d = 768, 16,384 rows
of 64 components, nlist 128 and nprobe 2 (the 10M cell's 4,096 and 8,
scaled down), 256-row scan blocks, so a batch of 128 lists most blocks
and a batch of 1 a few.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.reference import ivf as ref  # noqa: E402
from portbench.reference.mixture import Mixture  # noqa: E402
from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex  # noqa: E402
from wdbx_tpu_torch.kernels import clustered_scan  # noqa: E402

D, ROWS, COMPONENTS, NLIST, NPROBE, K = 768, 16_384, 64, 128, 2, 10
SEED = 2**33 + 22


@pytest.fixture(scope="module")
def mix():
    return Mixture(SEED, COMPONENTS, D, 0.67, 4096, "cpu")


def build(mix, route: str) -> ClusteredIVFIndex:
    index = ClusteredIVFIndex(D, metric="cosine", dtype="int8",
                              capacity=ROWS, nlist=NLIST, nprobe=NPROBE,
                              device="cpu")
    index.ivf_kernel = route
    index.block_bytes_target = 256 * D  # 256-row blocks
    index.batch_flat_fallback = False  # the scan path, not a flat scan
    index.latency_path = "narrow"  # a batch of 1 on the named route too
    for _, rows in mix.chunks(ROWS):
        index.add_batch(rows.numpy())
    index.build()
    assert index.is_trained and index._c == 256
    return index


@pytest.fixture(scope="module")
def built(mix):
    return {route: build(mix, route) for route in ("pallas", "lax")}


def queries(mix, b: int) -> np.ndarray:
    return mix.queries(128)[:b].numpy()


def check(index, q, state=None) -> dict:
    state = state or ref.state_of(index)
    scores, slots = index.search(q, K)
    return ref.compare(state, q, slots, scores, K, index.nprobe)


@pytest.fixture
def scans(monkeypatch):
    """Calls of the kernel path's block scan (K3's plain version on the
    CPU) and of the portable scan's."""
    seen = {"pallas": 0, "lax": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            seen[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(clustered_scan, "clustered_block_topk_v2",
                        spy("pallas", clustered_scan.clustered_block_topk_v2))
    monkeypatch.setattr(clustered_scan, "clustered_block_topk_plain",
                        spy("lax", clustered_scan.clustered_block_topk_plain))
    return seen


@pytest.mark.parametrize("b", [128, 1])
@pytest.mark.parametrize("route", ["pallas", "lax"])
def test_engine_meets_the_reference(built, mix, scans, route, b):
    index = built[route]
    got = check(index, queries(mix, b))
    assert got["queries"] == b
    assert got["dead"] == got["a"] == got["b"] == 0, got
    # the route named served the batch (on the CPU the kernel path's
    # K3 runs its plain version, the portable scan's own block scan)
    assert scans == ({"pallas": 1, "lax": 1} if route == "pallas"
                     else {"pallas": 0, "lax": 1})


def test_a_batch_of_one_reads_few_blocks(built, mix):
    # the reference's candidates of one query lie in a few of the 64
    # blocks, so the comparison at a batch of 1 is not a flat scan's
    index = built["pallas"]
    state = ref.state_of(index)
    q, _ = ref._query(state, queries(mix, 1))
    rows = ref.candidates(state, q[0], NPROBE)
    blocks = torch.unique(rows // index._c).numel()
    assert 0 < blocks <= (index._cap // index._c) // 8


@pytest.mark.parametrize("route", ["pallas", "lax"])
def test_a_residual_row_and_a_deleted_row(mix, route):
    index = build(mix, route)
    q = queries(mix, 128)
    scores, slots = index.search(q, K)
    gone = int(slots[0, 0])
    gone_pos = int(index._pos_of[gone])
    index.remove_slots(np.array([gone]))
    fresh = q[1] / np.linalg.norm(q[1])
    (new,) = index.add_batch(fresh[None, :])
    assert index._residual, "the add landed in the residual rows"
    got = check(index, q)
    assert got["dead"] == got["a"] == got["b"] == 0, got
    scores, slots = index.search(q, K)
    # the slot may be reused by the add; the deleted row is not served
    assert gone_pos not in index._pos_of[slots[slots >= 0]]
    assert slots[1, 0] == new  # the query itself, found in the residual
    assert int(index._pos_of[new]) in index._residual


def test_fault_int8_queries(built, mix):
    index = built["pallas"]
    state = ref.state_of(index)
    index.kernel_qprec = "int8"
    try:
        got = check(index, queries(mix, 128), state)
    finally:
        index.kernel_qprec = "bf16"
    assert got["a"] > 0, got
    assert got["worst_a"] > 10 * ref.TOL


@pytest.mark.parametrize("route", ["pallas", "lax"])
def test_fault_dedup_cut_to_one_block(built, mix, monkeypatch, route):
    index = built[route]
    monkeypatch.setattr(index, "_scan_u", lambda *a, **kw: 1)
    got = check(index, queries(mix, 128))
    assert got["b"] > 0, got


@pytest.mark.parametrize("route", ["pallas", "lax"])
def test_fault_one_row_scale_altered(mix, route):
    index = build(mix, route)
    q = queries(mix, 128)
    state = ref.state_of(index)
    _, slots = index.search(q, K)
    pos = int(index._pos_of[slots[5, 0]])
    index._scales[pos] *= 1.001
    got = check(index, q, state)
    assert got["a"] > 0, got


def test_state_is_read_not_shared_where_a_fault_could_reach(built):
    index = built["lax"]
    state = ref.state_of(index)
    assert state.codes.data_ptr() == index._slab.data_ptr()
    assert state.scales.data_ptr() != index._scales.data_ptr()
    assert state.live.data_ptr() != index._valid.data_ptr()
    assert int(state.bucket_start[-1]) == int(state.live.sum())
