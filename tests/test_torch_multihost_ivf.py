"""The port's ShardedIVFIndex on a global mesh: 2 gloo ranks x 4 CPU
positions (``tests/test_torch_multihost.py``'s runner and prelude).

One 2-rank run does everything; the tests read its records:

* ``TestShardedIVF``: ``tests/test_parallel.py::TestShardedIVF``'s cases
  on the global mesh (float32): each rank holds the tables of its own 4
  shards only, the exact self query and ``tune()``, fresh rows, deletes
  after the build, candidates from every shard, the exact masked route
  and the filter pushdown (no ``ShardedFlatIndex.search`` above 2%),
  the factory.
* For float32, bf16 and int8 slabs, ``STEPS`` (every search route: the
  quota scan at k 1 / 10, the pushdown, pipelined and an in-flight
  handle, a quota overflow that drops probes, fresh rows, deletes and an
  update after the build, the exact masked route, the batch fallback)
  runs twice on the ranks: on the ranks' own build, and on a checkpoint
  of JAX's ``ShardedIVFIndex`` (JAX's layout) loaded onto the ranks.
  The parent holds the first against the single-process 8-position port
  fed the same calls (slots equal, scores within 1e-6: rank 0 trains on
  the single index's sample, and the CPU path is deterministic), and
  the second against the same port and against JAX's index on
  conftest's 8 CPU devices (scores within 1e-5 for float32, the suite's
  ``TOL`` otherwise; slot sets equal except at ties).
* ``.ivf.npz`` written by the 2 ranks loads into the single-process port
  and into JAX; the per-position (``orbax``) checkpoint, with each
  rank's bucket rows in its own shards' files, loads back onto the ranks
  and into the single-process port.
* ``WDBX(enable_distributed=True, INDEX_TYPE="sharded_ivf")`` builds on
  its first search past the train threshold and answers alike on both
  ranks.
"""

import json

import numpy as np
import pytest

from test_torch_multihost import (
    PRELUDE,
    _answers,
    _assert_ok,
    _run_ranks,
    _same,
)
from test_torch_ops import TOL, assert_topk_match
from wdbx_tpu.parallel.sharded_ivf import ShardedIVFIndex as JIndex
from wdbx_tpu_torch.parallel import ShardedIVFIndex, make_mesh

DTYPES = ["float32", "bfloat16", "int8"]

#: the searches of one index, shared by the ranks, the single-process
#: port and JAX: ``ivf_steps(idx, rng)`` -> key -> (scores, slots)
STEPS = r"""
import numpy as np


def _mask(idx, base):
    m = np.zeros(idx.capacity, bool)
    m[:len(base)] = base
    return m


def ivf_steps(idx, rng):
    out = {}
    q = rng.standard_normal((37, 32)).astype(np.float32)
    idx.batch_flat_fallback = False
    out["k1"] = idx.search(q, 1)
    out["k10"] = idx.search(q, 10)
    out["push"] = idx.search(q, 10, slot_mask=_mask(idx, rng.random(2048)
                                                    > 0.5))
    qs = q[:32].reshape(4, 8, 32)
    out["pipe"] = idx.search_pipelined(qs, 5)
    out["handle"] = idx.resolve_pipelined(
        idx.search_pipelined(qs[:2], 5, materialize=False))
    # nprobe 16 of 16 and slack 0.5: each shard's quota drops probes
    nprobe, slack = idx.nprobe, idx.quota_slack
    idx.nprobe, idx.quota_slack = 16, 0.5
    out["overflow"] = idx.search(q, 10)
    out["overflow_pipe"] = idx.search_pipelined(qs, 10)
    idx.nprobe, idx.quota_slack = nprobe, slack
    fresh = rng.standard_normal((25, 32)).astype(np.float32)
    idx.add_batch(fresh)
    idx.remove_slots(np.array([3, 4, 17, 2050]))
    idx.update_slots(np.array([9]),
                     rng.standard_normal((1, 32)).astype(np.float32))
    out["after"] = idx.search(q, 10)
    out["fresh"] = idx.search(fresh, 3)
    sparse = np.zeros(2048, bool)
    sparse[::64] = True  # 32 rows, under 2%: the exact masked route
    out["exact"] = idx.search(q, 5, slot_mask=_mask(idx, sparse))
    idx.batch_flat_fallback = True
    out["fallback"] = idx.search(q, 10)
    return out


def own_build(idx):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2048, 32)).astype(np.float32)
    idx.add_batch(x / np.linalg.norm(x, axis=-1, keepdims=True))
    idx.build()
    return ivf_steps(idx, rng)
"""

IVF_WORKER = PRELUDE + STEPS + r"""
asyncio.run(engine.initialize())
from wdbx_tpu_torch.parallel import (
    ShardedFlatIndex, ShardedIVFIndex, collective, make_mesh)
DTYPES = ["float32", "bfloat16", "int8"]
mesh = make_mesh(device="cpu")
assert mesh.is_global and mesh.local_positions == tuple(
    range(4 * rank, 4 * rank + 4)), mesh.owners
own = list(range(4 * rank, 4 * rank + 4))
ans, facts = {}, {}


def put(prefix, got):
    ans.update({f"{prefix}/{key}": pair for key, pair in got.items()})


def mk(dtype="float32", **kw):
    return ShardedIVFIndex(dim=32, dtype=dtype, train_threshold=256,
                           mesh=mesh, **kw)


for dtype in DTYPES:
    idx = mk(dtype, nlist=16, nprobe=4)
    collective.reset_stats()
    put(f"{dtype}/own", own_build(idx))
    if dtype == "int8":
        assert idx._bucket_scale is not None
    held = [s for s, t in enumerate(idx._bucket_rows) if t is not None]
    assert held == own, held
    moved = collective.stats().get("all_to_all", {}).get("bytes", 0)
    facts[f"{dtype}/moved"] = moved
    facts[f"{dtype}/len"] = [idx.count(), idx.valid_count()]
    idx.save(os.path.join(out, f"ranks_{dtype}"))
    idx.persist_backend = "orbax"
    idx.save(os.path.join(out, f"orbax_{dtype}"))
    back = mk(dtype, nlist=16)
    back.persist_backend = "orbax"
    assert back.load(os.path.join(out, f"orbax_{dtype}"))
    assert back.is_trained
    q = np.random.default_rng(5).standard_normal((12, 32)).astype(np.float32)
    back.batch_flat_fallback = idx.batch_flat_fallback = False
    ans[f"{dtype}/saved"] = idx.search(q, 10)
    ans[f"{dtype}/orbax"] = back.search(q, 10)
    # JAX's layout on the ranks
    jx = mk(dtype, nlist=16)
    assert jx.load(os.path.join(out, f"jax_{dtype}"))
    put(f"{dtype}/jax", ivf_steps(jx, np.random.default_rng(1)))

# tests/test_parallel.py::TestShardedIVF on the global mesh (float32)
vecs_rng = np.random.default_rng(2)


def built(n=2048, nlist=16, nprobe=4):
    idx = mk(nlist=nlist, nprobe=nprobe)
    x = vecs_rng.standard_normal((n, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    slots = idx.add_batch(x)
    idx.build()
    return idx, x, slots


idx, vecs, slots = built()
facts["tables"] = {
    "held": [s for s, t in enumerate(idx._bucket_rows) if t is not None],
    "shapes": sorted({tuple(t.shape) for t in idx._bucket_rows
                      if t is not None}),
    "nlist": int(idx._centroids.shape[0]),
}
idx.batch_flat_fallback = False
idx.nprobe = 16
_, got = idx.search(vecs[:32], k=1)
facts["self_query"] = bool((got[:, 0] == slots[:32]).all())
idx.nprobe = 4
facts["tune"] = [idx.tune(vecs[100:164], k=10, target_recall=0.9),
                 idx.nprobe]
late = vecs_rng.standard_normal((5, 32)).astype(np.float32)
late /= np.linalg.norm(late, axis=-1, keepdims=True)
late_slots = idx.add_batch(late)
_, got = idx.search(late, k=1)
facts["fresh"] = bool((got[:, 0] == late_slots).all())
idx.nprobe = 16
idx.remove_slots(slots[:4])
_, got = idx.search(vecs[:4], k=5)
facts["deleted"] = [int(slots[i]) in got[i].tolist() for i in range(4)]
facts["len"] = [idx.count(), idx.valid_count(), idx.get_stats()["size"]]
mask = np.zeros(idx.capacity, bool)
allowed = slots[::3]
mask[allowed] = True
_, got = idx.search(vecs[:8], k=5, slot_mask=mask)
facts["exact_filter"] = all(s < 0 or int(s) in set(allowed.tolist())
                            for s in got.ravel())
idx, vecs, slots = built(n=4096, nlist=32, nprobe=32)
idx.batch_flat_fallback = False
_, got = idx.search(vecs[:64], k=10)
facts["owners"] = sorted({int(s) % idx.n_devices for s in got.ravel()
                          if s >= 0})
idx, vecs, slots = built(n=4096, nlist=16, nprobe=4)
idx.batch_flat_fallback = False
called = []
orig = ShardedFlatIndex._enqueue


def spy(self_, q, k, plan):
    called.append(1)
    return orig(self_, q, k, plan)


ShardedFlatIndex._enqueue = spy
mask = np.zeros(idx.capacity, bool)
allowed = slots[:len(slots) // 2]
mask[allowed] = True
q = vecs[:8]
_, got = idx.search(q, k=10, slot_mask=mask)
pushed = not called
live = [int(s) for row in got for s in row if s >= 0]
exact = allowed[np.argsort(-(q @ vecs[allowed].T), axis=-1)[:, :10]]
recall = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                        for a, b in zip(got, exact)]))
sparse = np.zeros(idx.capacity, bool)
sparse[slots[:40]] = True
idx.search(q, k=5, slot_mask=sparse)
ShardedFlatIndex._enqueue = orig
facts["pushdown"] = [pushed, bool(live) and set(live) <= set(
    allowed.tolist()), recall, bool(called)]
from wdbx_tpu_torch.core.config import WDBXConfig
from wdbx_tpu_torch.index import create_index
fx = create_index("sharded_ivf", 16, WDBXConfig({"IVF_NLIST": 8}),
                  device="cpu")
facts["factory"] = [fx.kind, fx.nlist, fx.mesh.is_global]

# the facade: joins before its store, builds past the threshold
from wdbx_tpu_torch.core.wdbx import WDBX
db = WDBX(vector_dimension=16, num_shards=1, device="cpu",
          data_dir=os.path.join(out, f"db{rank}"), enable_plugins=False,
          enable_distributed=True,
          config={"INDEX_TYPE": "sharded_ivf", "IVF_NLIST": 8,
                  "IVF_NPROBE": 8, "IVF_TRAIN_THRESHOLD": 64})
asyncio.run(db.initialize())
ix = db.store.indices[0]
assert isinstance(ix, ShardedIVFIndex) and ix.mesh.is_global
fv = np.random.default_rng(3).standard_normal((200, 16)).astype(np.float32)
db.batch_store({f"v{i}": v for i, v in enumerate(fv)})
hits = db.vector_search(fv[7], limit=3)
facts["facade"] = [ix.is_trained, db.count_vectors(), hits[0][0]]
ans["facade"] = (np.asarray([[h[1] for h in hits]], np.float32),
                 np.asarray([[int(h[0][1:]) for h in hits]]))
no_jax()
with open(os.path.join(out, f"facts{rank}.json"), "w") as f:
    json.dump(facts, f)
np.savez(os.path.join(out, f"ans{rank}_{world}.npz"),
         **{f"{key}|{i}": np.asarray(v) for key, pair in ans.items()
            for i, v in enumerate(pair)})
print(f"proc{rank} IVF OK", flush=True)
"""

STEPS_NS: dict = {}
exec(STEPS, STEPS_NS)


@pytest.fixture(scope="module")
def ivf_ranks(tmp_path_factory):
    """The one 2-rank run, after JAX wrote a checkpoint of each dtype."""
    tmp = tmp_path_factory.mktemp("ivf_ranks")
    for dtype in DTYPES:
        j = JIndex(dim=32, dtype=dtype, nlist=16, nprobe=4,
                   train_threshold=256)
        j.add_batch(np.random.default_rng(4).standard_normal(
            (2048, 32)).astype(np.float32))
        j.build()
        j.save(str(tmp / f"jax_{dtype}"))
    _assert_ok(_run_ranks(IVF_WORKER, tmp, 2), "IVF OK")
    facts = [json.loads((tmp / f"facts{r}.json").read_text())
             for r in range(2)]
    return tmp, _answers(tmp, 2), facts


def _single(dtype, **kw):
    return ShardedIVFIndex(32, dtype=dtype, train_threshold=256,
                           mesh=make_mesh(8, device="cpu"), **kw)


class TestShardedIVF:
    def test_build_shards_tables(self, ivf_ranks):
        _, _, facts = ivf_ranks
        for rank, f in enumerate(facts):
            t = f["tables"]
            assert t["held"] == list(range(4 * rank, 4 * rank + 4)), t
            assert len(t["shapes"]) == 1 and t["nlist"] % 8 == 0, t
            assert t["shapes"][0][0] * 8 == t["nlist"], t

    def test_self_query_and_recall(self, ivf_ranks):
        _, _, facts = ivf_ranks
        assert facts[0]["self_query"] and facts[1]["self_query"]
        assert facts[0]["tune"] == facts[1]["tune"]
        assert facts[0]["tune"][0] >= 0.9, facts[0]["tune"]

    def test_fresh_adds_visible(self, ivf_ranks):
        _, _, facts = ivf_ranks
        assert facts[0]["fresh"] and facts[1]["fresh"]

    def test_delete_after_build_invisible(self, ivf_ranks):
        _, _, facts = ivf_ranks
        for f in facts:
            assert f["deleted"] == [False] * 4
            # len, valid_count and the stats agree on every rank
            assert f["len"] == [2048 + 5 - 4] * 3, f["len"]

    def test_candidates_span_devices(self, ivf_ranks):
        _, _, facts = ivf_ranks
        assert facts[0]["owners"] == facts[1]["owners"] == list(range(8))

    def test_masked_search_falls_to_exact(self, ivf_ranks):
        _, _, facts = ivf_ranks
        assert facts[0]["exact_filter"] and facts[1]["exact_filter"]

    def test_masked_search_pushdown_above_threshold(self, ivf_ranks):
        _, _, facts = ivf_ranks
        for f in facts:
            pushed, inside, recall, sparse_exact = f["pushdown"]
            assert pushed, "50% filter must use bucket pushdown"
            assert inside and recall >= 0.8 and sparse_exact, f["pushdown"]

    def test_factory(self, ivf_ranks):
        _, _, facts = ivf_ranks
        assert facts[0]["factory"] == facts[1]["factory"] == [
            "sharded_ivf", 8, True]


def test_ranks_answer_alike(ivf_ranks):
    _, (r0, r1), facts = ivf_ranks
    assert r0.keys() == r1.keys()
    for key in r0:
        _same(r0[key], r1[key], 0.0)
    # the build moved the rows bound for the other rank's buckets
    for dtype in DTYPES:
        assert facts[0][f"{dtype}/moved"] > 0
        assert facts[0][f"{dtype}/len"] == facts[1][f"{dtype}/len"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_own_build_matches_single_process(ivf_ranks, dtype):
    """Every route of the ranks' own build against the single-process
    8-position port fed the same calls."""
    _, (r0, _), facts = ivf_ranks
    single = _single(dtype, nlist=16, nprobe=4)
    ref = STEPS_NS["own_build"](single)
    assert len(ref) == 11
    for key, pair in ref.items():
        _same(pair, r0[f"{dtype}/own/{key}"], 1e-6)
    assert facts[0][f"{dtype}/len"] == [single.count(), single.valid_count()]


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_layout_matches_jax_and_single_process(ivf_ranks, dtype):
    """JAX's checkpoint on the ranks: every route against JAX's index
    and against the single-process port on the same checkpoint."""
    tmp, (r0, _), _ = ivf_ranks
    single = _single(dtype, nlist=16)
    assert single.load(str(tmp / f"jax_{dtype}"))
    ref = STEPS_NS["ivf_steps"](single, np.random.default_rng(1))
    for key, pair in ref.items():
        _same(pair, r0[f"{dtype}/jax/{key}"], 1e-6)
    j = JIndex(dim=32, dtype=dtype, nlist=16)
    assert j.load(str(tmp / f"jax_{dtype}"))
    jref = STEPS_NS["ivf_steps"](j, np.random.default_rng(1))
    for key, pair in jref.items():
        assert_topk_match(*pair, *r0[f"{dtype}/jax/{key}"], TOL[dtype])
    if dtype == "float32":  # the probes JAX's quota drops
        for key in ("overflow", "overflow_pipe"):
            np.testing.assert_array_equal(
                np.sort(jref[key][1], -1),
                np.sort(r0[f"{dtype}/jax/{key}"][1], -1))


@pytest.mark.parametrize("dtype", DTYPES)
def test_ranks_npz_loads_in_one_process_and_jax(ivf_ranks, dtype):
    """The ranks' ``.ivf.npz`` (tables gathered on rank 0) loads into
    the single-process port and into JAX, the same answers."""
    tmp, (r0, _), _ = ivf_ranks
    path = str(tmp / f"ranks_{dtype}")
    q = np.random.default_rng(5).standard_normal((12, 32)).astype(np.float32)
    single = _single(dtype, nlist=16)
    assert single.load(path) and single.is_trained
    single.batch_flat_fallback = False
    _same(single.search(q, 10), r0[f"{dtype}/saved"], 1e-6)
    j = JIndex(dim=32, dtype=dtype, nlist=16)
    assert j.load(path) and j.is_trained
    j.batch_flat_fallback = False
    assert_topk_match(*j.search(q, 10), *r0[f"{dtype}/saved"], TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_per_position_round_trip(ivf_ranks, dtype):
    """Each rank wrote its own shards' files, bucket rows included; the
    ranks and the single-process port load them back."""
    tmp, (r0, _), _ = ivf_ranks
    path = tmp / f"orbax_{dtype}"
    files = sorted(p.name for p in (tmp / f"orbax_{dtype}.orbax").iterdir())
    assert files == [f"position{p:05d}.pt" for p in range(8)] + [
        "wdbx_positions.json"], files
    with np.load(str(path) + ".ivf.npz") as f:
        assert "bucket_rows" not in f.files and "bucket_slot" in f.files
    _same(r0[f"{dtype}/saved"], r0[f"{dtype}/orbax"], 0.0)
    single = _single(dtype, nlist=16)
    single.persist_backend = "orbax"
    assert single.load(str(path)) and single.is_trained
    single.batch_flat_fallback = False
    q = np.random.default_rng(5).standard_normal((12, 32)).astype(np.float32)
    _same(single.search(q, 10), r0[f"{dtype}/saved"], 1e-6)


def test_facade(ivf_ranks):
    """``WDBX(enable_distributed=True, INDEX_TYPE="sharded_ivf")``."""
    _, (r0, r1), facts = ivf_ranks
    assert facts[0]["facade"] == facts[1]["facade"] == [True, 200, "v7"]
    _same(r0["facade"], r1["facade"], 0.0)
