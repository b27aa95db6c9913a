"""Replica groups on a global mesh: ``make_mesh2(r)`` over gloo ranks on
the CPU, each replica group within one rank
(``tests/test_torch_multihost.py``'s runner and prelude).

2 ranks x 4 positions: ``make_mesh2(2)`` (one copy of 4 shards a rank)
and ``make_mesh2(4)`` (two copies of 2 shards a rank). ``flat_steps``
runs on ``ShardedFlatIndex`` for every slab type (float32, bf16, int8,
int4), with a capacity that grows: B=8, B=1 and B=3 searches (ranks
that hold no slice still join the answers' gather), pipelined stacks
(B=8, and B=1) and an in-flight handle, a filter, then removals,
updates and adds that must reach every copy; ``clustered_steps`` on
``ShardedClusteredIndex``: the build (rank 0 trains), probes 8 and 2,
fresh rows, the exact masked route, the ranges route at B=2, pipelined,
B=1. The parent holds every answer against the single-process port on
the same ``(replicas, shards)`` mesh (slots equal, scores within 1e-6)
and against JAX's replicated ``search`` on conftest's 8 CPU devices
(JAX's replicated ``search_pipelined`` raises; the clustered index at
full probe, where both scans are exact). Every rank reports the same
``count``, ``valid_count`` and stats, and reads its own copy back. npz
checkpoints move between replica counts and the unreplicated mesh, and
per-position ones load on the same shard count in one process. The
facade with ``MESH_REPLICAS=2`` serves on the replicated global mesh.

4 ranks x 2 positions: ``make_mesh2(2)`` lays groups of 4 shards, each
spanning two ranks (once refused): its layout, and the flat steps of a
``replicas=2`` index on it as the single process on
``make_mesh2(2, 4)`` (the other such layouts:
``tests/test_torch_multihost_spanning.py``); ``make_mesh2(4)`` (one
group of 2 shards a rank) serves the flat steps as the single process
does.
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
from wdbx_tpu.parallel import ShardedClusteredIndex as JClustered
from wdbx_tpu.parallel import ShardedFlatIndex as JFlat
from wdbx_tpu_torch.parallel import (
    ShardedClusteredIndex,
    ShardedFlatIndex,
    make_mesh,
    make_mesh2,
)

FLAT_DTYPES = ["float32", "bfloat16", "int8", "int4"]

#: what the ranks, the single-process port and JAX run alike
STEPS = r"""
import numpy as np


def flat_steps(idx, pipelined=True):
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((200, 16)).astype(np.float32)
    slots = idx.add_batch(vecs)
    out = {"b8": idx.search(vecs[:8], 3), "b1": idx.search(vecs[5:6], 3),
           "b3": idx.search(vecs[10:13], 3),
           "masked": idx.search(vecs[:8], 5, slot_mask=np.arange(
               idx.capacity) % 3 == 0)}
    if pipelined:
        out["pipe"] = idx.search_pipelined(vecs[:24].reshape(3, 8, 16), 4)
        out["pipe1"] = idx.search_pipelined(vecs[:3].reshape(3, 1, 16), 4)
        out["handle"] = idx.resolve_pipelined(idx.search_pipelined(
            vecs[:16].reshape(2, 8, 16), 4, materialize=False))
    idx.remove_slots(slots[:4])
    idx.update_slots(slots[10:13],
                     rng.standard_normal((3, 16)).astype(np.float32))
    idx.add_batch(rng.standard_normal((100, 16)).astype(np.float32))
    out["after"] = idx.search(vecs[:16], 3)
    return out


def clustered_steps(idx, full_only=False):
    rng = np.random.default_rng(1)
    cv = rng.standard_normal((600, 16)).astype(np.float32)
    cv /= np.linalg.norm(cv, axis=-1, keepdims=True)
    idx.batch_flat_fallback = False
    idx.add_batch(cv)
    idx.build()
    out = {"c8": idx.search(cv[:8], 3)}
    if full_only:
        return out
    idx.nprobe = 2
    out["np2"] = idx.search(cv[8:24], 5)
    out["c1"] = idx.search(cv[30:31], 5)
    idx.add_batch(cv[:5] * -1.0)
    out["fresh"] = idx.search(cv[24:40], 5)
    mask = np.zeros(605, bool)
    mask[::50] = True
    out["masked"] = idx.search(cv[:8], 3, slot_mask=mask)
    idx.latency_path = "ranges"
    out["ranges"] = idx.search(cv[8:10], 5)
    idx.latency_path = "auto"
    out["pipe"] = idx.search_pipelined(cv[40:56].reshape(2, 8, 16), 5)
    return out
"""

REPLICA_WORKER = PRELUDE + STEPS + r"""
asyncio.run(engine.initialize())
from wdbx_tpu_torch.parallel import (
    ShardedClusteredIndex, ShardedFlatIndex, make_mesh, make_mesh2)
DTYPES = ["float32", "bfloat16", "int8", "int4"]
ans, facts = {}, {}


def copies_agree(idx):
    # every copy this rank holds equals the one its host reads take
    n = idx.n_devices
    for p in idx.mesh.local_positions:
        ref = idx._read_pos(p % n)
        for ts in (idx._slabs, idx._valids, idx._row_scales):
            if ts[p] is not None and not torch.equal(ts[p], ts[ref]):
                return False
    return True


def record(name, idx, got):
    ans.update({f"{name}/{key}": pair for key, pair in got.items()})
    st = idx.get_stats()
    facts[name] = {"count": idx.count(), "valid": idx.valid_count(),
                   "stats": [st["size"], st["replicas"], st["devices"],
                             st["tombstones"], st["hbm_bytes"]],
                   "copies": copies_agree(idx),
                   "groups": list(idx.mesh.local_groups)}


for r in (2, 4):
    mesh = make_mesh2(r, device="cpu")
    assert mesh.shape == {"replica": r, "shard": 8 // r}, mesh.shape
    assert mesh.local_groups == tuple(range(rank * r // 2,
                                            (rank + 1) * r // 2))
    for dtype in DTYPES:
        idx = ShardedFlatIndex(dim=16, capacity=64, dtype=dtype, mesh=mesh)
        name = f"r{r}/{dtype}"
        record(name, idx, flat_steps(idx))
        ans[f"{name}/vectors"] = (idx.get_vectors(np.arange(8, 16)),
                                  np.arange(8, 16))
        if r != 2 or dtype not in ("float32", "int8"):
            continue
        # checkpoints: npz across replica counts, per-position on 4 shards
        idx.save(os.path.join(out, f"npz_{dtype}"))
        q = np.random.default_rng(7).standard_normal((8, 16)).astype(
            np.float32)
        ans[f"{dtype}/saved"] = idx.search(q, 3)
        for other, m in (("r4", make_mesh2(4, device="cpu")),
                         ("r1", make_mesh(device="cpu"))):
            back = ShardedFlatIndex(dim=16, dtype=dtype, mesh=m)
            assert back.load(os.path.join(out, f"npz_{dtype}"))
            ans[f"{dtype}/npz_{other}"] = back.search(q, 3)
            assert back.count() == idx.count()
        idx.persist_backend = "orbax"
        idx.save(os.path.join(out, f"pp_{dtype}"))
        back = ShardedFlatIndex(dim=16, dtype=dtype, mesh=mesh)
        back.persist_backend = "orbax"
        assert back.load(os.path.join(out, f"pp_{dtype}"))
        ans[f"{dtype}/pp"] = back.search(q, 3)
        facts[f"{dtype}/pp_copies"] = copies_agree(back)
    for dtype in ("float32", "int8"):
        c = ShardedClusteredIndex(dim=16, nlist=8, nprobe=8,
                                  train_threshold=64, dtype=dtype, mesh=mesh)
        name = f"r{r}/clu_{dtype}"
        record(name, c, clustered_steps(c))
        if r == 2 and dtype == "int8":
            c.save(os.path.join(out, "clu"))
            back = ShardedClusteredIndex(dim=16, nlist=8, nprobe=2,
                                         train_threshold=64, dtype=dtype,
                                         mesh=make_mesh2(4, device="cpu"))
            back.batch_flat_fallback = False
            assert back.load(os.path.join(out, "clu"))
            ans["clu_r4"] = back.search(
                np.random.default_rng(7).standard_normal((8, 16)).astype(
                    np.float32), 5)
# the facade: MESH_REPLICAS=2 on the global mesh, two store shards
from wdbx_tpu_torch.core.wdbx import WDBX
db = WDBX(vector_dimension=16, num_shards=2, device="cpu",
          data_dir=os.path.join(out, f"db{rank}"), enable_plugins=False,
          enable_distributed=True,
          config={"INDEX_TYPE": "sharded_flat", "MESH_REPLICAS": 2})
asyncio.run(db.initialize())
assert all(ix.mesh.is_global and ix.replicas == 2 for ix in db.store.indices)
fv = np.random.default_rng(3).standard_normal((40, 16)).astype(np.float32)
db.batch_store({f"v{i}": v for i, v in enumerate(fv)})
hits = db.vector_search_batch(fv[:3], limit=2)
facts["facade"] = [db.count_vectors(), [h[0][0] for h in hits]]
no_jax()
with open(os.path.join(out, f"facts{rank}.json"), "w") as f:
    json.dump(facts, f)
np.savez(os.path.join(out, f"ans{rank}_{world}.npz"),
         **{f"{key}|{i}": np.asarray(v) for key, pair in ans.items()
            for i, v in enumerate(pair)})
print(f"proc{rank} REPLICAS OK", flush=True)
"""

SPAN_WORKER = PRELUDE + STEPS + r"""
asyncio.run(engine.initialize())
from wdbx_tpu_torch.parallel import ShardedFlatIndex, make_mesh2
# groups of 4 shards over ranks of 2 positions: each spans two ranks
m2 = make_mesh2(2, device="cpu")
facts = {"mesh": [m2.shape, list(m2.owners), list(m2.local_groups)]}
span = ShardedFlatIndex(dim=16, capacity=64, replicas=2, device="cpu")
facts["index"] = [span.replicas, span.n_devices, list(span.mesh.owners)]
got = {f"span/{key}": pair for key, pair in flat_steps(span).items()}
mesh = make_mesh2(4, device="cpu")  # one group of 2 shards a rank
assert mesh.local_groups == (rank,), mesh.local_groups
idx = ShardedFlatIndex(dim=16, capacity=64, mesh=mesh)
got.update(flat_steps(idx))
no_jax()
with open(os.path.join(out, f"facts{rank}.json"), "w") as f:
    json.dump(facts, f)
np.savez(os.path.join(out, f"ans{rank}_{world}.npz"),
         **{f"{key}|{i}": np.asarray(v) for key, pair in got.items()
            for i, v in enumerate(pair)})
print(f"proc{rank} SPAN OK", flush=True)
"""

STEPS_NS: dict = {}
exec(STEPS, STEPS_NS)


def _facts(tmp, world):
    return [json.loads((tmp / f"facts{r}.json").read_text())
            for r in range(world)]


@pytest.fixture(scope="module")
def replica_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("replica_ranks")
    _assert_ok(_run_ranks(REPLICA_WORKER, tmp, 2), "REPLICAS OK")
    return tmp, _answers(tmp, 2), _facts(tmp, 2)


def _mesh2(r):
    return make_mesh2(r, shards=8 // r, device="cpu")


def test_ranks_answer_alike_and_agree_on_counts(replica_ranks):
    """Both ranks return every row of every answer, hold identical
    copies in every group, and report the same counts and stats."""
    _, (r0, r1), (f0, f1) = replica_ranks
    assert r0.keys() == r1.keys()
    for key in r0:
        _same(r0[key], r1[key], 0.0)
    for name in f0:
        if name == "facade":
            continue
        if isinstance(f0[name], dict):
            a, b = dict(f0[name]), dict(f1[name])
            assert a.pop("copies") and b.pop("copies"), name
            ga, gb = a.pop("groups"), b.pop("groups")
            assert len(ga) == len(gb) and set(ga).isdisjoint(gb), name
            assert a == b, (name, a, b)
        else:
            assert f0[name] is True and f1[name] is True, name


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("dtype", FLAT_DTYPES)
def test_flat_matches_single_process(replica_ranks, r, dtype):
    """The ranks' replicated flat answers against the single-process
    port on the same ``(replicas, shards)`` mesh."""
    _, (r0, _), (f0, _) = replica_ranks
    single = ShardedFlatIndex(16, capacity=64, dtype=dtype, mesh=_mesh2(r))
    ref = STEPS_NS["flat_steps"](single)
    assert len(ref) == 8
    for key, pair in ref.items():
        _same(pair, r0[f"r{r}/{dtype}/{key}"], 1e-6)
    np.testing.assert_array_equal(
        r0[f"r{r}/{dtype}/vectors"][0],
        single.get_vectors(np.arange(8, 16)))
    stats = single.get_stats()
    assert f0[f"r{r}/{dtype}"]["count"] == single.count()
    assert f0[f"r{r}/{dtype}"]["valid"] == single.valid_count()
    assert f0[f"r{r}/{dtype}"]["stats"][:4] == [
        stats["size"], stats["replicas"], stats["devices"],
        stats["tombstones"]]


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("dtype", FLAT_DTYPES)
def test_flat_matches_jax(replica_ranks, r, dtype):
    """Against JAX's replicated ``ShardedFlatIndex.search``."""
    _, (r0, _), _ = replica_ranks
    j = JFlat(dim=16, capacity=64, dtype=dtype, replicas=r)
    ref = STEPS_NS["flat_steps"](j, pipelined=False)
    for key, pair in ref.items():
        assert_topk_match(*pair, *r0[f"r{r}/{dtype}/{key}"], TOL[dtype])


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_clustered_matches_single_process_and_jax(replica_ranks, r, dtype):
    """The replicated sharded clustered index: every route against the
    single-process port (rank 0 trains on its sample), the full-probe
    answer against JAX's."""
    _, (r0, _), (f0, _) = replica_ranks
    single = ShardedClusteredIndex(16, nlist=8, nprobe=8, train_threshold=64,
                                   dtype=dtype, mesh=_mesh2(r))
    ref = STEPS_NS["clustered_steps"](single)
    assert len(ref) == 7
    for key, pair in ref.items():
        _same(pair, r0[f"r{r}/clu_{dtype}/{key}"], 1e-6)
    assert f0[f"r{r}/clu_{dtype}"]["count"] == single.count()
    j = JClustered(dim=16, nlist=8, nprobe=8, train_threshold=64,
                   dtype=dtype, replicas=r)
    got = STEPS_NS["clustered_steps"](j, full_only=True)["c8"]
    assert_topk_match(*got, *r0[f"r{r}/clu_{dtype}/c8"], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_npz_across_replica_counts(replica_ranks, dtype):
    """The 2-group ranks' npz loads on the ranks as 4 groups and as the
    unreplicated global mesh, and into one process on 8 shards."""
    tmp, (r0, _), _ = replica_ranks
    saved = r0[f"{dtype}/saved"]
    for other in ("r4", "r1"):
        _same(saved, r0[f"{dtype}/npz_{other}"], 1e-6)
    single = ShardedFlatIndex(16, dtype=dtype, mesh=make_mesh(8, device="cpu"))
    assert single.load(str(tmp / f"npz_{dtype}"))
    q = np.random.default_rng(7).standard_normal((8, 16)).astype(np.float32)
    _same(single.search(q, 3), saved, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_per_position_round_trip(replica_ranks, dtype):
    """Rank 0 wrote the first group's 4 files; every rank read all 4
    into its copy; one process loads them unreplicated and as 2 x 4."""
    tmp, (r0, _), (f0, f1) = replica_ranks
    files = sorted(p.name for p in (tmp / f"pp_{dtype}.orbax").iterdir())
    assert files == [f"position{p:05d}.pt" for p in range(4)] + [
        "wdbx_positions.json"], files
    _same(r0[f"{dtype}/saved"], r0[f"{dtype}/pp"], 0.0)
    assert f0[f"{dtype}/pp_copies"] and f1[f"{dtype}/pp_copies"]
    q = np.random.default_rng(7).standard_normal((8, 16)).astype(np.float32)
    for mesh in (make_mesh(4, device="cpu"), _mesh2(2)):
        single = ShardedFlatIndex(16, dtype=dtype, mesh=mesh)
        single.persist_backend = "orbax"
        assert single.load(str(tmp / f"pp_{dtype}"))
        _same(single.search(q, 3), r0[f"{dtype}/saved"], 1e-6)


def test_clustered_checkpoint_across_replica_counts(replica_ranks):
    """The 2-group clustered checkpoint (``.ivfsc``) loads on the ranks
    as 4 groups and answers as one process loading it does."""
    tmp, (r0, _), _ = replica_ranks
    single = ShardedClusteredIndex(16, nlist=8, nprobe=2, train_threshold=64,
                                   dtype="int8", mesh=_mesh2(4))
    single.batch_flat_fallback = False
    assert single.load(str(tmp / "clu"))
    q = np.random.default_rng(7).standard_normal((8, 16)).astype(np.float32)
    _same(single.search(q, 5), r0["clu_r4"], 1e-6)


def test_facade_with_mesh_replicas(replica_ranks):
    """``WDBX(enable_distributed=True)`` with ``MESH_REPLICAS=2``: its
    indexes lie on the replicated global mesh, and both ranks find each
    query's own row."""
    _, _, (f0, f1) = replica_ranks
    assert f0["facade"] == f1["facade"] == [40, ["v0", "v1", "v2"]]


@pytest.fixture(scope="module")
def span_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("span_ranks")
    _assert_ok(_run_ranks(SPAN_WORKER, tmp, 4), "SPAN OK")
    return tmp, _answers(tmp, 4), _facts(tmp, 4)


@pytest.mark.parametrize("name", ["mesh", "index"])
def test_group_spanning_ranks_refused(span_ranks, name):
    """Groups spanning ranks, once refused: every rank lays
    ``make_mesh2(2)`` as JAX lays ``jax.devices()`` (group 0 on ranks
    0-1, group 1 on ranks 2-3), and a ``replicas=2`` index on it answers
    on every rank as the single process on ``make_mesh2(2, 4)``."""
    _, ranks, facts = span_ranks
    owners = [0, 0, 1, 1, 2, 2, 3, 3]
    for rank, f in enumerate(facts):
        want = ([{"replica": 2, "shard": 4}, owners, [rank // 2]]
                if name == "mesh" else [2, 4, owners])
        assert f[name] == want, (rank, f[name])
    if name == "index":
        single = ShardedFlatIndex(16, capacity=64, mesh=_mesh2(2))
        ref = STEPS_NS["flat_steps"](single)
        for got in ranks:
            for key, pair in ref.items():
                _same(pair, got[f"span/{key}"], 1e-6)


def test_four_ranks_one_group_each(span_ranks):
    """4 ranks x 2 positions as 4 groups of 2 shards: the single
    process's answers on the same mesh."""
    _, ranks, _ = span_ranks
    single = ShardedFlatIndex(16, capacity=64, mesh=_mesh2(4))
    ref = STEPS_NS["flat_steps"](single)
    for got in ranks:
        for key, pair in ref.items():
            _same(pair, got[key], 1e-6)
