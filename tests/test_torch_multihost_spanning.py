"""Replica groups spanning ranks and ranks without a position on the
port's global mesh: gloo worker processes on the CPU
(``tests/test_torch_multihost.py``'s runner and prelude). The layouts are
JAX's: ``make_mesh2(r, s)`` lays ``jax.devices()[:r*s]`` row-major
whoever owns them, and ``make_mesh(n)`` takes the first n devices.

Three runs; the tests read their records:

* 4 ranks x 2 positions. ``span``: ``make_mesh2(2)``, group 0 on ranks
  0-1 and group 1 on ranks 2-3; ``half``: ``make_mesh2(2, 2)``, ranks 2-3
  without a position; ``three``: ``make_mesh(3)``, rank 3 without one.
  On each, ``flat_steps`` of ``tests/test_torch_multihost_replicas.py``
  for float32, int8 and int4 slabs (B=8, B=1, B=3, a filter, pipelined
  stacks and an in-flight handle, removals, updates and adds) and the
  sharded clustered steps, with the gloo calls of one search counted;
  on ``span`` also the clustered steps on int8, npz checkpoints loaded on
  the other layouts and on the unreplicated mesh, per-position files
  read by every rank holding a copy, a remesh to ``three`` and back, and
  ``build_background`` in a thread beside the foreground; the sharded IVF
  engine on ``three`` (remeshed to the 8 positions and back); the
  facade with ``MESH_REPLICAS=2`` for the flat and clustered engines.
* 3 ranks x 2 positions: ``make_mesh2(2, 3)``, where rank 1 holds shard
  2 of group 0 and shard 0 of group 1; the flat steps (every dtype), the
  clustered steps and an npz checkpoint.
* 2 ranks x 4 positions: ``WDBX.heal(allow_remesh=True)`` with every
  position of rank 1 failing its probe (a fault injected into rank 1's
  probe) re-stripes onto rank 0 alone, rank 1 left without a position;
  once the probe passes again, ``heal`` re-stripes back onto the 8.

The parent holds every answer against the single-process port on the
same layout (``make_mesh2(r, s, device="cpu")``, ``make_mesh(n,
device="cpu")``: slots equal, scores within 1e-6) and against the JAX
package's sharded engines on conftest's 8 CPU devices on the same
layout (slot sets equal except at ties, scores within the suite's
``TOL``; the clustered index at full probe, where both scans are exact).
Every rank returns the same answers, counts and heal reports.
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
from test_torch_multihost_recovery import STEPS as RECOVERY_STEPS
from test_torch_multihost_recovery import STEPS_NS as RECOVERY_NS
from test_torch_multihost_replicas import STEPS, STEPS_NS
from test_torch_ops import TOL, assert_topk_match
from wdbx_tpu.parallel import ShardedClusteredIndex as JClustered
from wdbx_tpu.parallel import ShardedFlatIndex as JFlat
from wdbx_tpu.parallel import make_mesh as jmesh
from wdbx_tpu.parallel import make_mesh2 as jmesh2
from wdbx_tpu.parallel.sharded_ivf import ShardedIVFIndex as JIVF
from wdbx_tpu_torch.parallel import (
    ShardedClusteredIndex,
    ShardedFlatIndex,
    ShardedIVFIndex,
    make_mesh,
    make_mesh2,
)

DTYPES = ["float32", "int8", "int4"]
#: each layout of the runs: (replicas, shards) of ``make_mesh2``, or
#: (None, n) of ``make_mesh(n)``
LAYOUTS = {"span": (2, 4), "half": (2, 2), "three": (None, 3),
           "both": (2, 3)}
#: the owners of each layout's positions
OWNERS = {"span": [0, 0, 1, 1, 2, 2, 3, 3], "half": [0, 0, 1, 1],
          "three": [0, 1, 2], "both": [0, 0, 1, 1, 2, 2]}

WORKER = PRELUDE + STEPS + "RSTEPS = {}\nexec(" + repr(RECOVERY_STEPS) + \
    ", RSTEPS)\n" + r"""
asyncio.run(engine.initialize())
import threading
import time
from wdbx_tpu_torch.parallel import (
    ShardedClusteredIndex, ShardedFlatIndex, ShardedIVFIndex, collective,
    make_mesh, make_mesh2)
ans, facts = {}, {}
if world == 4:
    meshes = {"span": make_mesh2(2, device="cpu"),
              "half": make_mesh2(2, 2, device="cpu"),
              "three": make_mesh(3, device="cpu")}
else:
    meshes = {"both": make_mesh2(2, 3, device="cpu")}
facts["meshes"] = {name: [m.shape, list(m.owners), list(m.local_positions),
                          list(m.local_groups), m.world]
                   for name, m in meshes.items()}
Q = np.random.default_rng(7).standard_normal((8, 16)).astype(np.float32)


def one_call(run):
    # the collectives of one call, by kind
    before = collective.stats()
    run()
    after = collective.stats()
    return {kind: s["calls"] - before.get(kind, {}).get("calls", 0)
            for kind, s in after.items()
            if s["calls"] != before.get(kind, {}).get("calls", 0)}


def record(name, idx, got):
    ans.update({f"{name}/{key}": pair for key, pair in got.items()})
    st = idx.get_stats()
    facts[name] = {"count": idx.count(), "valid": idx.valid_count(),
                   "stats": [st["size"], st["replicas"], st["devices"],
                             st["tombstones"]],
                   "device": str(idx.device)}


for name, mesh in meshes.items():
    for dtype in ["float32", "int8", "int4"]:
        idx = ShardedFlatIndex(dim=16, capacity=64, dtype=dtype, mesh=mesh,
                               device="cpu")
        record(f"{name}/{dtype}", idx, flat_steps(idx))
        ans[f"{name}/{dtype}/vectors"] = (idx.get_vectors(np.arange(8, 16)),
                                          np.arange(8, 16))
        facts[f"{name}/{dtype}"]["calls"] = {
            "b8": one_call(lambda: idx.search(Q, 3)),
            "b1": one_call(lambda: idx.search(Q[:1], 3)),
            "pipe": one_call(lambda: idx.search_pipelined(
                Q.reshape(2, 4, 16), 3))}
        if dtype == "int4" or name not in ("span", "both"):
            continue
        # checkpoints: the npz on the other layouts, the per-position
        # files back onto this one
        idx.save(os.path.join(out, f"npz_{name}_{dtype}"))
        ans[f"{name}/{dtype}/saved"] = idx.search(Q, 3)
        for other, m in meshes.items():
            back = ShardedFlatIndex(dim=16, dtype=dtype, mesh=m,
                                    device="cpu")
            assert back.load(os.path.join(out, f"npz_{name}_{dtype}"))
            assert back.count() == idx.count()
            ans[f"{name}/{dtype}/npz_{other}"] = back.search(Q, 3)
        if name == "span":
            back = ShardedFlatIndex(dim=16, dtype=dtype,
                                    mesh=make_mesh(device="cpu"))
            assert back.load(os.path.join(out, f"npz_{name}_{dtype}"))
            ans[f"{name}/{dtype}/npz_r1"] = back.search(Q, 3)
        idx.persist_backend = "orbax"
        idx.save(os.path.join(out, f"pp_{name}_{dtype}"))
        back = ShardedFlatIndex(dim=16, dtype=dtype, mesh=mesh, device="cpu")
        back.persist_backend = "orbax"
        assert back.load(os.path.join(out, f"pp_{name}_{dtype}"))
        ans[f"{name}/{dtype}/pp"] = back.search(Q, 3)
        if name == "span" and dtype == "float32":
            # the degraded mesh of a replicated one: the replica axis
            # collapses; group 0's rows move, from whichever ranks
            idx.remesh(meshes["three"])
            ans["remesh/three"] = idx.search(Q, 5)
            facts["remesh_three"] = idx.last_remesh
            idx.remesh(mesh)
            ans["remesh/back"] = idx.search(Q, 5)
    clu = ["float32", "int8"] if name == "span" else ["float32"]
    for dtype in clu:
        c = ShardedClusteredIndex(dim=16, nlist=8, nprobe=8,
                                  train_threshold=64, dtype=dtype, mesh=mesh,
                                  device="cpu")
        record(f"{name}/clu_{dtype}", c, clustered_steps(c))
        facts[f"{name}/clu_{dtype}"]["calls"] = one_call(
            lambda: c.search(Q, 3))
        if name == "span" and dtype == "float32":
            c.save(os.path.join(out, "clu_span"))
            back = ShardedClusteredIndex(dim=16, nlist=8, nprobe=2,
                                         train_threshold=64, mesh=mesh,
                                         device="cpu")
            back.batch_flat_fallback = False
            assert back.load(os.path.join(out, "clu_span"))
            ans["clu_span/reload"] = back.search(Q, 5)

if world == 4:
    # the background rebuild on the spanning mesh, in a thread of its own
    bg = ShardedClusteredIndex(16, nlist=8, nprobe=8, train_threshold=64,
                               mesh=meshes["span"], device="cpu")
    box = []
    thread = threading.Thread(target=lambda: box.append(
        bg.build_background()))

    def start():
        thread.start()
        while bg._bg_win is None and thread.is_alive():
            time.sleep(0.001)

    got, written, removed, new, cv = RSTEPS["bg_steps"](bg, start)
    while getattr(bg, "last_background", None) is None:
        bg.search(cv[:16], 5)  # the foreground goes on until the swap
    thread.join(60)
    assert not thread.is_alive() and box == [None], box
    got = RSTEPS["bg_final"](bg, got, written, removed, new, cv)
    ans.update({f"bg/{k}": v for k, v in got.items()})
    facts["bg"] = dict(bg.last_background, calls=bg._fg_calls)
    assert facts["bg"]["outcome"] == "swap", facts["bg"]

    # the sharded IVF engine with rank 3 holding no position
    iv = ShardedIVFIndex(16, nlist=16, nprobe=16, train_threshold=64,
                         mesh=meshes["three"], device="cpu")
    got = RSTEPS["ivf_steps"](iv, {7: make_mesh(device="cpu"),
                                   8: meshes["three"]})
    ans.update({f"ivf/{k}": v for k, v in got.items()})
    facts["ivf"] = {"count": iv.count(), "nlist": int(
        iv._centroids.shape[0]), "tables": sum(
            t is not None for t in iv._bucket_rows)}
    iv.save(os.path.join(out, "ivf_three"))

    # the facade: MESH_REPLICAS=2 on 4 ranks of 2 is the spanning layout
    from wdbx_tpu_torch.core.wdbx import WDBX
    for kind in ("sharded_flat", "sharded_clustered"):
        db = WDBX(vector_dimension=16, num_shards=1, device="cpu",
                  data_dir=os.path.join(out, f"db_{kind}{rank}"),
                  enable_plugins=False, enable_distributed=True,
                  config={"INDEX_TYPE": kind, "MESH_REPLICAS": 2,
                          "IVF_NLIST": 8, "IVF_NPROBE": 8,
                          "IVF_TRAIN_THRESHOLD": 64})
        asyncio.run(db.initialize())
        ix = db.store.indices[0]
        assert ix.replicas == 2 and ix.mesh.owners == tuple(
            meshes["span"].owners), ix.mesh.owners
        fv = np.random.default_rng(3).standard_normal((300, 16)).astype(
            np.float32)
        db.batch_store({f"v{i}": v for i, v in enumerate(fv)})
        hits = db.vector_search_batch(fv[:6], limit=2)
        facts[f"facade/{kind}"] = [db.count_vectors(),
                                   [h[0][0] for h in hits]]
no_jax()
with open(os.path.join(out, f"facts{rank}_{world}.json"), "w") as f:
    json.dump(facts, f)
np.savez(os.path.join(out, f"ans{rank}_{world}.npz"),
         **{f"{key}|{i}": np.asarray(v) for key, pair in ans.items()
            for i, v in enumerate(pair)})
print(f"proc{rank} SPANNING OK", flush=True)
"""

HEAL_WORKER = PRELUDE + r"""
asyncio.run(engine.initialize())
from wdbx_tpu_torch.core.wdbx import WDBX
from wdbx_tpu_torch.parallel import ShardEngine
ans, facts = {}, {}
rng = np.random.default_rng(4)
hv = rng.standard_normal((300, 16)).astype(np.float32)
hv /= np.linalg.norm(hv, axis=-1, keepdims=True)


def hits(db):
    got = db.vector_search_batch(hv[:12], limit=3)
    return (np.asarray([[h[1] for h in row] for row in got], np.float32),
            np.asarray([[int(h[0][1:]) for h in row] for row in got]))


def report(rep, db):
    ix = db.store.indices[0]
    out = {key: rep[key] for key in (
        "remeshed_to", "rehost", "recovered_shards", "unrecovered_shards",
        "healthy")}
    out["owners"] = list(ix.mesh.owners)
    out["local"] = list(ix.mesh.local_positions)
    out["engine_local"] = db.shard_engine.get_stats()["local_positions"]
    out["count"] = [db.count_vectors(), ix.valid_count()]
    return out


for kind in ("sharded_flat", "sharded_clustered", "sharded_ivf"):
    db = WDBX(vector_dimension=16, num_shards=1, device="cpu",
              data_dir=os.path.join(out, f"{kind}{rank}"),
              enable_plugins=False, enable_distributed=True,
              config={"INDEX_TYPE": kind, "IVF_NLIST": 8, "IVF_NPROBE": 8,
                      "IVF_TRAIN_THRESHOLD": 64,
                      "VECTOR_STORE_AUTOSAVE_INTERVAL": 0})
    asyncio.run(db.initialize())
    eng = db.shard_engine
    mine = [eng.mesh.names[p] for p in eng.mesh.local_positions]
    db.batch_store({f"v{i}": v for i, v in enumerate(hv)})
    ans[f"{kind}/before"] = hits(db)

    def probe(name, device, eng=eng):
        # every position of rank 1 fails its probe there
        if rank == 1:
            return "error: injected"
        return ShardEngine._probe(eng, name, device)

    eng._probe = probe
    facts[f"{kind}/down"] = report(db.heal(allow_remesh=True), db)
    ans[f"{kind}/down"] = hits(db)
    db.batch_store({f"w{i}": -v for i, v in enumerate(hv[:4])})
    ans[f"{kind}/down_written"] = hits(db)
    facts[f"{kind}/still_down"] = report(db.heal(allow_remesh=True), db)
    del eng._probe
    facts[f"{kind}/back"] = report(db.heal(allow_remesh=True), db)
    ans[f"{kind}/back"] = hits(db)
    facts[f"{kind}/mine"] = mine
no_jax()
with open(os.path.join(out, f"facts{rank}_{world}.json"), "w") as f:
    json.dump(facts, f)
np.savez(os.path.join(out, f"ans{rank}_{world}.npz"),
         **{f"{key}|{i}": np.asarray(v) for key, pair in ans.items()
            for i, v in enumerate(pair)})
print(f"proc{rank} HEAL OK", flush=True)
"""


def _facts(tmp, world):
    return [json.loads((tmp / f"facts{r}_{world}.json").read_text())
            for r in range(world)]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spanning4")
    _assert_ok(_run_ranks(WORKER, tmp, 4), "SPANNING OK")
    return tmp, _answers(tmp, 4), _facts(tmp, 4)


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spanning3")
    _assert_ok(_run_ranks(WORKER, tmp, 3, mesh_sizes=[2, 2, 2]),
               "SPANNING OK")
    return tmp, _answers(tmp, 3), _facts(tmp, 3)


@pytest.fixture(scope="module")
def heal_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spanning_heal")
    _assert_ok(_run_ranks(HEAL_WORKER, tmp, 2), "HEAL OK")
    return tmp, _answers(tmp, 2), _facts(tmp, 2)


def _run(request, name):
    return request.getfixturevalue("three_ranks" if name == "both"
                                   else "four_ranks")


def _port_mesh(name):
    r, s = LAYOUTS[name]
    return (make_mesh(s, device="cpu") if r is None
            else make_mesh2(r, s, device="cpu"))


def _jax_mesh(name):
    r, s = LAYOUTS[name]
    return jmesh(s) if r is None else jmesh2(r, s)


def _ranks_agree(ranks, prefix):
    keys = [k for k in ranks[0] if k.startswith(prefix)]
    assert keys, prefix
    for got in ranks[1:]:
        assert sorted(k for k in got if k.startswith(prefix)) == sorted(keys)
        for key in keys:
            _same(ranks[0][key], got[key], 0.0)
    return keys


# -- the layouts ----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layouts_are_jax_row_major(request, name):
    """Every rank builds the same mesh: the first ``r * s`` (or n)
    positions of the global list, row-major; ranks past them hold no
    position, and a rank may hold positions of two groups."""
    _, _, facts = _run(request, name)
    r, s = LAYOUTS[name]
    owners = OWNERS[name]
    for rank, f in enumerate(facts):
        shape, got_owners, local, groups, world = f["meshes"][name]
        assert got_owners == owners and world == len(facts), f["meshes"]
        assert local == [p for p, o in enumerate(owners) if o == rank]
        assert groups == sorted({p // s for p in local})
        assert shape == ({"shard": s} if r is None
                         else {"replica": r, "shard": s})
    if name == "both":
        assert facts[1]["meshes"]["both"][3] == [0, 1]
    if name in ("half", "three"):
        assert facts[3]["meshes"][name][2] == []


# -- the flat engine ------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_flat_matches_single_process(request, name, dtype):
    """Every rank returns every row of every answer, the single-process
    port's on the same layout, and the same counts; a rank without a
    position keeps its answers on its own device."""
    _, ranks, facts = _run(request, name)
    prefix = f"{name}/{dtype}/"
    _ranks_agree(ranks, prefix)
    single = ShardedFlatIndex(16, capacity=64, dtype=dtype,
                              mesh=_port_mesh(name))
    ref = STEPS_NS["flat_steps"](single)
    for key, pair in ref.items():
        _same(pair, ranks[0][prefix + key], 1e-6)
    np.testing.assert_array_equal(ranks[0][prefix + "vectors"][0],
                                  single.get_vectors(np.arange(8, 16)))
    stats = single.get_stats()
    for f in facts:
        got = f[f"{name}/{dtype}"]
        assert got["count"] == single.count()
        assert got["valid"] == single.valid_count()
        assert got["stats"] == [stats["size"], stats["replicas"],
                                stats["devices"], stats["tombstones"]]
        assert got["device"] == "cpu"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_flat_matches_jax(request, name, dtype):
    """Against JAX's ``ShardedFlatIndex`` on the same layout of
    conftest's 8 CPU devices (its pipelined search on a replicated mesh
    raises, so the pipelined steps stay out)."""
    _, ranks, _ = _run(request, name)
    j = JFlat(dim=16, capacity=64, dtype=dtype, mesh=_jax_mesh(name),
              axis="shard")
    ref = STEPS_NS["flat_steps"](j, pipelined=False)
    for key, pair in ref.items():
        assert_topk_match(*pair, *ranks[0][f"{name}/{dtype}/{key}"],
                          TOL[dtype])


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_one_gather_per_search(request, name):
    """A search on a global mesh crosses the ranks in ONE all-gather,
    whatever the layout and the batch (B=8, B=1, a pipelined stack), the
    flat and the clustered engine alike; nothing else crosses."""
    _, _, facts = _run(request, name)
    for f in facts:
        for dtype in DTYPES:
            for call, got in f[f"{name}/{dtype}"]["calls"].items():
                assert got == {"all_gather": 1}, (dtype, call, got)
        assert f[f"{name}/clu_float32"]["calls"] == {"all_gather": 1}


@pytest.mark.parametrize("name", ["span", "both"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_npz_across_layouts(request, tmp_path, name, dtype):
    """The npz written on a layout with groups spanning ranks loads on
    every other layout of the run (and on the unreplicated global mesh),
    and into one process on 8 shards, answering alike."""
    tmp, ranks, _ = _run(request, name)
    saved = ranks[0][f"{name}/{dtype}/saved"]
    others = [k for k in ranks[0] if k.startswith(f"{name}/{dtype}/npz_")]
    assert len(others) == (4 if name == "span" else 1), others
    for key in others:
        _same(saved, ranks[0][key], 1e-6)
    single = ShardedFlatIndex(16, dtype=dtype, mesh=make_mesh(8,
                                                              device="cpu"))
    assert single.load(str(tmp / f"npz_{name}_{dtype}"))
    q = np.random.default_rng(7).standard_normal((8, 16)).astype(np.float32)
    _same(single.search(q, 3), saved, 1e-6)


@pytest.mark.parametrize("name", ["span", "both"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_per_position_files_read_by_every_copy(request, name, dtype):
    """One file a shard, written once (on the shared path, by group 0's
    owners); every rank holding a copy of a shard read it, the ranks of
    group 1 too; one process loads the files unreplicated and as the
    same layout."""
    tmp, ranks, _ = _run(request, name)
    shards = LAYOUTS[name][1]
    files = sorted(p.name for p in (tmp / f"pp_{name}_{dtype}.orbax")
                   .iterdir())
    assert files == [f"position{p:05d}.pt" for p in range(shards)] + [
        "wdbx_positions.json"], files
    saved = ranks[0][f"{name}/{dtype}/saved"]
    for got in ranks:
        _same(saved, got[f"{name}/{dtype}/pp"], 0.0)
    q = np.random.default_rng(7).standard_normal((8, 16)).astype(np.float32)
    for mesh in (make_mesh(shards, device="cpu"), _port_mesh(name)):
        single = ShardedFlatIndex(16, dtype=dtype, mesh=mesh)
        single.persist_backend = "orbax"
        assert single.load(str(tmp / f"pp_{name}_{dtype}"))
        _same(single.search(q, 3), saved, 1e-6)


def test_remesh_collapses_the_replica_axis(four_ranks):
    """``span`` (2 x 4) remeshed to ``three`` (1-D, rank 3 without a
    position) and back: group 0's rows reach every new copy, and the
    answers are the single process's on the same meshes."""
    _, ranks, facts = four_ranks
    _ranks_agree(ranks, "remesh/")
    single = ShardedFlatIndex(16, capacity=64, mesh=_port_mesh("span"))
    STEPS_NS["flat_steps"](single)
    q = np.random.default_rng(7).standard_normal((8, 16)).astype(np.float32)
    single.remesh(_port_mesh("three"))
    _same(single.search(q, 5), ranks[0]["remesh/three"], 1e-6)
    single.remesh(_port_mesh("span"))
    _same(single.search(q, 5), ranks[0]["remesh/back"], 1e-6)
    sent = [f["remesh_three"]["rows_sent"] for f in facts]
    assert sent[3] == 0 and sum(sent) > 0, sent
    assert all(f["remesh_three"]["to"] == 3 for f in facts)


# -- the clustered engine -------------------------------------------------------


@pytest.mark.parametrize("name,dtype", [(n, "float32") for n in
                                        sorted(LAYOUTS)] + [("span", "int8")])
def test_clustered_matches_single_process_and_jax(request, name, dtype):
    """The sharded clustered engine on each layout: every route against
    the single-process port (rank 0 trains on its sample), the
    full-probe answer against JAX's."""
    _, ranks, facts = _run(request, name)
    prefix = f"{name}/clu_{dtype}/"
    _ranks_agree(ranks, prefix)
    single = ShardedClusteredIndex(16, nlist=8, nprobe=8, train_threshold=64,
                                   dtype=dtype, mesh=_port_mesh(name))
    ref = STEPS_NS["clustered_steps"](single)
    for key, pair in ref.items():
        _same(pair, ranks[0][prefix + key], 1e-6)
    assert all(f[f"{name}/clu_{dtype}"]["count"] == single.count()
               for f in facts)
    j = JClustered(dim=16, nlist=8, nprobe=8, train_threshold=64,
                   dtype=dtype, mesh=_jax_mesh(name), axis="shard")
    got = STEPS_NS["clustered_steps"](j, full_only=True)["c8"]
    assert_topk_match(*got, *ranks[0][prefix + "c8"], TOL[dtype])


def test_clustered_checkpoint_on_spanning_mesh(four_ranks):
    """The clustered checkpoint of the spanning mesh (``.ivfsc``) loads
    back on it and answers as one process loading it does."""
    tmp, ranks, _ = four_ranks
    _ranks_agree(ranks, "clu_span/")
    single = ShardedClusteredIndex(16, nlist=8, nprobe=2, train_threshold=64,
                                   mesh=_port_mesh("span"))
    single.batch_flat_fallback = False
    assert single.load(str(tmp / "clu_span"))
    q = np.random.default_rng(7).standard_normal((8, 16)).astype(np.float32)
    _same(single.search(q, 5), ranks[0]["clu_span/reload"], 1e-6)


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_background_rebuild_on_spanning_mesh(four_ranks, ref):
    """``build_background`` on the spanning mesh: the four ranks swap at
    the same foreground call, and every answer matches the same calls
    around a blocking rebuild (the single-process port; JAX)."""
    _, ranks, facts = four_ranks
    _ranks_agree(ranks, "bg/")
    for key in ("open_call", "swap_call", "agreements", "calls"):
        assert len({f["bg"][key] for f in facts}) == 1, key
    if ref == "port":
        idx = ShardedClusteredIndex(16, nlist=8, nprobe=8,
                                    train_threshold=64,
                                    mesh=_port_mesh("span"))
        rebuild, tol = idx.build, 1e-6
    else:
        idx = JClustered(16, nlist=8, nprobe=8, train_threshold=64,
                         mesh=_jax_mesh("span"), axis="shard")
        rebuild, tol = idx.build_background, TOL["float32"]
    out = RECOVERY_NS["bg_final"](idx, *RECOVERY_NS["bg_steps"](idx,
                                                                rebuild))
    for key, pair in out.items():
        assert_topk_match(*pair, *ranks[0][f"bg/{key}"], tol)


# -- the IVF engine and the facade ----------------------------------------------


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_ivf_with_a_rank_without_position(four_ranks, ref):
    """``ShardedIVFIndex`` on ``make_mesh(3)`` over 4 ranks (rank 3
    holds no table), remeshed to the 8 positions and back: as the
    single-process port and JAX on the same meshes."""
    tmp, ranks, facts = four_ranks
    _ranks_agree(ranks, "ivf/")
    assert [f["ivf"]["tables"] for f in facts] == [1, 1, 1, 0]
    if ref == "port":
        idx = ShardedIVFIndex(16, nlist=16, nprobe=16, train_threshold=64,
                              mesh=_port_mesh("three"))
        meshes, tol = {7: make_mesh(8, device="cpu"),
                       8: _port_mesh("three")}, 1e-6
    else:
        idx = JIVF(16, nlist=16, nprobe=16, train_threshold=64,
                   mesh=_jax_mesh("three"))
        meshes, tol = {7: jmesh(8), 8: _jax_mesh("three")}, TOL["float32"]
    out = RECOVERY_NS["ivf_steps"](idx, meshes)
    for key, pair in out.items():
        assert_topk_match(*pair, *ranks[0][f"ivf/{key}"], tol)
    if ref == "port":
        single = ShardedIVFIndex(16, nlist=16, nprobe=16, train_threshold=64,
                                 mesh=_port_mesh("three"))
        assert single.load(str(tmp / "ivf_three"))
        assert single.count() == facts[0]["ivf"]["count"]


@pytest.mark.parametrize("kind", ["sharded_flat", "sharded_clustered"])
def test_facade_with_mesh_replicas_spanning_ranks(four_ranks, kind):
    """``WDBX(enable_distributed=True, MESH_REPLICAS=2)`` on 4 ranks of 2
    positions lays its index on the spanning mesh; every rank finds each
    query's own row."""
    _, _, facts = four_ranks
    want = [300, [f"v{i}" for i in range(6)]]
    assert all(f[f"facade/{kind}"] == want for f in facts)


# -- heal with every position of one rank down ---------------------------------


@pytest.mark.parametrize("kind", ["sharded_flat", "sharded_clustered",
                                  "sharded_ivf"])
def test_heal_onto_one_rank_and_back(heal_ranks, kind):
    """Every position of rank 1 fails its probe: ``heal`` re-stripes
    live onto rank 0's 4 positions (rank 1 holds none and keeps
    answering), a second ``heal`` finds nothing more to do, writes land
    while down, and once the probe passes ``heal`` re-stripes back onto
    the 8. Both ranks report the same and answer alike."""
    _, ranks, facts = heal_ranks
    _ranks_agree(ranks, f"{kind}/")
    down = [f"cpu#{p}" for p in range(4)]
    for rank, f in enumerate(facts):
        rep = f[f"{kind}/down"]
        assert rep["remeshed_to"] == down and rep["rehost"] == {"0": "live"}
        assert rep["unrecovered_shards"] == [] and not rep["healthy"]
        assert rep["owners"] == [0] * 4
        assert rep["local"] == ([0, 1, 2, 3] if rank == 0 else [])
        assert rep["engine_local"] == rep["local"]
        assert rep["count"] == [300, 300]
        still = f[f"{kind}/still_down"]
        assert still["remeshed_to"] == [] and still["owners"] == [0] * 4
        back = f[f"{kind}/back"]
        assert back["remeshed_to"] == [f"cpu#{p}" for p in range(8)]
        assert back["rehost"] == {"0": "live"} and back["healthy"]
        assert back["owners"] == [0] * 4 + [1] * 4
        assert back["local"] == list(range(4 * rank, 4 * rank + 4))
        assert back["count"] == [304, 304]
    r0 = ranks[0]
    tol = 1e-6
    if kind == "sharded_flat":
        _same(r0[f"{kind}/before"], r0[f"{kind}/down"], tol)
    for key in ("down", "down_written", "back"):
        scores, slots = r0[f"{kind}/{key}"]
        assert (slots[:, 0] == np.arange(12)).all(), (key, slots)
    _same(r0[f"{kind}/down_written"], r0[f"{kind}/back"], tol)
