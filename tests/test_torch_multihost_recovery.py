"""Remesh, heal and the background rebuild of the port's global mesh:
gloo worker processes on the CPU (``tests/test_torch_multihost.py``'s
runner and prelude), 2 ranks x 4 positions and 4 ranks x 2.

One run of each does everything; the tests read its records:

* ``degraded_mesh`` from a health map in which one rank's probe of a
  position fails (a fault injected into that rank's probe; the real
  ``health_check`` spreads it): the same mesh on every rank, survivors
  keeping their names and owners in unequal blocks (8 -> 7 is 4 + 3 on
  2 ranks, 2 + 2 + 2 + 1 on 4; 8 -> 6 takes one position of rank 0 as
  well).
* ``STEPS`` on the flat engine (float32, bf16, int8), the sharded
  clustered engine and the sharded IVF engine: a live remesh 8 -> 7
  (searches, a filter, pipelined, writes on the new striping), 7 -> 8,
  8 -> 6, then ``adopt_mesh`` onto 7 and an npz reload. The parent
  replays the steps on the port's single-process index over
  ``make_mesh(n, device="cpu")`` (slots equal, scores within 1e-6) and
  on the JAX package's sharded engines on conftest's 8 CPU devices
  remeshed with ``make_mesh(n)`` (slot sets equal except at ties, scores
  within 1e-5 for float32 and the suite's ``TOL`` otherwise; the
  clustered and IVF engines at full probe, where their scans are exact).
* ``WDBX.heal`` on the facade with a fault injected into the last
  rank's probe of the last position: ``allow_remesh=True`` (a live
  remesh to 7, then the walkthrough's checkpoint heal), the cold
  re-host when one rank cannot read its positions (every rank takes the
  cold branch), and ``allow_remesh=False`` (every rank reloads its
  checkpoint).
* ``build_background`` in a thread of each rank while the main thread
  searches, adds, updates and removes: both ranks swap at the same
  foreground call, and every answer matches the single-process port and
  JAX fed the same calls around a blocking rebuild.
* the meshes once refused, served now: a degraded mesh that leaves a
  rank without a position, fewer positions than ranks (the rank past
  them holds none); and the refusals that stay: a remesh or cold
  re-host between a global and a single-process mesh (``ValueError``).
* ``wdbx_tpu_torch/examples/production_serving.py`` as 2 ranks of 4
  positions: both exit 0 and print the same lines, heal included, and
  each rank's data directory holds the store its shutdown saved.

Every run has a deadline (``_run_ranks``), and every group's collectives
time out after 60 s.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from test_torch_multihost import (
    PRELUDE,
    REPO,
    _answers,
    _assert_ok,
    _free_port,
    _run_ranks,
    _same,
)
from test_torch_ops import TOL, assert_topk_match
from wdbx_tpu.parallel import ShardedClusteredIndex as JClustered
from wdbx_tpu.parallel import ShardedFlatIndex as JFlat
from wdbx_tpu.parallel import make_mesh as jmesh
from wdbx_tpu.parallel.sharded_ivf import ShardedIVFIndex as JIVF
from wdbx_tpu_torch.parallel import (
    ShardedClusteredIndex,
    ShardedFlatIndex,
    ShardedIVFIndex,
    make_mesh,
)

DTYPES = ["float32", "bfloat16", "int8"]

#: the calls of each engine, shared by the ranks, the single-process
#: port and JAX; ``meshes`` maps 8 / 7 / 6 to the package's meshes
STEPS = r"""
import numpy as np


def normed(rng, n, d=16):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def flat_steps(idx, meshes, path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((120, 16)).astype(np.float32)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    slots = idx.add_batch(x)
    idx.remove_slots(np.array([4, 5, 77]))
    out = {"before": idx.search(q, 5)}
    idx.remesh(meshes[7])
    out["r7"] = idx.search(q, 5)
    out["r7_masked"] = idx.search(q, 5, slot_mask=np.arange(120) % 3 == 0)
    out["r7_pipe"] = idx.search_pipelined(q.reshape(2, 3, 16), 5)
    # live rows (a remesh moves no removed row's bytes)
    out["r7_vectors"] = (idx.get_vectors(slots[6:14]), slots[6:14])
    more = idx.add_batch(-x[:10])
    out["r7_more"] = idx.search(-x[:4], 3)
    # JAX's sharded index counts its live rows through count() alone
    live = getattr(idx, "valid_count", idx.count)()
    out["r7_count"] = (np.array([idx.count(), live]), np.asarray(more))
    idx.remesh(meshes[8])
    out["r8"] = idx.search(q, 5)
    idx.remesh(meshes[6])
    out["r6"] = idx.search(q, 5)
    out["r6_k40"] = idx.search(q, 40)
    idx.save(path)
    idx.adopt_mesh(meshes[7])
    out["adopted_count"] = (np.array([idx.count()]), np.array([0]))
    assert idx.load(path)
    out["reload7"] = idx.search(q, 5)
    return out


def clustered_steps(idx, meshes, exact):
    rng = np.random.default_rng(1)
    cv = normed(rng, 600)
    idx.batch_flat_fallback = False
    idx.add_batch(cv)
    idx.build()
    out = {"before": idx.search(cv[:8], 3)}
    idx.remesh(meshes[7])
    out["r7"] = idx.search(cv[8:24], 5)
    idx.add_batch(-cv[:5])
    out["r7_fresh"] = idx.search(cv[24:40], 5)
    if not exact:
        idx.nprobe = 2
        out["r7_np2"] = idx.search(cv[8:24], 5)
        idx.nprobe = 8
    idx.remesh(meshes[8])
    out["r8"] = idx.search(cv[8:24], 5)
    return out


def ivf_steps(idx, meshes):
    rng = np.random.default_rng(2)
    x = normed(rng, 800)
    idx.add_batch(x)
    idx.build()
    idx.batch_flat_fallback = False
    out = {"before": idx.search(x[:8], 5)}
    idx.remesh(meshes[7])
    out["r7"] = idx.search(x[8:24], 5)
    idx.remove_slots(np.arange(30, 40))
    out["r7_removed"] = idx.search(x[28:44], 5)
    idx.remesh(meshes[8])
    out["r8"] = idx.search(x[8:24], 5)
    return out


def bg_steps(idx, rebuild):
    # a fixed sequence of foreground calls around a rebuild: ``rebuild``
    # starts it (the ranks) or runs it (the blocking references)
    rng = np.random.default_rng(3)
    cv = normed(rng, 600)
    idx.batch_flat_fallback = False
    slots = idx.add_batch(cv)
    idx.build()
    idx.add_batch(normed(rng, 40))
    new = normed(rng, 24)
    rebuild()
    q = cv[:16]
    out = {"s0": idx.search(q, 5)}
    added = np.asarray(idx.add_batch(new[:8]))
    idx.update_slots(slots[10:14], new[8:12])
    idx.remove_slots(slots[20:30])
    out["s1"] = idx.search(q, 5)
    added = np.concatenate([added, idx.add_batch(new[12:24])])
    idx.remove_slots(slots[30:32])
    out["s2"] = idx.search(cv[16:32], 5)
    written = np.concatenate([added[:8], slots[10:14], added[8:]])
    return out, written, np.concatenate([slots[20:32]]), new, cv


def bg_final(idx, out, written, removed, new, cv):
    out["final"] = idx.search(cv[:16], 5)
    out["written"] = idx.search(new, 1)
    out["gone"] = idx.search(cv[20:32], 1)
    assert (out["written"][1][:, 0] == written).all(), out["written"][1]
    assert not np.isin(out["gone"][1], removed).any()
    return out
"""

STEPS_NS: dict = {}
exec(STEPS, STEPS_NS)

RECOVERY_WORKER = PRELUDE + STEPS + r"""
asyncio.run(engine.initialize())
import threading
import time
import torch
from wdbx_tpu_torch.parallel import (
    Mesh, ShardedClusteredIndex, ShardedFlatIndex, ShardedIVFIndex,
    ShardEngine, collective, make_mesh)
part, dtypes = sys.argv[5], sys.argv[6].split(",")
L = int(os.environ["WDBX_TORCH_MESH_SIZE"])
mesh8 = make_mesh(device="cpu")
names = list(mesh8.names)


def inject(eng, down):
    # this rank's probe of the positions ``down`` fails; the real
    # health_check gathers every rank's statuses
    def probe(name, device):
        if name in down:
            return "error: injected"
        return ShardEngine._probe(eng, name, device)
    eng._probe = probe


def health_with(*down):
    inject(engine, down)
    try:
        return engine.health_check()
    finally:
        del engine._probe


facts = {"world": world}
h7 = health_with(names[-1])
m7 = engine.degraded_mesh(h7)
m6 = engine.degraded_mesh(health_with(names[L - 1], names[-1]))
facts["degraded"] = {str(m.size): [list(m.names), list(m.owners),
                                   list(m.local_positions)]
                     for m in (m7, m6)}
facts["health7"] = h7
meshes = {8: mesh8, 7: m7, 6: m6}
ans = {}
for dtype in dtypes:
    idx = ShardedFlatIndex(16, capacity=128, mesh=mesh8, dtype=dtype)
    got = flat_steps(idx, meshes, os.path.join(out, f"flat_{dtype}"))
    ans.update({f"flat/{dtype}/{k}": v for k, v in got.items()})
    facts[f"flat/{dtype}"] = {"n_devices": idx.n_devices,
                              "last_remesh": idx.last_remesh}

refusals = {}


def refused(name, fn):
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        refusals[name] = [type(e).__name__, str(e)]
    else:
        refusals[name] = ["none", ""]


def served(name, mesh):
    refusals[name] = [list(mesh.names), list(mesh.owners),
                      list(mesh.local_positions)]


served("empty_rank", engine.degraded_mesh({"devices": {
    n: "error: down" if o == world - 1 else "ok"
    for n, o in zip(names, mesh8.owners)}}))
served("fewer_positions_than_ranks", make_mesh(world - 1, device="cpu"))
one = Mesh([torch.device("cpu")] * 8)
refused("single_process_remesh", lambda: idx.remesh(one))
refused("single_process_adopt", lambda: idx.adopt_mesh(one))
facts["refusals"] = refusals

if part == "all":
    c = ShardedClusteredIndex(16, nlist=8, nprobe=8, train_threshold=64,
                              mesh=mesh8)
    ans.update({f"clustered/{k}": v
                for k, v in clustered_steps(c, meshes, False).items()})
    iv = ShardedIVFIndex(16, nlist=16, nprobe=16, train_threshold=64,
                         mesh=mesh8)
    ans.update({f"ivf/{k}": v for k, v in ivf_steps(iv, meshes).items()})

    # the facade's heal
    from wdbx_tpu_torch.core.wdbx import WDBX

    def make_db(name, index_type):
        db = WDBX(vector_dimension=16, num_shards=1, device="cpu",
                  data_dir=os.path.join(out, f"{name}{rank}"),
                  enable_plugins=False, enable_distributed=True,
                  config={"INDEX_TYPE": index_type, "IVF_NLIST": 8,
                          "IVF_NPROBE": 8, "IVF_TRAIN_THRESHOLD": 64,
                          "VECTOR_STORE_AUTOSAVE_INTERVAL": 0})
        asyncio.run(db.initialize())
        hv = normed(np.random.default_rng(4), 300)
        db.batch_store({f"v{i}": v for i, v in enumerate(hv)})
        db.store.save()
        return db, hv

    def hits(db, hv):
        got = db.vector_search_batch(hv[:12], limit=3)
        return (np.asarray([[h[1] for h in row] for row in got], np.float32),
                np.asarray([[int(h[0][1:]) for h in row] for row in got]))

    def report(rep):
        return {key: rep[key] for key in (
            "remeshed_to", "rehost", "recovered_shards",
            "unrecovered_shards", "device_plan", "healthy")}

    db, hv = make_db("heal", "sharded_ivf")
    ans["heal/before"] = hits(db, hv)
    inject(db.shard_engine, {names[-1]})
    facts["heal_remesh"] = report(db.heal(allow_remesh=True))
    ix = db.store.indices[0]
    facts["heal_remesh"]["index_mesh"] = [list(ix.mesh.names),
                                          list(ix.mesh.owners)]
    ans["heal/remeshed"] = hits(db, hv)
    # the walkthrough's step 4: checkpoint, a simulated loss, heal
    db.store.save()
    db.store.indices[0].clear()
    facts["heal_checkpoint"] = report(db.heal())
    ans["heal/checkpoint"] = hits(db, hv)

    class Dead:
        # a position whose device is lost: its reads raise
        def __init__(self, t):
            self.t = t

        def sum(self):
            return self.t.sum()

        def __getitem__(self, at):
            raise RuntimeError("injected: the device is lost")

    db3, hv = make_db("cold", "sharded_flat")
    ix3 = db3.store.indices[0]
    if rank == world - 1:
        p = ix3.mesh.local_positions[0]
        ix3._valids[p] = Dead(ix3._valids[p])
    inject(db3.shard_engine, {names[-1]})
    facts["heal_cold"] = report(db3.heal(allow_remesh=True))
    ans["heal/cold"] = hits(db3, hv)

    db2, hv = make_db("noremesh", "sharded_flat")
    inject(db2.shard_engine, {names[-1]})
    facts["heal_no_remesh"] = report(db2.heal(allow_remesh=False))
    facts["heal_no_remesh"]["index_mesh"] = list(
        db2.store.indices[0].mesh.names)
    ans["heal/no_remesh"] = hits(db2, hv)

    # the background rebuild: a thread of its own, the foreground going on
    bg = ShardedClusteredIndex(16, nlist=8, nprobe=8, train_threshold=64,
                               mesh=mesh8)
    box = []
    thread = threading.Thread(target=lambda: box.append(
        bg.build_background()))

    def start():
        thread.start()
        while bg._bg_win is None and thread.is_alive():
            time.sleep(0.001)

    got, written, removed, new, cv = bg_steps(bg, start)
    extra = 0
    while getattr(bg, "last_background", None) is None:
        bg.search(cv[:16], 5)  # the foreground goes on until the swap
        extra += 1
    thread.join(60)
    assert not thread.is_alive() and box == [None], box
    got = bg_final(bg, got, written, removed, new, cv)
    ans.update({f"bg/{k}": v for k, v in got.items()})
    facts["bg"] = dict(bg.last_background, extra_searches=extra,
                       calls=bg._fg_calls)
    assert facts["bg"]["outcome"] == "swap", facts["bg"]

    # a remesh in an open window abandons the snapshot on every rank
    box2 = []
    thread2 = threading.Thread(target=lambda: box2.append(
        bg.build_background()))
    thread2.start()
    while bg._bg_win is None and thread2.is_alive():
        time.sleep(0.001)
    bg.search(cv[:16], 5)  # the agreed call: the window opens here
    bg.remesh(m7)
    thread2.join(60)
    assert not thread2.is_alive() and box2 == [None], box2
    facts["bg_abandoned"] = dict(bg.last_background,
                                 n_devices=bg.n_devices)
    ans["bg/after_abandon"] = bg.search(cv[:16], 5)

no_jax()
with open(os.path.join(out, f"facts{rank}_{world}.json"), "w") as f:
    json.dump(facts, f)
np.savez(os.path.join(out, f"ans{rank}_{world}.npz"),
         **{f"{key}|{i}": np.asarray(v) for key, pair in ans.items()
            for i, v in enumerate(pair)})
print(f"proc{rank} RECOVERY OK", flush=True)
"""


def _facts(tmp, world):
    return [json.loads((tmp / f"facts{r}_{world}.json").read_text())
            for r in range(world)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One 2-rank x 4-position run of every part."""
    tmp = tmp_path_factory.mktemp("recovery2")
    _assert_ok(_run_ranks(RECOVERY_WORKER, tmp, 2,
                          ("all", ",".join(DTYPES))), "RECOVERY OK")
    return tmp, _answers(tmp, 2), _facts(tmp, 2)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One 4-rank x 2-position run of the flat part (float32, int8)."""
    tmp = tmp_path_factory.mktemp("recovery4")
    _assert_ok(_run_ranks(RECOVERY_WORKER, tmp, 4,
                          ("flat", "float32,int8")), "RECOVERY OK")
    return tmp, _answers(tmp, 4), _facts(tmp, 4)


def _runs(request, world):
    return request.getfixturevalue("two_ranks" if world == 2
                                   else "four_ranks")


def _port_meshes():
    return {n: make_mesh(n, device="cpu") for n in (8, 7, 6)}


def _jax_meshes():
    return {n: jmesh(n) for n in (8, 7, 6)}


def _ranks_agree(ranks, prefix):
    keys = [k for k in ranks[0] if k.startswith(prefix)]
    assert keys, prefix
    for got in ranks[1:]:
        for key in keys:
            _same(ranks[0][key], got[key], 0.0)
    return keys


# -- the degraded mesh --------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_degraded_mesh_identical_on_every_rank(request, world):
    """Every rank derives the same degraded meshes from the gathered
    health map; the survivors keep their names and owners."""
    _, _, facts = _runs(request, world)
    per = 8 // world
    owners8 = [p // per for p in range(8)]
    want = {
        "7": [[f"cpu#{p}" for p in range(7)], owners8[:7]],
        "6": [[f"cpu#{p}" for p in range(8) if p not in (per - 1, 7)],
              [o for p, o in enumerate(owners8) if p not in (per - 1, 7)]],
    }
    for rank, f in enumerate(facts):
        assert f["health7"]["devices"]["cpu#7"] == "error: injected"
        assert not f["health7"]["healthy"]
        for size, (names, owners) in want.items():
            got = f["degraded"][size]
            assert got[:2] == [names, owners], (rank, size, got)
            assert [owners[p] for p in got[2]] == [rank] * len(got[2])
    if world == 2:
        assert facts[0]["degraded"]["7"][2] == [0, 1, 2, 3]
        assert facts[1]["degraded"]["7"][2] == [4, 5, 6]


# -- the flat engine ------------------------------------------------------------


@pytest.mark.parametrize("world,dtype", [(2, d) for d in DTYPES]
                         + [(4, "float32"), (4, "int8")])
def test_flat_remesh_matches_single_process(request, tmp_path, world, dtype):
    """8 -> 7 -> 8 -> 6, then adopt_mesh + the npz reload: the ranks
    agree, and answer as the single-process port on the same meshes."""
    _, ranks, facts = _runs(request, world)
    keys = _ranks_agree(ranks, f"flat/{dtype}/")
    single = ShardedFlatIndex(16, capacity=128, dtype=dtype,
                              mesh=make_mesh(8, device="cpu"))
    ref = STEPS_NS["flat_steps"](single, _port_meshes(),
                                 str(tmp_path / "single"))
    assert sorted(f"flat/{dtype}/{k}" for k in ref) == sorted(keys)
    for key, pair in ref.items():
        _same(pair, ranks[0][f"flat/{dtype}/{key}"], 1e-6)
    assert all(f[f"flat/{dtype}"]["n_devices"] == 7 for f in facts)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flat_remesh_matches_jax(two_ranks, tmp_path, dtype):
    """The same steps on JAX's ShardedFlatIndex over conftest's 8 CPU
    devices remeshed with make_mesh(n)."""
    _, (r0, _), _ = two_ranks
    j = JFlat(16, capacity=128, dtype=dtype)
    ref = STEPS_NS["flat_steps"](j, _jax_meshes(), str(tmp_path / "jax"))
    assert j.n_devices == 7
    for key, pair in ref.items():
        got = r0[f"flat/{dtype}/{key}"]
        if key in ("r7_vectors", "r7_count", "adopted_count"):
            np.testing.assert_array_equal(got[1], pair[1])
            np.testing.assert_allclose(got[0], pair[0], atol=TOL[dtype],
                                       rtol=0)
            continue
        assert_topk_match(*pair, *got, TOL[dtype])


def test_remesh_moves_rows_through_all_to_all(request):
    """A remesh sends only the rows whose new shard another rank holds:
    8 -> 6 on 2 ranks moves about half of the live rows each way, and
    every row carries its slot id (8 bytes) beside its stored bytes."""
    _, _, facts = _runs(request, 2)
    for f in facts:
        last = f["flat/float32"]["last_remesh"]
        assert (last["from"], last["to"]) == (8, 6), last
        assert 0 < last["rows_sent"] < 120, last
        assert last["bytes_sent"] == last["rows_sent"] * (16 * 4 + 8), last
        assert last["seconds"] > 0
        i8 = f["flat/int8"]["last_remesh"]
        assert i8["bytes_sent"] == i8["rows_sent"] * (16 + 4 + 8), i8


# -- the clustered and IVF engines ----------------------------------------------


def test_clustered_remesh_matches_single_process(two_ranks):
    """The sharded clustered engine rebuilds its layout across the ranks
    after each remesh: as the single-process port."""
    _, ranks, _ = two_ranks
    _ranks_agree(ranks, "clustered/")
    single = ShardedClusteredIndex(16, nlist=8, nprobe=8, train_threshold=64,
                                   mesh=make_mesh(8, device="cpu"))
    ref = STEPS_NS["clustered_steps"](single, _port_meshes(), False)
    for key, pair in ref.items():
        _same(pair, ranks[0][f"clustered/{key}"], 1e-6)


def test_clustered_remesh_matches_jax(two_ranks):
    _, (r0, _), _ = two_ranks
    j = JClustered(16, nlist=8, nprobe=8, train_threshold=64)
    ref = STEPS_NS["clustered_steps"](j, _jax_meshes(), True)
    for key, pair in ref.items():
        assert_topk_match(*pair, *r0[f"clustered/{key}"], TOL["float32"])


def test_ivf_remesh_matches_single_process(two_ranks):
    """The sharded IVF engine re-stripes, then rebuilds its tables over
    7 shards (nlist 16 -> 14) with the rank-0 training and the top-4
    exchange, and the quota scan merges 4 + 3 shards."""
    _, ranks, _ = two_ranks
    _ranks_agree(ranks, "ivf/")
    single = ShardedIVFIndex(16, nlist=16, nprobe=16, train_threshold=64,
                             mesh=make_mesh(8, device="cpu"))
    meshes = _port_meshes()
    ref = STEPS_NS["ivf_steps"](single, meshes)
    for key, pair in ref.items():
        _same(pair, ranks[0][f"ivf/{key}"], 1e-6)
    single.remesh(meshes[7])
    assert int(single._centroids.shape[0]) == 14


def test_ivf_remesh_matches_jax(two_ranks):
    _, (r0, _), _ = two_ranks
    j = JIVF(16, nlist=16, nprobe=16, train_threshold=64)
    ref = STEPS_NS["ivf_steps"](j, _jax_meshes())
    for key, pair in ref.items():
        assert_topk_match(*pair, *r0[f"ivf/{key}"], TOL["float32"])


# -- heal -------------------------------------------------------------------------


def test_heal_live_remesh(two_ranks):
    """heal(allow_remesh=True) with the last position down: every rank
    remeshes live to the 7 survivors (4 + 3) and answers as before."""
    _, ranks, facts = two_ranks
    for f in facts:
        rep = f["heal_remesh"]
        assert rep["remeshed_to"] == [f"cpu#{p}" for p in range(7)], rep
        assert rep["rehost"] == {"0": "live"}, rep
        assert rep["unrecovered_shards"] == [] and not rep["healthy"]
        assert rep["index_mesh"] == [rep["remeshed_to"],
                                     [0, 0, 0, 0, 1, 1, 1]]
    _ranks_agree(ranks, "heal/")
    _same(ranks[0]["heal/before"], ranks[0]["heal/remeshed"], 1e-6)


def test_heal_matches_single_process(two_ranks, tmp_path, monkeypatch):
    """The healed ranks answer as one process's facade on 7 positions
    fed the same rows."""
    from wdbx_tpu_torch.core.wdbx import WDBX
    from wdbx_tpu_torch.parallel.mesh import MESH_SIZE_ENV

    _, (r0, _), _ = two_ranks
    monkeypatch.setenv(MESH_SIZE_ENV, "7")
    db = WDBX(vector_dimension=16, num_shards=1, device="cpu",
              data_dir=str(tmp_path / "one"), enable_plugins=False,
              config={"INDEX_TYPE": "sharded_ivf", "IVF_NLIST": 8,
                      "IVF_NPROBE": 8, "IVF_TRAIN_THRESHOLD": 64,
                      "VECTOR_STORE_AUTOSAVE_INTERVAL": 0})
    hv = STEPS_NS["normed"](np.random.default_rng(4), 300)
    db.batch_store({f"v{i}": v for i, v in enumerate(hv)})
    got = db.vector_search_batch(hv[:12], limit=3)
    ref = (np.asarray([[h[1] for h in row] for row in got], np.float32),
           np.asarray([[int(h[0][1:]) for h in row] for row in got]))
    assert db.store.indices[0].n_devices == 7
    _same(ref, r0["heal/remeshed"], 1e-6)


def test_heal_checkpoint_after_remesh(two_ranks):
    """The walkthrough's checkpoint heal on the remeshed ranks: each
    rank reloads its own data directory's npz onto the 7 positions."""
    _, (r0, _), facts = two_ranks
    for f in facts:
        rep = f["heal_checkpoint"]
        assert rep["recovered_shards"] == [0], rep
        assert rep["remeshed_to"] == [] and rep["device_plan"] == {}
    _same(r0["heal/before"], r0["heal/checkpoint"], 1e-6)


def test_heal_cold_rehost_on_every_rank(two_ranks):
    """One rank cannot read its positions: the remesh raises on every
    rank, and every rank re-hosts cold from its checkpoint."""
    _, (r0, _), facts = two_ranks
    for f in facts:
        rep = f["heal_cold"]
        assert rep["rehost"] == {"0": "cold"}, rep
        assert rep["remeshed_to"] == [f"cpu#{p}" for p in range(7)]
        assert rep["unrecovered_shards"] == []
    _same(r0["heal/before"], r0["heal/cold"], 1e-6)


def test_heal_without_remesh(two_ranks):
    """heal(allow_remesh=False): every rank reloads its checkpoint on
    the mesh it has."""
    _, (r0, _), facts = two_ranks
    for f in facts:
        rep = f["heal_no_remesh"]
        assert rep["recovered_shards"] == [0] and rep["remeshed_to"] == []
        assert rep["device_plan"] == {"7": "cpu#0"}, rep
        assert len(rep["index_mesh"]) == 8
    _same(r0["heal/before"], r0["heal/no_remesh"], 1e-6)


# -- the background rebuild ---------------------------------------------------------


def test_background_abandoned_by_a_remesh(two_ranks):
    """A remesh in an open window waits for step (2), then abandons the
    snapshot on every rank at the same call; the remeshed index answers
    as the swapped one did."""
    _, ranks, facts = two_ranks
    for f in facts:
        ab = f["bg_abandoned"]
        assert ab["outcome"] == "abandoned" and ab["n_devices"] == 7, ab
    assert len({f["bg_abandoned"]["swap_call"] for f in facts}) == 1
    _same(ranks[0]["bg/final"], ranks[0]["bg/after_abandon"], 1e-6)


def test_background_swap_at_the_same_call(two_ranks):
    """Both ranks open the window and swap at the same foreground call,
    after at least one agreement all-gather."""
    _, ranks, facts = two_ranks
    bgs = [f["bg"] for f in facts]
    for key in ("open_call", "swap_call", "agreements", "calls",
                "extra_searches"):
        assert len({b[key] for b in bgs}) == 1, (key, bgs)
    b = bgs[0]
    assert b["outcome"] == "swap"
    assert b["swap_call"] > b["open_call"] and b["agreements"] >= 1, b
    assert b["agreements"] == b["swap_call"] - b["open_call"], b
    _ranks_agree(ranks, "bg/")


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_background_matches_blocking_rebuild(two_ranks, ref):
    """Every answer of the window and after the swap, against the same
    calls around a blocking rebuild (the single-process port; JAX)."""
    _, (r0, _), _ = two_ranks
    if ref == "port":
        idx = ShardedClusteredIndex(16, nlist=8, nprobe=8,
                                    train_threshold=64,
                                    mesh=make_mesh(8, device="cpu"))
        rebuild, tol = idx.build, 1e-6
    else:
        idx = JClustered(16, nlist=8, nprobe=8, train_threshold=64)
        rebuild, tol = idx.build_background, TOL["float32"]
    out = STEPS_NS["bg_final"](idx, *STEPS_NS["bg_steps"](idx, rebuild))
    for key, pair in out.items():
        assert_topk_match(*pair, *r0[f"bg/{key}"], tol)


# -- refusals ------------------------------------------------------------------------

REFUSALS = {
    "single_process_remesh": ("ValueError", "within one process"),
    "single_process_adopt": ("ValueError", "within one process"),
}
#: the meshes of the cases once refused, by rank: names, owners and the
#: rank's positions (rank 1 holds none on either)
SERVED = {
    "empty_rank": lambda rank: [[f"cpu#{p}" for p in range(4)], [0] * 4,
                                [0, 1, 2, 3] if rank == 0 else []],
    "fewer_positions_than_ranks": lambda rank: [
        ["cpu#0"], [0], [0] if rank == 0 else []],
}


@pytest.mark.parametrize("name", sorted(REFUSALS) + sorted(SERVED))
def test_refusals(two_ranks, name):
    """A remesh or re-host between a global and a single-process mesh
    stays refused; a degraded mesh with every position of rank 1 down,
    and ``make_mesh(1)`` on 2 ranks (once refused), give every rank the
    same mesh, rank 1 holding no position."""
    _, _, facts = two_ranks
    for rank, f in enumerate(facts):
        got = f["refusals"][name]
        if name in SERVED:
            assert got == SERVED[name](rank), (rank, got)
            continue
        kind, text = REFUSALS[name]
        assert got[0] == kind and text in got[1], got


# -- the production_serving walkthrough on 2 ranks -----------------------------------


@pytest.fixture(scope="module")
def walkthrough(tmp_path_factory):
    """``production_serving`` as 2 gloo ranks of 4 CPU positions, each
    with its own temporary directory."""
    tmp = tmp_path_factory.mktemp("walkthrough")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   WDBX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   WDBX_NUM_PROCESSES="2", WDBX_PROCESS_ID=str(rank),
                   TMPDIR=str(tmp))
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "wdbx_tpu_torch.examples.production_serving", "--device", "cpu",
             "--shards", "4"],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    end = time.monotonic() + 150
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() > end:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.wait(), p.stdout.read()) for p in procs]


def _lines(out):
    return [line.split(" -> ")[0] for line in out.splitlines()
            if not line.startswith("[W")]


def test_production_serving_on_two_ranks(walkthrough):
    """Both ranks exit 0 and print the same lines, step 4's heal
    included."""
    (rc0, out0), (rc1, out1) = walkthrough
    assert rc0 == 0 and rc1 == 0, (out0[-3000:], out1[-3000:])
    assert _lines(out0) == _lines(out1), (out0, out1)
    assert "tables split over 8 'shard' positions" in out0
    assert "recovered shards=[0]" in out0
    assert "post-heal query: doc-7" in out0


def test_production_serving_shutdown_saves(walkthrough, monkeypatch):
    """Each rank's shutdown saved its store before leaving the group:
    its data directory loads in one process on 8 positions."""
    from wdbx_tpu_torch.core.wdbx import WDBX
    from wdbx_tpu_torch.parallel.mesh import MESH_SIZE_ENV

    monkeypatch.setenv(MESH_SIZE_ENV, "8")
    for _, out in walkthrough:
        path = [line for line in out.splitlines()
                if line.startswith("dashboard:")][0].split(" -> ")[1]
        db = WDBX(vector_dimension=64, num_shards=1, device="cpu",
                  data_dir=os.path.dirname(path), enable_plugins=False,
                  config={"INDEX_TYPE": "sharded_ivf", "IVF_NLIST": 16})
        assert db.count_vectors() == 4096
        assert db.store.indices[0].n_devices == 8
