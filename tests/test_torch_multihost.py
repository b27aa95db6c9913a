"""The port's global mesh across processes: the counterpart of
``tests/test_parallel.py::TestMultiHost``.

Ranks are gloo worker processes on the CPU. Each sets
``WDBX_COORDINATOR_ADDRESS`` / ``WDBX_NUM_PROCESSES`` /
``WDBX_PROCESS_ID`` and ``WDBX_TORCH_MESH_SIZE`` (its own positions),
joins through ``ShardEngine.initialize`` and gets a global
``make_mesh()``: 2 ranks x 4 positions (JAX's 2 controllers x 4
devices), and 4 ranks x 2. Every worker asserts that neither ``jax`` nor
``wdbx_tpu`` was imported.

* ``test_two_process_shard_engine``: JAX's assertions: 8 shards, 4 local
  a rank, and the health of every position on every rank.
* ``test_two_process_data_plane``: ``MULTIHOST_DATA_WORKER``'s steps on
  the port, step for step, on float32, bf16 and int8 slabs: striped
  inserts, search and the two-level merge, tombstones, the clustered
  build across the ranks and its query, an orbax (per-position) round
  trip with each rank's own shard files. The workers write their answers
  to ``tmp_path``; the parent holds them against the port's
  single-process ``ShardedFlatIndex`` / ``ShardedClusteredIndex`` on
  ``make_mesh(8, device="cpu")`` fed the same calls (slots equal, scores
  within 1e-6: the CPU path is deterministic, and rank 0 trains on the
  single index's sample) and against the JAX package's on conftest's 8
  CPU devices (slot sets equal except at ties; scores within 1e-5 for
  float32, within the suite's bf16 / int8 tolerance otherwise; the
  clustered index at full probe, where both scans are exact).
* npz checkpoints: the ranks' npz loads into a single-process port index
  and into JAX's ``ShardedFlatIndex``; a JAX npz loads onto the ranks.
* a 4-rank x 2-position run of the flat part.
* the layouts a global mesh once refused, served now
  (``test_global_mesh_refuses``, one case each): replica groups
  spanning ranks (``make_mesh2(2)`` on the 4-rank run, where a group of
  4 shards spans two ranks of 2 positions: the mesh's layout, and a
  ``replicas=2`` index answering as the single process); and the
  refusal that stays: ranks holding unequal default position counts
  (``ValueError``). ``ShardedIVFIndex``, replica groups, ranks without
  a position, and the remesh, heal and background rebuild serve on a
  global mesh: ``tests/test_torch_multihost_ivf.py``,
  ``tests/test_torch_multihost_replicas.py``,
  ``tests/test_torch_multihost_spanning.py`` and
  ``tests/test_torch_multihost_recovery.py``.

Every run has a deadline: the parent kills every worker when one fails
or time runs out, and each group's collectives time out after 60 s, so
no case can hang the suite.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_ops import TOL, assert_topk_match
from wdbx_tpu.parallel import ShardedClusteredIndex as JClustered
from wdbx_tpu.parallel import ShardedFlatIndex as JFlat
from wdbx_tpu_torch.parallel import (
    ShardedClusteredIndex,
    ShardedFlatIndex,
    make_mesh,
    make_mesh2,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
DTYPES = ["float32", "bfloat16", "int8"]
DEADLINE_S = 150

#: what every worker does first: the coordinator variables, the group's
#: short timeout, the join through ShardEngine.initialize
PRELUDE = r"""
import asyncio, json, os, sys
port, rank, world, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
os.environ.update(WDBX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                  WDBX_NUM_PROCESSES=str(world), WDBX_PROCESS_ID=str(rank))
import numpy as np
import torch
torch.set_num_threads(1)
from wdbx_tpu_torch.core.config import WDBXConfig
from wdbx_tpu_torch.parallel import shard_engine
shard_engine.JOIN_TIMEOUT_S = 60  # also every collective's timeout
engine = shard_engine.ShardEngine(
    WDBXConfig({"DATA_DIR": os.path.join(out, f"engine{rank}")}), device="cpu")


def no_jax():
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "wdbx_tpu" or m.startswith("wdbx_tpu.")]
    assert not bad, bad
"""

ENGINE_WORKER = PRELUDE + r"""
asyncio.run(engine.initialize())
import torch.distributed as dist
alloc = engine.allocation()
assert alloc["process_count"] == 2, alloc["process_count"]
assert alloc["process_index"] == rank, alloc["process_index"]
n = len(alloc["shards"])
assert n == 8, n  # 2 processes x 4 local positions
local = [s for s in range(n) if engine.is_local_shard(s)]
assert local == list(range(4 * rank, 4 * rank + 4)), local
names = [alloc["shards"][str(s)]["primary"] for s in range(n)]
assert names == [f"cpu#{s}" for s in range(n)], names
health = engine.health_check()  # each rank probes its own, then gathers
assert health["healthy"] and list(health["devices"]) == names, health
total = torch.ones(1) * (rank + 1)
dist.all_reduce(total)
assert float(total) == 3.0, float(total)
stats = engine.get_stats()
assert stats["process_count"] == 2 and stats["local_positions"] == local
no_jax()
asyncio.run(engine.shutdown())
assert not dist.is_initialized()
print(f"proc{rank} OK local={local}", flush=True)
"""

DATA_WORKER = PRELUDE + r"""
asyncio.run(engine.initialize())
from wdbx_tpu_torch.parallel import (
    ShardedClusteredIndex, ShardedFlatIndex, make_mesh, make_mesh2)
flat_only = sys.argv[5] == "flat"
dtypes = sys.argv[6].split(",")
L = int(os.environ["WDBX_TORCH_MESH_SIZE"])

# data plane: add/search/tombstone on a mesh spanning the processes
mesh = make_mesh(device="cpu")
assert mesh.size == L * world and len(mesh.local_positions) == L, mesh.owners
ans = {}
for dtype in dtypes:
    idx = ShardedFlatIndex(dim=16, capacity=8 * 16, mesh=mesh, dtype=dtype)
    rng = np.random.default_rng(0)  # identical inserts on every rank
    vecs = rng.standard_normal((32, 16)).astype(np.float32)
    slots = idx.add_batch(vecs)
    scores, got = idx.search(vecs[:8], k=3)
    assert (got[:, 0] == slots[:8]).all(), got[:, 0]
    idx.remove_slots(slots[:2])
    s2, got2 = idx.search(vecs[:2], k=1)
    assert got2[0, 0] != slots[0] and got2[1, 0] != slots[1]
    ps, pg = idx.search_pipelined(vecs[:8].reshape(2, 4, 16), k=3)
    ms, mg = idx.search(vecs[:8], k=5,
                        slot_mask=np.arange(32) % 3 == 0)
    assert idx.valid_count() == 30
    gv = idx.get_vectors(slots[2:10])
    ans.update({f"{dtype}/flat": (scores, got), f"{dtype}/tomb": (s2, got2),
                f"{dtype}/pipelined": (ps, pg), f"{dtype}/masked": (ms, mg),
                f"{dtype}/vectors": (gv, slots[2:10])})
    # the npz checkpoint (rank 0 writes) and a JAX one onto the ranks
    idx.save(os.path.join(out, f"ranks_{dtype}_{world}"))
    jx = ShardedFlatIndex(dim=16, capacity=8 * 16, mesh=mesh, dtype=dtype)
    assert jx.load(os.path.join(out, f"jax_{dtype}"))
    ans[f"{dtype}/from_jax"] = jx.search(vecs[:8], k=3)
    # orbax persistence: per-process shard I/O
    idx.persist_backend = "orbax"
    path = os.path.join(out, f"mh_orbax_{dtype}_{world}")
    idx.save(path)
    mine = sorted(f for f in os.listdir(path + ".orbax") if f.endswith(".pt"))
    assert len(mine) == mesh.size, mine
    idx2 = ShardedFlatIndex(dim=16, capacity=8 * 16, mesh=mesh, dtype=dtype)
    idx2.persist_backend = "orbax"
    assert idx2.load(path), "orbax multi-host load failed"
    _, og = idx2.search(vecs[2:6], k=1)
    assert (og.ravel() == slots[2:6]).all(), og.ravel()
    ans[f"{dtype}/orbax"] = idx2.search(vecs[:8], k=3)
    if flat_only:
        continue
    # clustered build: kmeans on rank 0, striped permute across the ranks
    c = ShardedClusteredIndex(dim=16, nlist=8, nprobe=8, train_threshold=64,
                              mesh=mesh, dtype=dtype)
    c.batch_flat_fallback = False
    cv = rng.standard_normal((600, 16)).astype(np.float32)
    cv /= np.linalg.norm(cv, axis=-1, keepdims=True)
    cs = c.add_batch(cv)
    c.build()
    assert c.is_trained
    cs_scores, cg = c.search(cv[:8], k=3)
    assert (cg[:, 0] == cs[:8]).all(), cg[:, 0]
    ans[f"{dtype}/clustered"] = (cs_scores, cg)
    c.nprobe = 2
    ans[f"{dtype}/clustered_np2"] = c.search(cv[8:24], k=5)
    c.add_batch(cv[:5] * -1.0)  # fresh rows: the residual part
    ans[f"{dtype}/clustered_fresh"] = c.search(cv[24:40], k=5)
    mask = np.zeros(605, bool)
    mask[::50] = True  # 2%: the exact masked route (K2 a shard)
    ans[f"{dtype}/clustered_masked"] = c.search(cv[:8], k=3, slot_mask=mask)
    c.latency_path = "ranges"
    ans[f"{dtype}/clustered_ranges"] = c.search(cv[8:10], k=5)
    c.latency_path = "auto"
    ans[f"{dtype}/clustered_pipelined"] = c.search_pipelined(
        cv[40:56].reshape(2, 8, 16), k=5)
    cpath = os.path.join(out, f"clu_{dtype}")
    c.save(cpath)
    c2 = ShardedClusteredIndex(dim=16, nlist=8, nprobe=2, train_threshold=64,
                               mesh=mesh, dtype=dtype)
    c2.batch_flat_fallback = False
    assert c2.load(cpath)
    got_again = c2.search(cv[24:40], k=5)
    np.testing.assert_array_equal(got_again[1],
                                  ans[f"{dtype}/clustered_fresh"][1])
    if dtype == dtypes[0]:
        # the facade joins before its store: its indexes are on the mesh,
        # and its two store shards search one after the other
        from wdbx_tpu_torch.core.wdbx import WDBX
        db = WDBX(vector_dimension=16, num_shards=2, device="cpu",
                  data_dir=os.path.join(out, f"db{rank}"),
                  enable_plugins=False, enable_distributed=True,
                  config={"INDEX_TYPE": "sharded_flat"})
        asyncio.run(db.initialize())
        assert all(ix.mesh.size == mesh.size for ix in db.store.indices)
        for i, v in enumerate(vecs[:12]):
            db.vector_store(v, {"i": i}, f"v{i}")
        hits = db.vector_search(vecs[3], limit=2)
        assert hits[0][0] == "v3", hits
        ans["facade"] = (np.asarray([[h[1] for h in hits]], np.float32),
                         np.asarray([[int(h[0][1:]) for h in hits]]))
if flat_only:
    # 2 positions a rank: a replica group of 4 shards spans two ranks
    m2 = make_mesh2(2, device="cpu")
    spanning = {"replicas": [m2.shape, list(m2.owners),
                             list(m2.local_groups)]}
    rix = ShardedFlatIndex(dim=16, replicas=2, device="cpu")
    rix.add_batch(vecs)
    ans["replicas_index"] = rix.search(vecs[:8], k=3)
    spanning["replicas_index"] = [rix.replicas, rix.n_devices,
                                  list(rix.mesh.owners)]
    with open(os.path.join(out, f"spanning{rank}.json"), "w") as f:
        json.dump(spanning, f)
no_jax()
np.savez(os.path.join(out, f"ans{rank}_{world}.npz"),
         **{f"{key}|{i}": np.asarray(v) for key, pair in ans.items()
            for i, v in enumerate(pair)})
print(f"proc{rank} DATA OK", flush=True)
"""

UNEQUAL_WORKER = PRELUDE + r"""
asyncio.run(engine.initialize())  # the engine's own mesh: refused
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(script_text, tmp, world, args=(), mesh_sizes=None,
               deadline=DEADLINE_S):
    """Start ``world`` ranks of ``script_text``; kill them all when one
    fails or the deadline passes. Returns ``[(rc, output)]``."""
    script = tmp / f"worker{abs(hash(script_text))}.py"
    script.write_text(script_text)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   WDBX_TORCH_MESH_SIZE=str(
                       (mesh_sizes or [8 // world] * world)[rank]))
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(port), str(rank), str(world),
             str(tmp), *args],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    end = time.monotonic() + deadline
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or time.monotonic() > end:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.wait(), p.stdout.read()) for p in procs]


def _assert_ok(outs, marker):
    for rank, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed rc={rc}:\n{out[-3000:]}"
        assert f"proc{rank} {marker}" in out, out[-2000:]


def _answers(tmp, world):
    got = []
    for rank in range(world):
        with np.load(tmp / f"ans{rank}_{world}.npz") as f:
            pairs = {}
            for name in f.files:
                key, i = name.split("|")
                pairs.setdefault(key, [None, None])[int(i)] = f[name]
        got.append(pairs)
    return got


def test_two_process_shard_engine(tmp_path):
    _assert_ok(_run_ranks(ENGINE_WORKER, tmp_path, 2), "OK")


# -- the data plane: one 2-rank run for every case below -------------------


def _normed(rng, n, d=16):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _flat_script(index):
    """The workers' flat steps on a single-process index: the answers
    keyed as the workers key them."""
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((32, 16)).astype(np.float32)
    slots = index.add_batch(vecs)
    out = {"flat": index.search(vecs[:8], k=3)}
    index.remove_slots(slots[:2])
    out["tomb"] = index.search(vecs[:2], k=1)
    out["pipelined"] = index.search_pipelined(vecs[:8].reshape(2, 4, 16),
                                              k=3)
    out["masked"] = index.search(vecs[:8], k=5,
                                 slot_mask=np.arange(32) % 3 == 0)
    return out, rng, vecs


def _clustered_script(index, rng):
    cv = rng.standard_normal((600, 16)).astype(np.float32)
    cv /= np.linalg.norm(cv, axis=-1, keepdims=True)
    index.batch_flat_fallback = False
    index.add_batch(cv)
    index.build()
    out = {"clustered": index.search(cv[:8], k=3)}
    if isinstance(index, JClustered):
        return out  # full probe only: JAX trains its own centroids
    index.nprobe = 2
    out["clustered_np2"] = index.search(cv[8:24], k=5)
    index.add_batch(cv[:5] * -1.0)
    out["clustered_fresh"] = index.search(cv[24:40], k=5)
    mask = np.zeros(605, bool)
    mask[::50] = True
    out["clustered_masked"] = index.search(cv[:8], k=3, slot_mask=mask)
    index.latency_path = "ranges"
    out["clustered_ranges"] = index.search(cv[8:10], k=5)
    index.latency_path = "auto"
    out["clustered_pipelined"] = index.search_pipelined(
        cv[40:56].reshape(2, 8, 16), k=5)
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One 2-rank x 4-position run of the data worker over every dtype,
    with a JAX npz checkpoint of each dtype written first for the ranks
    to load. Returns the directory and both ranks' answers."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    for dtype in DTYPES:
        j = JFlat(dim=16, capacity=8 * 16, dtype=dtype)
        j.add_batch(np.random.default_rng(0).standard_normal(
            (32, 16)).astype(np.float32))
        j.save(str(tmp / f"jax_{dtype}"))
    outs = _run_ranks(DATA_WORKER, tmp, 2, ("all", ",".join(DTYPES)))
    _assert_ok(outs, "DATA OK")
    return tmp, _answers(tmp, 2)


def _same(ref, got, atol):
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_two_process_data_plane(two_ranks, dtype):
    """The ranks agree with each other and with the single-process port
    on every flat and clustered answer (slots equal, scores within
    1e-6)."""
    _, (r0, r1) = two_ranks
    keys = [k for k in r0 if k.startswith(f"{dtype}/")]
    assert len(keys) == 13, keys
    for key in keys:
        _same(r0[key], r1[key], 0.0)
    single = ShardedFlatIndex(16, capacity=8 * 16, dtype=dtype,
                              mesh=make_mesh(8, device="cpu"))
    ref, rng, _ = _flat_script(single)
    for key, pair in ref.items():
        _same(pair, r0[f"{dtype}/{key}"], 1e-6)
    assert single.valid_count() == 30
    np.testing.assert_array_equal(r0[f"{dtype}/vectors"][0],
                                  single.get_vectors(
                                      r0[f"{dtype}/vectors"][1]))
    clu = ShardedClusteredIndex(16, nlist=8, nprobe=8, train_threshold=64,
                                dtype=dtype, mesh=make_mesh(8, device="cpu"))
    for key, pair in _clustered_script(clu, rng).items():
        _same(pair, r0[f"{dtype}/{key}"], 1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_two_process_matches_jax(two_ranks, dtype):
    """The ranks' flat answers and full-probe clustered answers against
    the JAX package's sharded indexes on 8 CPU devices."""
    _, (r0, _) = two_ranks
    jflat = JFlat(dim=16, capacity=8 * 16, dtype=dtype)
    ref, rng, _ = _flat_script(jflat)
    for key in ("flat", "tomb", "masked"):
        assert_topk_match(*ref[key], *r0[f"{dtype}/{key}"], TOL[dtype])
    ps, pg = ref["pipelined"]
    assert_topk_match(ps, pg, *r0[f"{dtype}/pipelined"], TOL[dtype])
    jclu = JClustered(dim=16, nlist=8, nprobe=8, train_threshold=64,
                      dtype=dtype)
    got = _clustered_script(jclu, rng)["clustered"]
    assert_topk_match(*got, *r0[f"{dtype}/clustered"], TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_two_process_npz_checkpoints(two_ranks, dtype):
    """The ranks' npz loads into a single-process port index and into
    JAX's; a JAX npz loaded onto the ranks answers as JAX does."""
    tmp, (r0, _) = two_ranks
    vecs = np.random.default_rng(0).standard_normal((32, 16)).astype(
        np.float32)
    path = str(tmp / f"ranks_{dtype}_2")
    single = ShardedFlatIndex(16, capacity=8 * 16, dtype=dtype,
                              mesh=make_mesh(8, device="cpu"))
    assert single.load(path)
    # written after the tombstones, as the orbax answer was searched
    assert single.count() == 30
    _same(single.search(vecs[:8], k=3), r0[f"{dtype}/orbax"], 1e-6)
    jflat = JFlat(dim=16, capacity=8 * 16, dtype=dtype)
    assert jflat.load(path)
    assert_topk_match(*jflat.search(vecs[:8], k=3), *r0[f"{dtype}/orbax"],
                      TOL[dtype])
    jsrc = JFlat(dim=16, capacity=8 * 16, dtype=dtype)
    assert jsrc.load(str(tmp / f"jax_{dtype}"))
    assert_topk_match(*jsrc.search(vecs[:8], k=3), *r0[f"{dtype}/from_jax"],
                      TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_two_process_orbax_round_trip(two_ranks, dtype):
    """Each rank wrote its own positions' files, the ranks loaded them
    back, and the reloaded index answers as the saved one."""
    tmp, (r0, r1) = two_ranks
    files = sorted(os.listdir(tmp / f"mh_orbax_{dtype}_2.orbax"))
    assert files == [f"position{p:05d}.pt" for p in range(8)] + [
        "wdbx_positions.json"], files
    _same(r0[f"{dtype}/orbax"], r1[f"{dtype}/orbax"], 0.0)
    single = ShardedFlatIndex(16, capacity=8 * 16, dtype=dtype,
                              mesh=make_mesh(8, device="cpu"))
    _, _, vecs = _flat_script(single)
    _same(single.search(vecs[:8], k=3), r0[f"{dtype}/orbax"], 1e-6)


def test_two_process_facade(two_ranks):
    """``WDBX(enable_distributed=True)`` joins before its store, so its
    sharded indexes lie on the global mesh; its two store shards search
    in turn (a thread each would order the ranks' collectives
    differently), and both ranks answer alike."""
    _, (r0, r1) = two_ranks
    _same(r0["facade"], r1["facade"], 0.0)
    assert r0["facade"][1][0, 0] == 3


#: what the 4-rank run records of the layouts once refused, a replica
#: group spanning ranks: the mesh (shape, owners, this rank's groups) and
#: an index on it (replicas, shards, owners)
SPANNING = {
    "replicas": lambda rank: [{"replica": 2, "shard": 4},
                              [0, 0, 1, 1, 2, 2, 3, 3], [rank // 2]],
    "replicas_index": lambda rank: [2, 4, [0, 0, 1, 1, 2, 2, 3, 3]],
}


@pytest.mark.parametrize("name", sorted(SPANNING))
def test_global_mesh_refuses(four_ranks, name):
    """``make_mesh2(2)`` on 4 ranks of 2 positions, once refused: every
    rank lays the same mesh, group 0 on ranks 0-1 and group 1 on ranks
    2-3, and a ``replicas=2`` index on it answers on every rank as the
    single-process port on ``make_mesh2(2, 4)``."""
    tmp, ranks = four_ranks
    for rank in range(4):
        got = json.loads((tmp / f"spanning{rank}.json").read_text())[name]
        assert got == SPANNING[name](rank), (rank, got)
    if name == "replicas_index":
        single = ShardedFlatIndex(16, replicas=2, mesh=make_mesh2(
            2, 4, device="cpu"))
        vecs = np.random.default_rng(0).standard_normal((32, 16)).astype(
            np.float32)
        single.add_batch(vecs)
        for got in ranks:
            _same(single.search(vecs[:8], k=3), got["replicas_index"], 1e-6)


def test_unequal_positions_refused(tmp_path):
    """Ranks holding 4 and 2 positions: make_mesh raises ValueError on
    both."""
    outs = _run_ranks(UNEQUAL_WORKER, tmp_path, 2, mesh_sizes=[4, 2])
    for rc, out in outs:
        assert rc != 0, out
        assert "ValueError" in out and "same number of positions" in out, \
            out[-2000:]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One 4-rank x 2-position run of the data worker's flat part
    (float32, int8), which also records the spanning-group layout and
    an index on it."""
    tmp = tmp_path_factory.mktemp("four_ranks")
    for dtype in ("float32", "int8"):
        j = JFlat(dim=16, capacity=8 * 16, dtype=dtype)
        j.add_batch(np.random.default_rng(0).standard_normal(
            (32, 16)).astype(np.float32))
        j.save(str(tmp / f"jax_{dtype}"))
    _assert_ok(_run_ranks(DATA_WORKER, tmp, 4,
                          ("flat", "float32,int8")), "DATA OK")
    return tmp, _answers(tmp, 4)


def test_four_process_flat(four_ranks):
    """4 ranks x 2 positions: the flat steps (float32, int8) answer as
    the single-process port does."""
    _, ranks = four_ranks
    for dtype in ("float32", "int8"):
        single = ShardedFlatIndex(16, capacity=8 * 16, dtype=dtype,
                                  mesh=make_mesh(8, device="cpu"))
        ref, _, _ = _flat_script(single)
        for got in ranks:
            for key, pair in ref.items():
                _same(pair, got[f"{dtype}/{key}"], 1e-6)
