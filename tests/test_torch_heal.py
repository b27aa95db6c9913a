"""The facade's mesh layer on the port: ``WDBX(enable_distributed=True)``
and ``heal()`` on 8 logical CPU shards (``WDBX_TORCH_MESH_SIZE=8``).

The heal cases of ``tests/test_parallel.py`` (checkpoint recovery, the
escalation to a live remesh, the cold re-host when the remesh cannot
read the old mesh), with health reports keyed on the mesh's position
names. Then what the port adds: a heal with every position healthy,
the engine's stats, and the same heal on the ``sharded_clustered``
engine.
"""

import asyncio
from unittest import mock

import numpy as np
import pytest

from wdbx_tpu_torch import WDBX
from wdbx_tpu_torch.parallel.mesh import MESH_SIZE_ENV


@pytest.fixture(autouse=True)
def eight_shards(monkeypatch):
    monkeypatch.setenv(MESH_SIZE_ENV, "8")


def _db(temp_dir, **kw):
    db = WDBX(vector_dimension=8, data_dir=temp_dir, enable_plugins=False,
              enable_distributed=True, device="cpu", **kw)
    asyncio.run(db.initialize())
    return db


def _down(names, dead):
    return {"healthy": False, "devices": {
        n: ("error: down" if n in dead else "ok") for n in names}}


def test_heal_recovers_from_checkpoint(temp_dir):
    """A dead primary -> every shard reloads from its last checkpoint;
    the data is still queryable afterwards."""
    db = _db(temp_dir, num_shards=2)
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((20, 8)).astype(np.float32)
    for i, v in enumerate(vecs):
        db.vector_store(v, {"i": i}, f"v{i}")
    db.store.save()
    db.store.indices[0].clear()  # simulated device loss
    alloc = db.shard_engine.allocation()
    bad = alloc["shards"]["0"]["primary"]
    names = [d["primary"] for d in alloc["shards"].values()]
    with mock.patch.object(db.shard_engine, "health_check",
                           return_value=_down(names, {bad})):
        report = db.heal()
    assert 0 in report["recovered_shards"]
    assert report["device_plan"] and report["remeshed_to"] == []
    hits = db.vector_search(vecs[0], limit=1)
    assert hits[0][0] == "v0"


def test_heal_escalates_to_remesh(temp_dir):
    """A dead position leaves the topology: the store's sharded index
    re-stripes onto the 7 survivors and keeps serving."""
    db = _db(temp_dir, num_shards=1, config={"INDEX_TYPE": "sharded_flat"})
    rng = np.random.default_rng(1)
    vecs = rng.standard_normal((24, 8)).astype(np.float32)
    for i, v in enumerate(vecs):
        db.vector_store(v, {"i": i}, f"v{i}")
    db.store.save()
    index = db.store.indices[0]
    n_before = index.n_devices
    names = list(db.shard_engine.mesh.names)
    with mock.patch.object(db.shard_engine, "health_check",
                           return_value=_down(names, {names[0]})):
        report = db.heal(allow_remesh=True)
    assert report["remeshed_to"] == names[1:]
    assert index.n_devices == n_before - 1 == 7
    assert list(db.shard_engine.mesh.names) == names[1:]
    hits = db.vector_search(vecs[3], limit=1)
    assert hits[0][0] == "v3"
    assert db.store.verify()["consistent"]


def test_heal_cold_rehosts_when_remesh_fails(temp_dir):
    """A truly-dead device makes the live remesh raise; heal falls back
    to adopt_mesh + checkpoint reload."""
    db = _db(temp_dir, num_shards=1, config={"INDEX_TYPE": "sharded_flat"})
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((16, 8)).astype(np.float32)
    for i, v in enumerate(vecs):
        db.vector_store(v, {"i": i}, f"v{i}")
    db.store.save()
    index = db.store.indices[0]
    n_before = index.n_devices
    names = list(db.shard_engine.mesh.names)
    with mock.patch.object(
        db.shard_engine, "health_check",
        return_value=_down(names, {names[0]}),
    ), mock.patch.object(
        index, "remesh", side_effect=RuntimeError("device unreachable"),
    ):
        report = db.heal(allow_remesh=True)
    assert report["remeshed_to"]
    assert report["unrecovered_shards"] == []
    assert index.n_devices == n_before - 1
    hits = db.vector_search(vecs[2], limit=1)
    assert hits[0][0] == "v2"


def test_heal_sharded_ivf_and_healthy_mesh(temp_dir):
    """production_serving's flow: a sharded IVF store, a real health
    check (every position ok, nothing to do), a checkpoint recovery
    after a simulated loss, and the engine in the facade's stats."""
    db = _db(temp_dir, num_shards=1, config={
        "INDEX_TYPE": "sharded_ivf", "IVF_NLIST": 16, "IVF_NPROBE": 4,
        "IVF_TRAIN_THRESHOLD": 256})
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((600, 8)).astype(np.float32)
    db.batch_store({f"d{i}": v for i, v in enumerate(vecs)})
    index = db.store.indices[0]
    index.build()
    assert index.is_trained and len(index._bucket_rows) == 8
    report = db.heal()
    assert report["healthy"] and report["device_plan"] == {}
    assert set(report["devices"]) == set(db.shard_engine.mesh.names)
    db.store.save()
    index.clear()
    report = db.heal()  # integrity layer: registry vs cleared index
    assert report["recovered_shards"] == [0]
    assert db.vector_search(vecs[7], limit=1)[0][0] == "d7"
    stats = db.get_stats()["shard_engine"]
    assert stats["initialized"] and len(stats["devices"]) == 8
    asyncio.run(db.shutdown())
    assert not db.shard_engine.get_stats()["initialized"]


def test_sharded_clustered_still_names_its_slice(temp_dir):
    """``INDEX_TYPE=sharded_clustered`` (the engine of slice 5c) serves
    through the facade: a trained store heals onto 7 positions with a
    live remesh (the cluster layout rebuilt there) and keeps its hits."""
    from wdbx_tpu_torch.parallel import ShardedClusteredIndex

    db = _db(temp_dir, num_shards=1, config={
        "INDEX_TYPE": "sharded_clustered", "IVF_NLIST": 8, "IVF_NPROBE": 8,
        "IVF_TRAIN_THRESHOLD": 128})
    index = db.store.indices[0]
    assert type(index) is ShardedClusteredIndex and index.n_devices == 8
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((400, 8)).astype(np.float32)
    db.batch_store({f"c{i}": v for i, v in enumerate(vecs)})
    index.build()
    assert index.is_trained
    before = db.vector_search_batch(vecs[:6], limit=3)
    db.store.save()
    names = list(db.shard_engine.mesh.names)
    with mock.patch.object(db.shard_engine, "health_check",
                           return_value=_down(names, {names[2]})):
        report = db.heal(allow_remesh=True)
    assert report["remeshed_to"] == names[:2] + names[3:]
    assert index.n_devices == 7 and index.is_trained
    after = db.vector_search_batch(vecs[:6], limit=3)
    assert [[h[0] for h in row] for row in after] == \
        [[h[0] for h in row] for row in before]
    assert db.store.verify()["consistent"]
