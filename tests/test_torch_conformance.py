"""Feature x engine conformance matrix of the port (wdbx_tpu_torch).

The JAX package's ``tests/test_conformance.py`` checklist, run on the
port's serving engines built on the CPU: every engine goes through the
same capability checks, and capabilities an engine rejects are asserted
to reject (int4 on the dense-table layout raises). The sharded flat,
sharded IVF and sharded clustered engines run on 8 logical CPU shards.
The support table is held against the reference's.
Checks that apply to some engines only (the tuners, the serve-through
rebuild) are parametrised over those engines.
"""

import numpy as np
import pytest
import test_conformance as reference
import torch

from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex
from wdbx_tpu_torch.index.flat import FlatIndex
from wdbx_tpu_torch.index.ivf import IVFIndex
from wdbx_tpu_torch.parallel import (
    ShardedClusteredIndex,
    ShardedFlatIndex,
    ShardedIVFIndex,
    make_mesh,
)

torch.set_num_threads(2)

N, D, K = reference.N, reference.D, reference.K


def _normed(rng, n, d=D):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _ann_kwargs():
    return dict(nlist=16, nprobe=16, train_threshold=256)


#: the reference's 8 faked CPU devices, as 8 logical CPU shards
MESH = make_mesh(8, device="cpu")

ENGINES = {
    "flat": (FlatIndex, {}),
    "ivf_dense": (IVFIndex, _ann_kwargs()),
    "ivf_clustered": (ClusteredIVFIndex, _ann_kwargs()),
    "sharded_flat": (ShardedFlatIndex, {"mesh": MESH}),
    "sharded_ivf": (ShardedIVFIndex, {**_ann_kwargs(), "mesh": MESH}),
    "sharded_clustered": (ShardedClusteredIndex,
                          {**_ann_kwargs(), "mesh": MESH}),
}
#: engines where the int4 capacity tier is supported; the rest reject it
INT4_OK = {"flat", "ivf_clustered", "sharded_flat", "sharded_clustered"}
#: engines with a serve-through background rebuild
BG_REBUILD = {"ivf_clustered", "sharded_clustered"}
#: ANN engines (carry tune / tune_filtered; flat is always exact)
ANN = {"ivf_dense", "ivf_clustered", "sharded_ivf", "sharded_clustered"}


def _make(name, dtype="float32"):
    cls, kw = ENGINES[name]
    idx = cls(D, dtype=dtype, device="cpu", **kw)
    if hasattr(idx, "batch_flat_fallback"):
        idx.batch_flat_fallback = False
    if hasattr(idx, "topk_method"):
        idx.topk_method = "exact"
    return idx


def _filled(name, db, dtype="float32"):
    idx = _make(name, dtype)
    slots = np.asarray(idx.add_batch(db))
    if hasattr(idx, "build"):
        idx.build()
    return idx, slots


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    return _normed(rng, N), _normed(rng, 8), rng


def test_support_table_matches_the_reference():
    assert set(ENGINES) == set(reference.ENGINES)
    assert INT4_OK == reference.INT4_OK
    assert BG_REBUILD == reference.BG_REBUILD
    assert ANN == reference.ANN


@pytest.mark.parametrize("engine", sorted(ENGINES))
class TestConformance:
    def test_crud_and_exact_recall(self, engine, corpus):
        db, q, rng = corpus
        idx, slots = _filled(engine, db)
        # self-query identity
        _, got = idx.search(db[:8], 1)
        assert (np.asarray(got).ravel() == slots[:8]).all()
        # update moves the row
        target = _normed(rng, 1)
        idx.update_slots(slots[5:6], target)
        _, g2 = idx.search(target, 1)
        assert int(np.asarray(g2).ravel()[0]) == int(slots[5])
        # remove hides it
        idx.remove_slots(slots[5:6])
        _, g3 = idx.search(target, 1)
        assert int(np.asarray(g3).ravel()[0]) != int(slots[5])
        assert idx.count() == N - 1

    @pytest.mark.parametrize("dtype", ["int8", "int4"])
    def test_quantized_tiers(self, engine, corpus, dtype):
        db, q, rng = corpus
        if dtype == "int4" and engine not in INT4_OK:
            with pytest.raises(ValueError, match="int4"):
                _make(engine, dtype=dtype)
            return
        idx, slots = _filled(engine, db, dtype)
        _, got = idx.search(q, K)
        got = np.asarray(got)
        exact = slots[np.argsort(-(q @ db.T), axis=-1)[:, :K]]
        recall = np.mean([
            len(set(map(int, a[a >= 0])) & set(map(int, b))) / K
            for a, b in zip(got, exact)
        ])
        floor = 0.8 if dtype == "int4" else 0.9
        assert recall >= floor, (engine, dtype, recall)

    def test_filter_mask_confines_results(self, engine, corpus):
        db, q, rng = corpus
        idx, slots = _filled(engine, db)
        mask = np.zeros(int(slots.max()) + 1, bool)
        mask[slots[rng.random(N) < 0.10]] = True
        _, got = idx.search(q, K, slot_mask=mask)
        assert all(mask[int(g)] for g in np.asarray(got).ravel() if g >= 0)

    def test_deep_overfetch(self, engine, corpus):
        """k' = 200 (the store's re-rank over-fetch) serves on every
        engine: past the kernels' KERNEL_K_MAX the search routes off the
        kernel, without a crash, a short result or a repeated slot."""
        db, q, rng = corpus
        idx, slots = _filled(engine, db)
        _, got = idx.search(q[:2], 200)
        got = np.asarray(got)
        assert got.shape == (2, 200)
        assert (got[:, 0] >= 0).all()
        for row in got:
            ids = [int(g) for g in row if g >= 0]
            assert len(ids) == len(set(ids)), "duplicate candidates"

    def test_save_load_roundtrip(self, engine, corpus, tmp_path):
        db, q, rng = corpus
        idx, slots = _filled(engine, db)
        path = str(tmp_path / "ckpt")
        idx.save(path)
        idx2 = _make(engine)
        assert idx2.load(path)
        assert idx2.count() == idx.count()
        _, got = idx2.search(db[:4], 1)
        assert (np.asarray(got).ravel() == slots[:4]).all()


@pytest.mark.parametrize("engine", sorted(ANN))
def test_tuners(engine, corpus):
    db, q, rng = corpus
    idx, slots = _filled(engine, db)
    assert idx.tune(q, k=K, target_recall=0.9) >= 0.9
    mask = np.zeros(int(slots.max()) + 1, bool)
    mask[slots[rng.random(N) < 0.15]] = True
    assert idx.tune_filtered(q, mask, k=K, target_recall=0.9) >= 0.9


@pytest.mark.parametrize("engine", sorted(BG_REBUILD))
def test_background_rebuild(engine, corpus):
    db, q, rng = corpus
    idx, slots = _filled(engine, db)
    idx.remove_slots(slots[:100])
    idx.build_background()  # synchronous call still exercises the path
    assert idx.count() == N - 100
    _, got = idx.search(db[200:204], 1)
    assert (np.asarray(got).ravel() == slots[200:204]).all()
