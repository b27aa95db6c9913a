"""Parity of the port's FlatIndex with wdbx_tpu's, on the CPU.

Both indexes go through the same mutations (add, update, remove, slot
reuse, growth past capacity, compact) and answer the same searches
(plain, masked, pipelined), with the JAX index's fused Pallas kernel in
interpret mode where ``topk_method="fused"``. Checkpoints cross between
the packages in both directions, and ``flat_index_from_arrays`` carries
a JAX index's arrays over.
"""

import numpy as np
import pytest
import torch

from test_torch_ops import TOL, assert_topk_match
from wdbx_tpu.index.flat import FlatIndex as JFlat
from wdbx_tpu_torch.convert import flat_index_from_arrays
from wdbx_tpu_torch.index.flat import FlatIndex as TFlat

torch.set_num_threads(2)

DTYPES = ["float32", "bfloat16", "int8", "int4"]
DIM = 16


def _rows(rng, n):
    return rng.standard_normal((n, DIM)).astype(np.float32)


def _same(jres, tres, dtype):
    (sj, ij), (st, it) = jres, tres
    assert it.dtype == np.int64
    assert_topk_match(sj, ij, st, it, TOL[dtype])


def _pair(dtype, topk="exact", metric="cosine", capacity=64):
    return (JFlat(DIM, metric=metric, dtype=dtype, capacity=capacity,
                  topk_method=topk),
            TFlat(DIM, metric=metric, dtype=dtype, capacity=capacity,
                  topk_method=topk, device="cpu"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("topk", ["exact", "fused"])
def test_flat_index_lifecycle_matches(rng, dtype, topk):
    j, t = _pair(dtype, topk)
    both = (j, t)
    x = _rows(rng, 50)
    sj, st = (ix.add_batch(x) for ix in both)
    np.testing.assert_array_equal(sj, st)
    upd = _rows(rng, 2)
    for ix in both:
        ix.update_slots(np.array([3, 7]), upd)
        ix.remove_slots(np.array([1, 2, 10]))
    reuse = [ix.add_batch(_rows(np.random.default_rng(1), 5)) for ix in both]
    np.testing.assert_array_equal(*reuse)
    assert set(reuse[1]) >= {1, 2, 10}
    grow = _rows(rng, 100)
    for ix in both:
        ix.add_batch(grow)
    assert j.capacity == t.capacity > 64 and j.count() == t.count() == 152
    q = _rows(rng, 6)
    _same(j.search(q, 10), t.search(q, 10), dtype)
    mask = rng.random(j.capacity) > 0.5
    _same(j.search(q, 5, slot_mask=mask), t.search(q, 5, slot_mask=mask),
          dtype)
    _, got = t.search(q, 5, slot_mask=mask)
    assert mask[got[got >= 0]].all()
    qs = _rows(rng, 6).reshape(2, 3, DIM)
    pj, pt = j.search_pipelined(qs, 4), t.search_pipelined(qs, 4)
    assert pt[0].shape == (2, 3, 4)
    _same(pj, pt, dtype)
    np.testing.assert_allclose(
        t.get_vectors(np.array([0, 5, 60])),
        j.get_vectors(np.array([0, 5, 60])), atol=TOL[dtype],
    )
    cj, ct = j.compact(), t.compact()
    np.testing.assert_array_equal(cj[0], ct[0])
    np.testing.assert_array_equal(cj[1], ct[1])
    _same(j.search(q, 10), t.search(q, 10), dtype)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_flat_ip_metric_and_k_beyond_live(rng, dtype):
    j, t = _pair(dtype, metric="ip")
    x = _rows(rng, 3) * 2.5
    for ix in (j, t):
        ix.add_batch(x)
    _same(j.search(x[:2], 8), t.search(x[:2], 8), dtype)
    _, got = t.search(x[:2], 8)
    assert (got[:, 3:] == -1).all()


def test_pipelined_unmaterialized_handle(rng):
    t = TFlat(DIM, capacity=64, device="cpu")
    t.add_batch(_rows(rng, 20))
    handle = t.search_pipelined(_rows(rng, 4).reshape(1, 4, DIM), 3,
                                materialize=False)
    assert all(isinstance(h, torch.Tensor)
               for h in (handle.scores, handle.ids))
    scores, slots = t.resolve_pipelined(handle)
    assert scores.shape == (1, 4, 3) and slots.dtype == np.int64


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_crosses_packages(rng, tmp_path, dtype, direction):
    j, t = _pair(dtype)
    src, dst = (j, t) if direction == "jax_to_torch" else (t, j)
    src.add_batch(_rows(rng, 40))
    src.remove_slots(np.array([4, 9]))
    path = str(tmp_path / "idx")
    src.save(path)
    assert dst.load(path)
    assert dst.count() == src.count() == 38
    assert dst._free == src._free and dst._next_slot == src._next_slot
    q = _rows(rng, 5)
    _same(j.search(q, 6), t.search(q, 6), dtype)


def test_unported_backends_raise(tmp_path):
    # the per-position backend stands in for orbax (store/persist.py):
    # it round-trips, and JAX's orbax directories are refused
    t = TFlat(DIM, capacity=64, device="cpu")
    t.persist_backend = "orbax"
    t.add_batch(_rows(np.random.default_rng(2), 5))
    t.save(str(tmp_path / "x"))
    back = TFlat(DIM, capacity=64, device="cpu")
    assert back.load(str(tmp_path / "x")) and back.count() == 5
    (tmp_path / "y.orbax").mkdir()
    (tmp_path / "y.meta.json").write_text(
        (tmp_path / "x.meta.json").read_text())
    with pytest.raises(ValueError, match="npz"):
        back.load(str(tmp_path / "y"))
    with pytest.raises(ValueError):
        TFlat(15, dtype="int4", device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_flat_index_from_jax_arrays(rng, dtype):
    j = JFlat(DIM, dtype=dtype, capacity=64)
    j.add_batch(_rows(rng, 30))
    j.remove_slots(np.array([0, 5]))
    arrays = {"slab": np.asarray(j._slab), "valid": np.asarray(j._valid)}
    if j._scales is not None:
        arrays["scales"] = np.asarray(j._scales)
    meta = {"dim": DIM, "dtype": dtype, "metric": "cosine", "size": j._size,
            "next_slot": j._next_slot, "free": list(j._free),
            "capacity": j.capacity}
    t = flat_index_from_arrays(arrays, meta, device="cpu")
    t.remove_slots(np.array([1]))  # writes must not reach the source arrays
    assert np.asarray(j._valid)[1]
    j.remove_slots(np.array([1]))
    if dtype == "bfloat16":  # bit for bit, via the uint16 view
        np.testing.assert_array_equal(
            t._slab.view(torch.int16).numpy(),
            arrays["slab"].view(np.int16),
        )
        t2 = flat_index_from_arrays(
            dict(arrays, slab=arrays["slab"].view(np.uint16)), meta,
            device="cpu",
        )
        assert torch.equal(t2._slab, t._slab)
    q = _rows(rng, 4)
    _same(j.search(q, 7), t.search(q, 7), dtype)
    row = _rows(rng, 1)
    np.testing.assert_array_equal(t.add_batch(row), j.add_batch(row))


def test_cow_writes_leave_a_snapshot_untouched(rng):
    t = TFlat(DIM, dtype="int8", capacity=64, device="cpu")
    t.add_batch(_rows(rng, 10))
    snap = (t._slab, t._valid, t._scales)
    before = [x.clone() for x in snap]
    t._cow_writes = True
    t.add_batch(_rows(rng, 3))
    t.update_slots(np.array([0]), _rows(rng, 1))
    t.remove_slots(np.array([1]))
    for held, was in zip(snap, before):
        assert torch.equal(held, was)
    assert t.count() == 12 and not bool(t._valid[1]) and bool(t._valid[12])
