"""Parity of the port's dense-table IVFIndex with wdbx_tpu's, on the CPU.

A JAX index is built (its k-means picks the layout) and carried into the
port with ``ivf_index_from_arrays``, so both serve the same slab, bucket
tables, centroids and residual list, and k-means randomness plays no
part. JAX's kernel path (``ivf_kernel="pallas"``) runs K5 in interpret
mode, the port's runs K5's plain version on the CPU. Hits must name the
same slots, except at ties, with the tolerances of test_torch_ops
(float32 1e-5; bf16 / int8 2e-2: the bucket tables are bf16 or int8
whatever the slab). The mutation script, checkpoints in both directions
and the JAX package's own behaviour cases of the dense engine follow.
"""

import numpy as np
import pytest
import torch

from test_torch_clustered import D, assert_same_search, mixture, set_both
from test_torch_ops import TOL, assert_topk_match
from wdbx_tpu.index import ivf as jivf
from wdbx_tpu.index.ivf import IVFIndex as JIndex
from wdbx_tpu_torch.convert import ivf_index_from_arrays
from wdbx_tpu_torch.index import ivf as tivf
from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex as TClustered
from wdbx_tpu_torch.index.ivf import IVFIndex as TIndex

torch.set_num_threads(2)


def jax_index(rng, dtype="float32", n=3000, nlist=16, nprobe=3,
              assignments=1, x=None):
    """A built JAX dense index over ``n`` mixture rows."""
    j = JIndex(D, dtype=dtype, nlist=nlist, nprobe=nprobe,
               train_threshold=256, capacity=4096, assignments=assignments)
    j.batch_flat_fallback = False  # the real bucket scan
    j.add_batch(mixture(rng, n) if x is None else x)
    j.build()
    return j


def carry(j) -> TIndex:
    """The JAX index's in-memory state, as numpy, into a port index."""
    arrays = {"slab": np.asarray(j._slab), "valid": np.asarray(j._valid),
              "residual": np.asarray(j._residual, np.int64)}
    if j._scales is not None:
        arrays["scales"] = np.asarray(j._scales)
    if j.is_trained:
        arrays.update(
            centroids=np.asarray(j._centroids),
            bucket_slot=np.asarray(j._bucket_slot),
            bucket_valid=np.asarray(j._bucket_valid),
            bucket_rows=np.asarray(j._bucket_rows),
        )
        if j._bucket_scale is not None:
            arrays["bucket_scale"] = np.asarray(j._bucket_scale)
    meta = dict(
        dim=j.dim, metric=j.metric, dtype=j.dtype_name, size=j._size,
        next_slot=j._next_slot, free=list(j._free), capacity=j._cap,
        nlist=j.nlist, nprobe=j.nprobe, assignments=j.assignments,
        built_size=j._built_size, residual_base=j._residual_base,
        quarantine=list(j._quarantine),
    )
    t = ivf_index_from_arrays(arrays, meta, device="cpu")
    t.batch_flat_fallback = j.batch_flat_fallback
    return t


def assert_same_state(j, t):
    assert t._residual == j._residual and t._quarantine == j._quarantine
    assert t._size == j._size and t._free == j._free
    assert t._next_slot == j._next_slot
    np.testing.assert_array_equal(np.asarray(t._valid), np.asarray(j._valid))
    if j.is_trained:
        np.testing.assert_array_equal(np.asarray(t._bucket_valid),
                                      np.asarray(j._bucket_valid))
        np.testing.assert_array_equal(np.asarray(t._bucket_slot),
                                      np.asarray(j._bucket_slot))
        np.testing.assert_array_equal(t._slot_bucket_c, j._slot_bucket_c)
        np.testing.assert_array_equal(t._slot_bucket_p, j._slot_bucket_p)


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _port(**kw) -> TIndex:
    return TIndex(device="cpu", **kw)


# -- helpers -----------------------------------------------------------------


def test_helpers_match(rng):
    assign = rng.integers(0, 8, (500, 4)).astype(np.int32)
    assign[:300, 0] = 2  # a hot bucket: spills to later choices
    for got, want in zip(tivf._capped_placement(assign, 8),
                         jivf._capped_placement(assign, 8)):
        np.testing.assert_array_equal(got, want)
    slots = rng.permutation(np.repeat(np.arange(40), 2)).astype(np.int32)
    cs = rng.integers(0, 8, 80).astype(np.int32)
    ps = rng.integers(0, 50, 80).astype(np.int32)
    for got, want in zip(tivf._pack_slot_positions(slots, cs, ps, 64, 2),
                         jivf._pack_slot_positions(slots, cs, ps, 64, 2)):
        np.testing.assert_array_equal(got, want)
    scores = -np.sort(rng.random((5, 12)).astype(np.float32), axis=1)
    scores[1, 8:] = -np.inf
    dup = rng.integers(-1, 6, (5, 12))
    for got, want in zip(tivf._dedup_rows(scores, dup, 6),
                         jivf._dedup_rows(scores, dup, 6)):
        np.testing.assert_array_equal(got, want)
    bv = rng.random((8, 32)) > 0.3
    bs = rng.integers(0, 100, (8, 32)).astype(np.int32)
    bs[~bv] = 100  # pads: the slab capacity
    mask = rng.random(100) > 0.5
    got = tivf._mask_bucket_valid_body(torch.from_numpy(bv),
                                       torch.from_numpy(bs),
                                       torch.from_numpy(mask))
    want = jivf._mask_bucket_valid_body(bv, bs, mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- search paths on a carried layout -----------------------------------------


@pytest.mark.parametrize("kernel", ["lax", "pallas"])
@pytest.mark.parametrize("b", [1, 4, 8])
def test_search_paths_match(rng, kernel, b):
    j = jax_index(rng)
    t = carry(j)
    set_both(j, t, ivf_kernel=kernel)
    assert t._use_pallas(10) == (kernel == "pallas")
    assert_same_search(j, t, mixture(rng, b), 10, TOL["float32"])


@pytest.mark.parametrize("kernel", ["lax", "pallas"])
@pytest.mark.parametrize("frac", [0.1, 0.01])
def test_filtered_search_matches(rng, kernel, frac):
    """10% pushes the mask into the bucket tables (nprobe boosted); 1%
    takes the exact masked scan."""
    j = jax_index(rng, nprobe=1)
    t = carry(j)
    set_both(j, t, ivf_kernel=kernel)
    mask = rng.random(4096) < frac
    _, it = assert_same_search(j, t, mixture(rng, 8), 10, TOL["float32"],
                               slot_mask=mask)
    assert mask[it[it >= 0]].all()


def test_deep_k_takes_the_lax_scan(rng):
    j = jax_index(rng)
    t = carry(j)
    set_both(j, t, ivf_kernel="pallas")
    assert not t._use_pallas(150) and t._use_pallas(128)
    assert_same_search(j, t, mixture(rng, 4), 150, TOL["float32"])


@pytest.mark.parametrize("kernel", ["lax", "pallas"])
def test_int8_tables_take_the_lax_scan(rng, kernel):
    j = jax_index(rng, "int8")
    t = carry(j)
    set_both(j, t, ivf_kernel=kernel)
    assert t._bucket_rows.dtype == torch.int8 and not t._use_pallas(10)
    assert_same_search(j, t, mixture(rng, 8), 10, TOL["int8"])


@pytest.mark.parametrize("kernel", ["lax", "pallas"])
def test_soar_multi_assignment_matches(rng, kernel):
    j = jax_index(rng, assignments=2)
    t = carry(j)
    set_both(j, t, ivf_kernel=kernel)
    assert (t._slot_bucket_c[: j._next_slot] >= 0).all()
    _, it = assert_same_search(j, t, mixture(rng, 8), 10, TOL["float32"])
    for row in it:
        live = row[row >= 0]
        assert len(live) == len(set(live.tolist()))


def test_search_pipelined_and_handles_match(rng):
    j = jax_index(rng, assignments=2)
    t = carry(j)
    qs = mixture(rng, 16).reshape(2, 8, D)
    sj, ij = j.search_pipelined(qs, 10)
    st, it = t.search_pipelined(qs, 10)
    assert st.shape == (2, 8, 10)
    assert_topk_match(sj, ij, st, it, TOL["float32"])
    handle = t.search_pipelined(torch.from_numpy(qs), 10, materialize=False)
    assert isinstance(handle.scores, torch.Tensor)
    s2, i2 = t.resolve_pipelined(handle)
    np.testing.assert_array_equal(i2, it)
    np.testing.assert_array_equal(s2, st)
    # an untrained index hands out the flat route's pending result
    u = _port(dim=D, train_threshold=1 << 20)
    u.add_batch(qs.reshape(-1, D))
    hu = u.search_pipelined(qs, 3, materialize=False)
    assert isinstance(hu.ids, torch.Tensor)
    np.testing.assert_array_equal(u.resolve_pipelined(hu)[1],
                                  u.search_pipelined(qs, 3)[1])


# -- mutation and persistence -----------------------------------------------


def mutate(idx, fresh, moved):
    """Deletes (quarantine + bucket invalidation), fresh adds (residual),
    updates of bucketed and fresh rows, a delete of a fresh row."""
    idx.remove_slots(np.arange(40, 80))
    added = idx.add_batch(fresh)
    idx.update_slots(np.array([3, 5, 7, int(added[0])]), moved)
    idx.remove_slots(np.array([int(added[1]), 9]))
    return added


@pytest.mark.parametrize("dtype,assignments", [("float32", 1), ("int8", 1),
                                               ("bfloat16", 2)])
def test_mutation_script_matches(rng, dtype, assignments):
    j = jax_index(rng, dtype, assignments=assignments)
    t = carry(j)
    fresh, moved = mixture(rng, 30), mixture(rng, 4)
    np.testing.assert_array_equal(mutate(t, fresh, moved),
                                  mutate(j, fresh, moved))
    assert_same_state(j, t)
    assert len(t._quarantine) == 42 and not t._needs_build()
    q = np.concatenate([mixture(rng, 4), fresh[:2], moved[:2]])
    for kernel in ("lax", "pallas"):
        set_both(j, t, ivf_kernel=kernel)
        _, it = assert_same_search(j, t, q, 10, TOL[dtype])
        assert not set(it.ravel().tolist()) & set(range(40, 80))


def test_rebuild_trigger_matches(rng):
    """Residual growth past rebuild_fraction rebuilds on the next search
    in both packages: quarantined slots return to the free list and the
    residual empties. Full probe on a bf16 slab makes the search exact
    over the same rows whatever each k-means picked."""
    x = mixture(rng, 3000)
    j = jax_index(rng, "bfloat16", x=x)
    t = carry(j)
    fresh, moved, extra = mixture(rng, 30), mixture(rng, 4), mixture(rng, 700)
    mutate(j, fresh, moved)
    mutate(t, fresh, moved)
    for idx in (j, t):
        idx.add_batch(extra)
        assert idx._needs_build()
        idx.nprobe = idx.nlist
    q = mixture(rng, 8)
    sj, ij = j.search(q, 10)
    st, it = t.search(q, 10)
    for idx in (j, t):
        assert idx._residual == [] and idx._quarantine == []
        assert idx._built_size == idx._size
    assert sorted(t._free) == sorted(j._free)
    assert_topk_match(sj, ij, st, it, TOL["bfloat16"])


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("dtype,assignments", [("float32", 2), ("int8", 1)])
def test_save_load_across_packages(tmp_path, rng, direction, dtype,
                                   assignments):
    j = jax_index(rng, dtype, assignments=assignments)
    fresh, moved = mixture(rng, 30), mixture(rng, 4)
    path = str(tmp_path / "ck")
    if direction == "jax_to_torch":
        mutate(j, fresh, moved)
        j.save(path)
        t = _port(dim=D, dtype=dtype, assignments=assignments)
        assert t.load(path)
    else:
        t = carry(j)
        mutate(t, fresh, moved)
        t.save(path)
        mutate(j, fresh, moved)
        j2 = JIndex(D, dtype=dtype, assignments=assignments)
        assert j2.load(path)
        assert_same_state(j, j2)
        j = j2
    assert t.is_trained and t.nprobe == j.nprobe == 3
    assert t._bucket_rows.dtype == {"float32": torch.bfloat16,
                                    "int8": torch.int8}[dtype]
    assert_same_state(j, t)
    set_both(j, t, batch_flat_fallback=False, ivf_kernel="pallas")
    assert_same_search(j, t, mixture(rng, 8), 10, TOL[dtype])


def test_untrained_checkpoint_round_trips(tmp_path, rng):
    x = mixture(rng, 100)
    t = _port(dim=D, train_threshold=1 << 20)
    slots = t.add_batch(x)
    t.save(str(tmp_path / "u"))
    t2 = _port(dim=D, train_threshold=1 << 20)
    assert t2.load(str(tmp_path / "u"))
    assert not t2.is_trained and t2.count() == 100
    _, got = t2.search(x[:4], 1)
    np.testing.assert_array_equal(got[:, 0], slots[:4])
    j = JIndex(D, train_threshold=1 << 20)
    assert j.load(str(tmp_path / "u")) and j.count() == 100


def test_dense_checkpoint_adopts_into_clustered(rng, tmp_path):
    dense = _port(dim=16, nlist=4, nprobe=4, train_threshold=64)
    db = _normed(rng, 200, 16)
    slots = dense.add_batch(db)
    dense.build()
    path = str(tmp_path / "dense_ckpt")
    dense.save(path)
    clu = TClustered(16, nlist=4, nprobe=4, train_threshold=64,
                     device="cpu")
    assert clu.load(path)
    assert clu.count() == 200
    _, got = clu.search(db[:4], 1)
    assert (got.ravel() == slots[:4]).all()


# -- the JAX package's behaviour cases, against the port ----------------------


def test_recall_vs_exact(rng):
    n, d, k = 20_000, 64, 10
    centers = _normed(rng, 128, d)
    noise = 0.4 / np.sqrt(d)
    db = centers[rng.integers(0, 128, n)] + noise * rng.standard_normal(
        (n, d)).astype(np.float32)
    db /= np.linalg.norm(db, axis=-1, keepdims=True)
    queries = db[rng.integers(0, n, 32)] + noise * rng.standard_normal(
        (32, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=-1, keepdims=True)
    ivf = _port(dim=d, nlist=64, nprobe=8, train_threshold=1000, capacity=n)
    slots = ivf.add_batch(db)
    ivf.build()
    _, got = ivf.search(queries, k=k)
    exact = slots[np.argsort(-(queries @ db.T), axis=-1)[:, :k]]
    recall = np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                      for a, b in zip(got, exact)])
    assert recall >= 0.9, recall


def test_tune_hits_target_recall(rng):
    n, d, k = 5000, 32, 10
    db = _normed(rng, n, d)
    queries = _normed(rng, 16, d)
    ivf = _port(dim=d, nlist=32, nprobe=1, train_threshold=1000)
    slots = ivf.add_batch(db)
    ivf.build()
    assert ivf.tune(queries, k=k, target_recall=0.95) >= 0.95
    _, got = ivf.search(queries, k=k)
    exact = slots[np.argsort(-(queries @ db.T), axis=-1)[:, :k]]
    assert np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                    for a, b in zip(got, exact)]) >= 0.9
    # tune_filtered pins a factor for the mask's selectivity bin
    mask = np.arange(n) % 4 == 0
    assert ivf.tune_filtered(queries, mask, k=k, target_recall=0.9) >= 0.9
    assert ivf._filter_boosts


def test_untrained_falls_back_to_flat(rng):
    ivf = _port(dim=16, train_threshold=10_000)
    vecs = _normed(rng, 100, 16)
    slots = ivf.add_batch(vecs)
    assert not ivf.is_trained
    _, got = ivf.search(vecs[:3], k=1)
    np.testing.assert_array_equal(got[:, 0], slots[:3])


def test_auto_train_on_search(rng):
    ivf = _port(dim=16, nlist=8, train_threshold=256)
    ivf.add_batch(_normed(rng, 300, 16))
    ivf.search(_normed(rng, 1, 16), k=5)
    assert ivf.is_trained


@pytest.mark.parametrize("kernel", ["lax", "pallas"])
def test_fresh_buffer_adds_visible(rng, kernel):
    ivf = _port(dim=16, nlist=8, train_threshold=64)
    ivf.ivf_kernel = kernel
    ivf.add_batch(_normed(rng, 100, 16))
    ivf.build()
    late = _normed(rng, 5, 16)
    late_slots = ivf.add_batch(late)
    scores, got = ivf.search(late, k=1)
    np.testing.assert_array_equal(got[:, 0], late_slots)
    np.testing.assert_allclose(scores[:, 0], 1.0, rtol=1e-4)


def test_delete_after_build_invisible_and_no_duplicates(rng):
    ivf = _port(dim=16, nlist=4, train_threshold=32)
    vecs = _normed(rng, 64, 16)
    slots = ivf.add_batch(vecs)
    ivf.build()
    ivf.remove_slots(slots[:1])
    _, got = ivf.search(vecs[0], k=5)
    assert slots[0] not in got[0]
    ivf.remove_slots(slots[1:8])
    ivf.add_batch(_normed(rng, 8, 16))
    _, got = ivf.search(vecs[8:12], k=10)
    for row in got:
        live = [s for s in row if s >= 0]
        assert len(live) == len(set(live))


def test_rebuild_absorbs_residual(rng):
    ivf = _port(dim=16, nlist=4, train_threshold=32, rebuild_fraction=0.1)
    ivf.add_batch(_normed(rng, 64, 16))
    ivf.build()
    ivf.add_batch(_normed(rng, 32, 16))  # > 10% of built size
    ivf.search(_normed(rng, 1, 16), k=1)  # triggers rebuild
    assert len(ivf._residual) == 0
    assert ivf._built_size == 96


@pytest.mark.parametrize("kernel", ["lax", "pallas"])
def test_slot_mask_filters_bucket_rows(rng, kernel):
    ivf = _port(dim=16, nlist=4, train_threshold=32)
    ivf.batch_flat_fallback = False
    ivf.ivf_kernel = kernel
    vecs = _normed(rng, 64, 16)
    slots = ivf.add_batch(vecs)
    ivf.build()
    mask = np.zeros(ivf.capacity, bool)
    allowed = set(int(s) for s in slots[::2])
    mask[list(allowed)] = True
    ivf.nprobe = 4
    _, got = ivf.search(vecs[:16], k=8, slot_mask=mask)
    for row in got:
        for s in row:
            assert s < 0 or int(s) in allowed, s
    _, got_self = ivf.search(vecs[::2][:4], k=1, slot_mask=mask)
    np.testing.assert_array_equal(got_self[:, 0], slots[::2][:4])


def test_int8_ip_bucket_residual_consistent(rng):
    ivf = _port(dim=16, metric="ip", dtype="int8", nlist=2,
                train_threshold=16)
    ivf.batch_flat_fallback = False
    base = _normed(rng, 48, 16)
    vecs = base * rng.uniform(0.5, 2.0, size=(48, 1)).astype(np.float32)
    ivf.add_batch(vecs)
    ivf.build()
    fresh = ivf.add_batch(vecs[:4] * 3.0)
    ivf.nprobe = 2
    _, got = ivf.search(base[:4], k=2)
    np.testing.assert_array_equal(got[:, 0], fresh)


def test_persistence_roundtrip(rng, tmp_path):
    ivf = _port(dim=16, nlist=4, train_threshold=32)
    vecs = _normed(rng, 64, 16)
    slots = ivf.add_batch(vecs)
    ivf.build()
    ivf.add_batch(_normed(rng, 3, 16))
    ivf.save(str(tmp_path / "ivf"))
    ivf2 = _port(dim=16)
    assert ivf2.load(str(tmp_path / "ivf"))
    assert ivf2.is_trained and ivf2.count() == 67
    _, got = ivf2.search(vecs[:4], k=1)
    np.testing.assert_array_equal(got[:, 0], slots[:4])


def test_update_after_build_visible_with_new_value(rng):
    ivf = _port(dim=16, nlist=4, train_threshold=32)
    vecs = _normed(rng, 64, 16)
    slots = ivf.add_batch(vecs)
    ivf.build()
    new_vec = _normed(rng, 1, 16)
    ivf.update_slots(slots[:1], new_vec)
    scores, got = ivf.search(new_vec, k=1)
    assert got[0, 0] == slots[0]
    np.testing.assert_allclose(scores[0, 0], 1.0, rtol=1e-3)
    _, got_old = ivf.search(vecs[0], k=64)
    assert [int(s) for s in got_old[0]].count(slots[0]) <= 1


def _scan_index(rng, n=2000, d=32, nlist=64, nprobe=8, kernel="lax"):
    ivf = _port(dim=d, nlist=nlist, nprobe=nprobe, train_threshold=10**9,
                capacity=n)
    ivf.batch_flat_fallback = False
    ivf.ivf_kernel = kernel
    vecs = _normed(rng, n, d)
    slots = ivf.add_batch(vecs)
    ivf.build()
    return ivf, vecs, slots


@pytest.mark.parametrize("kernel", ["lax", "pallas"])
def test_scan_self_query_deletes_adds_updates(rng, kernel):
    ivf, vecs, slots = _scan_index(rng, kernel=kernel)
    scores, got = ivf.search(vecs[:4], k=1)
    np.testing.assert_array_equal(got[:, 0], slots[:4])
    np.testing.assert_allclose(scores[:, 0], 1.0, rtol=4e-3)  # bf16 tables
    ivf.remove_slots(slots[:1])
    _, got = ivf.search(vecs[0], k=10)
    assert slots[0] not in got[0]
    late = _normed(rng, 3, 32)
    late_slots = ivf.add_batch(late)
    _, got = ivf.search(late, k=1)
    np.testing.assert_array_equal(got[:, 0], late_slots)
    new_vec = _normed(rng, 1, 32)
    ivf.update_slots(slots[1:2], new_vec)
    scores, got = ivf.search(new_vec, k=1)
    assert got[0, 0] == slots[1]
    np.testing.assert_allclose(scores[0, 0], 1.0, rtol=1e-3)


def test_scan_full_probe_is_exact(rng):
    ivf, vecs, slots = _scan_index(rng, nprobe=64)
    q = _normed(rng, 4, 32)
    _, got = ivf.search(q, k=10)
    exact = slots[np.argsort(-(q @ vecs.T), axis=-1)[:, :10]]
    for a, b in zip(got, exact):
        assert set(a.tolist()) == set(b.tolist())


def test_pallas_matches_lax(rng):
    ivf = _port(dim=64, nlist=16, nprobe=4, train_threshold=10**9,
                capacity=4096)
    ivf.batch_flat_fallback = False
    ivf.add_batch(_normed(rng, 4000, 64))
    ivf.build()
    q = _normed(rng, 4, 64)
    _, got_lax = ivf.search(q, k=10)
    ivf.ivf_kernel = "pallas"
    _, got_pl = ivf.search(q, k=10)
    for a, b in zip(got_lax, got_pl):
        assert set(a.tolist()) == set(b.tolist())


def test_soar_improves_recall_at_fixed_nprobe(rng):
    n, d, k = 20_000, 64, 10
    db = _normed(rng, n, d)
    queries = _normed(rng, 32, d)
    exact = np.argsort(-(queries @ db.T), axis=-1)[:, :k]
    recalls = {}
    for a in (1, 2):
        ivf = _port(dim=d, nlist=64, nprobe=8, train_threshold=10**9,
                    capacity=n, assignments=a)
        ivf.batch_flat_fallback = False
        slots = ivf.add_batch(db)
        ivf.build()
        _, got = ivf.search(queries, k=k)
        recalls[a] = np.mean([len(set(x.tolist()) & set(y.tolist())) / k
                              for x, y in zip(got, slots[exact])])
    assert recalls[2] > recalls[1]


@pytest.mark.parametrize("kernel", ["lax", "pallas"])
def test_multi_assignment_no_duplicates_and_delete_removes_all_copies(
        rng, kernel):
    ivf = _port(dim=16, nlist=4, nprobe=4, train_threshold=10**9,
                assignments=2)
    ivf.batch_flat_fallback = False
    ivf.ivf_kernel = kernel
    vecs = _normed(rng, 300, 16)
    slots = ivf.add_batch(vecs)
    ivf.build()
    _, got = ivf.search(vecs[:8], k=10)
    for row in got:
        live = [s for s in row if s >= 0]
        assert len(live) == len(set(live))
    assert (got[:, 0] == slots[:8]).all()
    ivf.remove_slots(slots[:1])
    _, got = ivf.search(vecs[0], k=20)
    assert slots[0] not in got[0]


def test_ivf_int8_end_to_end(rng):
    ivf = _port(dim=32, dtype="int8", nlist=8, nprobe=8,
                train_threshold=10**9)
    ivf.batch_flat_fallback = False
    vecs = _normed(rng, 600, 32)
    slots = ivf.add_batch(vecs)
    ivf.build()
    scores, got = ivf.search(vecs[:8], k=1)
    np.testing.assert_array_equal(got[:, 0], slots[:8])
    np.testing.assert_allclose(scores[:, 0], 1.0, atol=0.03)
    late = _normed(rng, 2, 32)
    late_slots = ivf.add_batch(late)
    scores, got = ivf.search(late, k=1)
    np.testing.assert_array_equal(got[:, 0], late_slots)
    np.testing.assert_allclose(scores[:, 0], 1.0, atol=0.03)


def test_ivf_search_pipelined_matches_search(rng):
    ivf = _port(dim=16, nlist=8, train_threshold=64)
    ivf.batch_flat_fallback = False
    vecs = _normed(rng, 400, 16)
    ivf.add_batch(vecs)
    ivf.build()
    ivf.nprobe = 8
    qs = vecs[:24].reshape(3, 8, 16)
    s3, i3 = ivf.search_pipelined(qs, k=4)
    assert s3.shape == (3, 8, 4)
    for nbatch in range(3):
        _, i1 = ivf.search(qs[nbatch], k=4)
        np.testing.assert_array_equal(i3[nbatch], i1[:, :4])
    handles = [ivf.search_pipelined(qs, k=4, materialize=False)
               for _ in range(2)]
    for h in handles:
        np.testing.assert_array_equal(ivf.resolve_pipelined(h)[1], i3)
    fresh = _port(dim=16, train_threshold=10**9)
    fresh.add_batch(vecs[:64])
    assert fresh.search_pipelined(qs, k=2)[0].shape == (3, 8, 2)


def test_ivf_int8_tables_stay_int8(rng, tmp_path):
    ivf = _port(dim=16, dtype="int8", nlist=4, train_threshold=32)
    ivf.batch_flat_fallback = False
    vecs = _normed(rng, 128, 16)
    slots = ivf.add_batch(vecs)
    ivf.build()
    assert ivf._bucket_rows.dtype == torch.int8
    assert ivf._bucket_scale is not None
    ivf.nprobe = 4
    _, got = ivf.search(vecs[:8], k=1)
    np.testing.assert_array_equal(got[:, 0], slots[:8])
    ivf.save(str(tmp_path / "i8ivf"))
    ivf2 = _port(dim=16, dtype="int8")
    assert ivf2.load(str(tmp_path / "i8ivf"))
    assert ivf2._bucket_rows.dtype == torch.int8
    assert ivf2._bucket_scale is not None
    ivf2.batch_flat_fallback = False
    ivf2.nprobe = 4
    _, got2 = ivf2.search(vecs[:8], k=1)
    np.testing.assert_array_equal(got2[:, 0], slots[:8])


def test_spill_does_not_trigger_rebuild_loop(rng):
    vecs = _normed(rng, 300, 16)
    ivf = _port(dim=16, nlist=8, train_threshold=64, rebuild_fraction=0.2)
    ivf.batch_flat_fallback = False
    slots = ivf.add_batch(vecs)
    ivf.build()
    bv = ivf._bucket_valid.numpy()
    assert bv.shape[1] >= 128 and bv.sum(1).max() <= bv.shape[1]
    ivf._residual = [int(s) for s in slots[:100]]
    ivf._residual_base = 100
    assert not ivf._needs_build()
    ivf._residual.extend(int(s) for s in slots[100:200])
    assert ivf._needs_build()
    ivf._residual = [int(s) for s in slots[:100]]
    ivf._residual_base = 100
    _, got = ivf.search(vecs[:4], k=1)
    np.testing.assert_array_equal(got[:, 0], slots[:4])


def test_ivf_pipelined_dedups_multi_assignment(rng):
    ivf = _port(dim=16, nlist=8, train_threshold=64, assignments=2)
    ivf.batch_flat_fallback = False
    vecs = _normed(rng, 400, 16)
    ivf.add_batch(vecs)
    ivf.build()
    ivf.nprobe = 8
    _, got = ivf.search_pipelined(vecs[:16].reshape(2, 8, 16), k=4)
    for row in got.reshape(-1, 4):
        live = [int(s) for s in row if s >= 0]
        assert len(live) == len(set(live)), row


def test_ivf_compact_rebuilds_overlay(rng):
    ivf = _port(dim=16, nlist=4, train_threshold=32)
    vecs = _normed(rng, 64, 16)
    slots = ivf.add_batch(vecs)
    ivf.build()
    ivf.remove_slots(slots[:32])
    old, new = ivf.compact()
    assert ivf.count() == 32 and ivf.is_trained
    remap = dict(zip(old.tolist(), new.tolist()))
    _, got = ivf.search(vecs[40], k=1)
    assert got[0, 0] == remap[slots[40]]
