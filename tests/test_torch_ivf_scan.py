"""K5, the IVF bucket scan: the port's plain version against wdbx_tpu's
Pallas kernel in interpret mode, on the CPU.

The same seeded numpy table (nlist 16, C 256, d 64, ~10% of rows
invalid, one bucket with fewer valid rows than k, one with none), the
same queries and the same (query, probe) pairs, repeated buckets
included, go through JAX's ``ivf_bucket_scan(interpret=True)`` and the
port's. JAX's ``NEG`` sentinel counts as -inf and its position there as
-1. Tolerances are test_torch_ops.TOL: float32 1e-5, bf16 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import TOL, assert_topk_match
from wdbx_tpu.kernels.ivf_scan import ivf_bucket_scan as j_scan
from wdbx_tpu_torch.kernels import ivf_scan as tk

torch.set_num_threads(2)

NLIST, C, D = 16, 256, 64
FEW, EMPTY = 3, 7  # buckets with 5 valid rows and with none


def _case(rng, dtype):
    x = rng.standard_normal((NLIST, C, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    valid = rng.random((NLIST, C)) > 0.1
    valid[FEW] = False
    valid[FEW, rng.choice(C, 5, replace=False)] = True
    valid[EMPTY] = False
    q = rng.standard_normal((6, D)).astype(np.float32)
    # 6 queries x 4 probes; bucket 2 and the sparse buckets repeat
    probes = np.array([2, FEW, 5, 9, 2, EMPTY, 11, 0, FEW, 2, 14, 15,
                       8, 2, 1, 4, 6, 12, 13, 10, 2, 3, 7, 9], np.int32)
    qidx = np.repeat(np.arange(6, dtype=np.int32), 4)
    jt = jnp.asarray(x, getattr(jnp, dtype))
    tt = torch.from_numpy(x).to(getattr(torch, dtype))
    return jt, tt, valid, q, probes, qidx


def _jax(jt, valid, q, probes, qidx, k):
    valid8 = np.broadcast_to(valid[:, None, :].astype(np.int8),
                             (NLIST, 8, C))
    v, p = j_scan(jt, jnp.asarray(valid8), jnp.asarray(probes),
                  jnp.asarray(qidx), jnp.asarray(q), k=k, interpret=True)
    v, p = np.asarray(v), np.asarray(p).astype(np.int64)
    empty = v <= -3.0e38
    return np.where(empty, -np.inf, v), np.where(empty, -1, p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 10, 128])
def test_plain_matches_pallas_interpret(rng, dtype, k):
    jt, tt, valid, q, probes, qidx = _case(rng, dtype)
    sj, pj = _jax(jt, valid, q, probes, qidx, k)
    st, pt = tk.ivf_bucket_scan(tt, torch.from_numpy(valid),
                                torch.from_numpy(probes),
                                torch.from_numpy(qidx), torch.from_numpy(q),
                                k=k)
    assert st.dtype == torch.float32 and pt.dtype == torch.int64
    assert st.shape == pt.shape == (len(probes), k)
    assert_topk_match(sj, pj, st.numpy(), pt.numpy(), TOL[dtype])
    empty = probes == EMPTY
    assert np.isneginf(st.numpy()[empty]).all()
    assert (pt.numpy()[empty] == -1).all()
    live_few = np.isfinite(st.numpy()[probes == FEW]).sum(axis=1)
    np.testing.assert_array_equal(live_few, min(k, 5))
    # every returned position is a valid row of the pair's own bucket
    got = pt.numpy()
    ok = got >= 0
    assert valid[np.broadcast_to(probes[:, None], got.shape)[ok],
                 got[ok]].all()


def test_replicated_validity_table_is_read(rng):
    """JAX's 8x-replicated int8 table gives the same result as the
    (nlist, C) bool table."""
    _, tt, valid, q, probes, qidx = _case(rng, "bfloat16")
    args = (torch.from_numpy(probes), torch.from_numpy(qidx),
            torch.from_numpy(q))
    valid8 = torch.from_numpy(valid)[:, None, :].expand(NLIST, 8, C)
    a = tk.ivf_bucket_scan(tt, torch.from_numpy(valid), *args, k=10)
    b = tk.ivf_bucket_scan(tt, valid8.to(torch.int8), *args, k=10)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_rejects_deep_k_and_int8_tables(rng):
    _, tt, valid, q, probes, qidx = _case(rng, "float32")
    args = (torch.from_numpy(valid), torch.from_numpy(probes),
            torch.from_numpy(qidx), torch.from_numpy(q))
    with pytest.raises(ValueError, match="k <= 128"):
        tk.ivf_bucket_scan(tt, *args, k=129)
    with pytest.raises(TypeError, match="float bucket table"):
        tk.ivf_bucket_scan(tt.to(torch.int8), *args, k=10)
    # the same contract as the JAX kernel's
    with pytest.raises(ValueError, match="k <= 128"):
        j_scan(jnp.asarray(tt.numpy()), jnp.zeros((NLIST, 8, C), jnp.int8),
               jnp.asarray(probes), jnp.asarray(qidx), jnp.asarray(q), k=129,
               interpret=True)


@pytest.mark.parametrize("s,c", [(1, 1408), (8, 1408), (512, 1408),
                                 (4096, 128), (3, 100), (9, 1408),
                                 (576, 1408), (1152, 1408), (200000, 4096)])
def test_plan_covers_each_bucket_in_whole_warp_groups(s, c):
    """Both stage-1 plans cover every row once, in 32-row groups. The
    per-pair grid holds about four CTAs per SM of a 132-SM card when the
    pairs are few; the grouped body's parts hold at most 64 groups and
    give about UNITS_PER_WARP units per resident warp (1,584 here) while
    the bucket has groups to spare."""
    splits, rows = tk.plan(s, c, 132)
    assert rows % 32 == 0 and splits * rows >= c > (splits - 1) * rows
    assert s * splits >= min(4 * 132, s * -(-c // 32))
    warps = 1584
    parts, rows = tk.plan_grouped(s, c, warps)
    groups = -(-c // 32)
    assert rows % 32 == 0 and rows <= 64 * 32
    assert parts * rows >= c > (parts - 1) * rows
    assert s * parts >= min(tk.UNITS_PER_WARP * warps, s * groups) // 2


def _ids(rng, s, nlist, b):
    probes = rng.integers(0, nlist, s).astype(np.int32)
    qidx = rng.integers(0, b, s).astype(np.int32)
    return torch.from_numpy(probes), torch.from_numpy(qidx)


def _check_grouping(probes, qidx, nlist, b, g):
    """The plain grouping's contract: every pair once, each item one
    bucket (-1 for out-of-range ids) and 1..g pairs, a bucket's pairs in
    ceil(n / g) items, items in bucket order, stable within a bucket."""
    order, items, n = tk.group_pairs_plain(probes, qidx, nlist, b, g)
    assert order.dtype == items.dtype == torch.int32
    assert items.shape == (n, 3)
    assert sorted(order.tolist()) == list(range(probes.shape[0]))
    p, q = probes.long(), qidx.long()
    ok = (p >= 0) & (p < nlist) & (q >= 0) & (q < b)
    want = torch.where(ok, p, -1)
    pos = 0
    for bucket, start, count in items.tolist():
        assert start == pos and 1 <= count <= g
        pairs = order[start:start + count].long()
        assert (want[pairs] == bucket).all()
        assert (torch.diff(pairs) > 0).all()
        pos += count
    assert pos == probes.shape[0]
    buckets = items[:, 0].tolist()
    key = [nlist if x < 0 else x for x in buckets]
    assert key == sorted(key)
    for bucket in set(buckets):
        n_pairs = int((want == bucket).sum())
        assert buckets.count(bucket) == -(-n_pairs // g)
    return order, items


@pytest.mark.parametrize("g", [1, 2, 3, 8])
@pytest.mark.parametrize("s,nlist", [(1, 16), (24, 16), (576, 1024),
                                     (5000, 64)])
def test_group_pairs_plain(rng, g, s, nlist):
    probes, qidx = _ids(rng, s, nlist, 6)
    _check_grouping(probes, qidx, nlist, 6, g)


def test_group_pairs_splits_crowded_buckets_and_duplicates(rng):
    """128 queries probing the same 8 buckets, and repeated (query,
    probe) pairs: each bucket's 128 pairs split into items of g, each
    duplicate kept as a pair of its own."""
    probes = torch.arange(8, dtype=torch.int32).repeat(128)
    qidx = torch.arange(128, dtype=torch.int32).repeat_interleave(8)
    probes = torch.cat([probes, probes[:16]])
    qidx = torch.cat([qidx, qidx[:16]])
    _, items = _check_grouping(probes, qidx, 64, 128, 3)
    assert items.shape[0] == 8 * -(-130 // 3)
    assert items[:, 2].max() == 3


def test_group_pairs_marks_out_of_range_ids(rng):
    probes, qidx = _ids(rng, 40, 16, 6)
    probes[3], probes[7], qidx[11] = 16, -2, 6
    order, items = _check_grouping(probes, qidx, 16, 6, 2)
    dead = [set(order[st:st + n].tolist())
            for bk, st, n in items.tolist() if bk < 0]
    assert set().union(*dead) == {3, 7, 11}
    assert items[-1, 0] == -1  # the out-of-range bin comes last


@pytest.mark.parametrize("key,d,offset,want", [
    ("bfloat16", 384, 0, "grouped"), ("float32", 384, 0, "grouped"),
    ("bfloat16", 768, 0, "grouped"), ("float32", 100, 0, "grouped"),
    ("bfloat16", 100, 0, "pair"), ("float32", 98, 0, "pair"),
    ("bfloat16", 384, 2, "pair"), ("float32", 384, 8, "pair"),
    ("bfloat16", 16384, 0, "pair"),
])
def test_pick_body_by_shape(key, d, offset, want):
    """Whole 16-byte rows of an aligned table whose query and buffer fit
    take the grouped body; ragged widths, unaligned views and very wide
    rows take the per-pair body."""
    assert tk.pick_body(key, d, 4096 + offset) == want


@pytest.mark.parametrize("d", [8, 100, 384, 768, 1536, 4096])
@pytest.mark.parametrize("k", [1, 10, 50, 128])
def test_group_size_fits_the_warp_budget(d, k):
    g = tk.group_size(d, k)
    assert 1 <= g <= 8
    assert g == 1 or tk._warp_bytes(d, k, g) <= tk._WARP_BUDGET
    assert g == 8 or tk._warp_bytes(d, k, g + 1) > tk._WARP_BUDGET
    assert 4 * tk._warp_bytes(d, k, 1) <= tk._SMEM_MAX or \
        tk.pick_body("float32", d, 0) == "pair"


def _grouped_layout(rows, valid, probes, qidx, q, k, g, parts, prow):
    """The grouped body's partials on the CPU: per item and part, each of
    its pairs' k best rows of the part, at the pair's own index of the
    (S, parts, k) layout; out-of-range items write -inf / -1."""
    nlist, c, _ = rows.shape
    order, items, _ = tk.group_pairs_plain(probes, qidx, nlist, q.shape[0], g)
    pv = torch.full((probes.shape[0], parts, k), float("-inf"))
    pi = torch.full((probes.shape[0], parts, k), -1, dtype=torch.int32)
    qf = q.to(rows.dtype).float()
    for bucket, start, count in items.tolist():
        if bucket < 0:
            continue
        pairs = order[start:start + count].long()
        sc = qf[qidx[pairs].long()] @ rows[bucket].float().T
        sc = torch.where(valid[bucket], sc, float("-inf"))
        for part in range(parts):
            lo, hi = part * prow, min(c, (part + 1) * prow)
            v, i = torch.topk(sc[:, lo:hi], min(k, hi - lo), dim=1)
            pv[pairs, part, :v.shape[1]] = v
            pi[pairs, part, :v.shape[1]] = torch.where(
                torch.isneginf(v), -1, i + lo).to(torch.int32)
    return pv, pi


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,g", [(1, 1), (10, 2), (128, 3)])
def test_grouped_layout_merges_to_the_plain_scan(rng, dtype, k, g):
    """The grouping, the grouped plan and the partial layout, merged by
    the merge's plain version, give the plain scan's result: the same
    scores, and the same positions up to ties."""
    from wdbx_tpu_torch.kernels.fused_topk import merge_partials_plain

    _, tt, valid, q, probes, qidx = _case(rng, dtype)
    valid_t = torch.from_numpy(valid)
    args = (torch.from_numpy(probes), torch.from_numpy(qidx),
            torch.from_numpy(q))
    parts, prow = tk.plan_grouped(len(probes), C, 64)
    pv, pi = _grouped_layout(tt, valid_t, *args, k, g, parts, prow)
    got_v, got_i = merge_partials_plain(pv, pi, k)
    want_v, want_i = tk.ivf_bucket_scan(tt, valid_t, *args, k=k)
    torch.testing.assert_close(got_v, want_v, rtol=0, atol=TOL[dtype])
    assert torch.equal(got_i == -1, want_i == -1)


