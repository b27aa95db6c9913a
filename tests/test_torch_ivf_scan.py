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
                                 (4096, 128), (3, 100)])
def test_plan_covers_each_bucket_in_whole_warp_groups(s, c):
    """The stage-1 grid covers every row once, in 32-row groups, and
    holds about four CTAs per SM of a 132-SM card when the pairs are
    few."""
    splits, rows = tk.plan(s, c, 132)
    assert rows % 32 == 0 and splits * rows >= c > (splits - 1) * rows
    assert s * splits >= min(4 * 132, s * -(-c // 32))
