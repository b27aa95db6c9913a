"""Parity of the port's fused score + top-k with wdbx_tpu's Pallas kernel.

JAX runs its kernel in interpret mode on the CPU (the way its own tests
do); the port runs the kernels' plain version, which is what its
wrappers do with CPU tensors. Slabs are small (N = 512, d = 32) and
few enough tiles that JAX's grouped pre-reduction stays off, so both
sides select exactly. Tolerances as in test_torch_ops.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import TOL, assert_topk_match
from wdbx_tpu.kernels import quant as jquant
from wdbx_tpu.kernels.fused_topk import fused_topk_search as j_fused
from wdbx_tpu.kernels.fused_topk import fused_topk_search_batched as j_batched
from wdbx_tpu_torch.kernels import fused_topk as tf

torch.set_num_threads(2)

N, D, BLOCK = 512, 32, 128


def _inputs(rng, dtype, n=N, d=D):
    """The same slab for both packages: (jax slab, torch slab, jax
    scales, torch scales)."""
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x), None, None
    if dtype == "bfloat16":
        return (jnp.asarray(x, jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16), None, None)
    quant = jquant.quantize_rows_int4 if dtype == "int4" else jquant.quantize_rows
    q, s = quant(jnp.asarray(x))
    return (q, torch.from_numpy(np.array(q)), s, torch.from_numpy(np.array(s)))


def _run_both(rng, dtype, valid, k, normalize, b=5, batched=False):
    jdb, tdb, js, ts = _inputs(rng, dtype, n=len(valid))
    shape = (2, b, D) if batched else (b, D)
    q = rng.standard_normal(shape).astype(np.float32)
    int4 = dtype == "int4"
    jfn, tfn = (j_batched, tf.fused_topk_search_batched) if batched else (
        j_fused, tf.fused_topk_search)
    sj, ij = jfn(jdb, jnp.asarray(q), jnp.asarray(valid), k=k,
                 block_n=BLOCK, interpret=True, scales=js,
                 normalize=normalize, int4=int4)
    st, it = tfn(tdb, torch.from_numpy(q), torch.from_numpy(valid), k=k,
                 block_n=BLOCK, scales=ts, normalize=normalize, int4=int4)
    assert it.dtype == torch.int64 and st.dtype == torch.float32
    sj = np.asarray(sj)
    ij = np.where(np.isneginf(sj), -1, np.asarray(ij))
    return sj, ij, st.numpy(), it.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_fused_topk_matches_pallas(rng, dtype, normalize, k):
    valid = rng.random(N) > 0.1  # ~10% invalid rows
    sj, ij, st, it = _run_both(rng, dtype, valid, k, normalize)
    assert_topk_match(sj, ij, st, it, TOL[dtype])
    assert valid[it[it >= 0]].all()


@pytest.mark.parametrize("dtype", ["float32", "int4"])
def test_fused_topk_k_beyond_valid_rows(rng, dtype):
    valid = np.zeros(N, bool)
    valid[rng.choice(N, 7, replace=False)] = True
    sj, ij, st, it = _run_both(rng, dtype, valid, 10, True)
    assert_topk_match(sj, ij, st, it, TOL[dtype])
    assert (it[:, 7:] == -1).all() and np.isneginf(st[:, 7:]).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_fused_topk_all_rows_invalid(rng, dtype):
    valid = np.zeros(N, bool)
    sj, ij, st, it = _run_both(rng, dtype, valid, 10, False)
    assert np.isneginf(sj).all() and np.isneginf(st).all()
    assert (it == -1).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_fused_topk_batched_matches_pallas(rng, dtype):
    valid = rng.random(N) > 0.1
    sj, ij, st, it = _run_both(rng, dtype, valid, 10, True, batched=True)
    assert st.shape == (2, 5, 10)
    assert_topk_match(sj, ij, st, it, TOL[dtype])


def test_fused_topk_k_cap_raises(rng):
    _, tdb, _, _ = _inputs(rng, "float32", n=64)
    q = torch.zeros((1, D))
    with pytest.raises(ValueError, match="K_MAX"):
        tf.fused_topk_search(tdb, q, torch.ones(64, dtype=torch.bool),
                             k=tf.K_MAX + 1)


def test_plan_covers_slab_in_row_tiles():
    smem = lambda qt, cap: 4 * (qt * cap * 2 + 8000)  # noqa: E731
    for n, b, k in [(1 << 20, 128, 10), (1 << 20, 8192, 10),
                    (65536, 128, 1024), (100, 3, 1)]:
        qt, chunks, rows = tf.plan(n, b, k, 132, smem)
        assert rows % 128 == 0 and chunks * rows >= n > (chunks - 1) * rows
        assert qt in (16, 64) and chunks <= 65535
