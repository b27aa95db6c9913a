"""Parity of the port's clustered block scan (K3 / K4) with wdbx_tpu's
Pallas kernels, and of its block dedup, on the CPU.

JAX runs ``clustered_block_topk_v2`` / ``clustered_block_topk`` in
interpret mode with ``group=0`` (exact selection, as the port's kernel
always selects); the port runs the kernels' plain version, which is what
its wrappers do with CPU tensors. Slabs are cap = 4,096 rows of d = 64
in c = 256-row blocks. JAX's ``NEG`` sentinel (and the position the fold
leaves beside it) counts as -inf / -1. Tolerances as in test_torch_ops.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_topk import pipe_smem, tiled_smem
from test_torch_ops import TOL, assert_topk_match
from wdbx_tpu.index.clustered import _dedup_blocks as j_dedup
from wdbx_tpu.kernels import quant as jquant
from wdbx_tpu.kernels.clustered_scan import clustered_block_topk as j_v1
from wdbx_tpu.kernels.clustered_scan import clustered_block_topk_v2 as j_v2
from wdbx_tpu_torch.index.clustered import _dedup_blocks as t_dedup
from wdbx_tpu_torch.kernels import clustered_scan as tcs
from wdbx_tpu_torch.kernels import fused_topk as tf

torch.set_num_threads(2)

CAP, D, C = 4096, 64, 256
NBLOCKS = CAP // C


def _slab(rng, dtype, valid_frac=0.9):
    """The same slab for both packages: (jax slab, torch slab, jax
    scales (1, cap), torch scales (cap,), valid bool (cap,))."""
    x = rng.standard_normal((CAP, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    valid = rng.random(CAP) < valid_frac
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x), None, None, valid
    if dtype == "bfloat16":
        return (jnp.asarray(x, jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16), None, None, valid)
    quant = jquant.quantize_rows_int4 if dtype == "int4" else jquant.quantize_rows
    q, s = quant(jnp.asarray(x))
    return (q, torch.from_numpy(np.array(q)), s.reshape(1, -1),
            torch.from_numpy(np.array(s)), valid)


def _block_list(rng, u=8, hole=True, live=6):
    """``u`` distinct block ids; ``ok`` live on a prefix of ``live``
    entries (the dedup's padding suffix), with an interior hole."""
    uniq = rng.permutation(NBLOCKS)[:u].astype(np.int32)
    ok = np.zeros(u, np.int32)
    ok[:live] = 1
    if hole:
        ok[2] = 0
    return uniq, ok


def _run(rng, dtype, qprec, gen, k, b, uniq, ok, valid_frac=0.9):
    js, ts, jsc, tsc, valid = _slab(rng, dtype, valid_frac)
    q = rng.standard_normal((b, D)).astype(np.float32)
    int4 = dtype == "int4"
    vj = jnp.asarray(valid.astype(np.int8)).reshape(1, -1)
    if gen == "v2":
        sj, ij = j_v2(js, vj, jsc, jnp.asarray(uniq), jnp.asarray(ok),
                      jnp.asarray(q), k=k, c=C, interpret=True, group=0,
                      int4=int4, qprec=qprec)
        st, it = tcs.clustered_block_topk_v2(
            ts, torch.from_numpy(valid), tsc, torch.from_numpy(uniq),
            torch.from_numpy(ok), torch.from_numpy(q), k=k, c=C, int4=int4,
            qprec=qprec)
    else:
        # JAX's v1 takes queries already in the scoring type
        qj = jnp.asarray(q, jnp.bfloat16 if jsc is not None else js.dtype)
        sj, ij = j_v1(js, vj, jsc, jnp.asarray(uniq), jnp.asarray(ok), qj,
                      k=k, c=C, interpret=True, group=0)
        st, it = tcs.clustered_block_topk(
            ts, torch.from_numpy(valid), tsc, torch.from_numpy(uniq),
            torch.from_numpy(ok), torch.from_numpy(q), k=k, c=C)
    sj = np.asarray(sj)
    sj = np.where(sj <= -3e38, -np.inf, sj)
    ij = np.where(np.isneginf(sj), -1, np.asarray(ij))
    assert it.dtype == torch.int64 and st.shape == (b, k)
    return sj, ij, st.numpy(), it.numpy(), valid


def _live_positions(uniq, ok, valid):
    pos = (uniq[ok != 0][:, None] * C + np.arange(C)).reshape(-1)
    return pos[valid[pos]]


MODES = [("float32", "bf16"), ("bfloat16", "bf16"), ("int8", "bf16"),
         ("int4", "bf16"), ("int8", "int8"), ("int4", "int8")]


@pytest.mark.parametrize("dtype,qprec", MODES)
@pytest.mark.parametrize("k,b", [(1, 1), (10, 5), (128, 37)])
def test_v2_matches_pallas(rng, dtype, qprec, k, b):
    uniq, ok = _block_list(rng)
    sj, ij, st, it, valid = _run(rng, dtype, qprec, "v2", k, b, uniq, ok)
    assert_topk_match(sj, ij, st, it, TOL[dtype])
    live = set(_live_positions(uniq, ok, valid).tolist())
    assert set(it[it >= 0].tolist()) <= live


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_v1_matches_pallas(rng, dtype):
    uniq, ok = _block_list(rng)
    sj, ij, st, it, _ = _run(rng, dtype, "bf16", "v1", 10, 37, uniq, ok)
    assert_topk_match(sj, ij, st, it, TOL[dtype])


@pytest.mark.parametrize("dtype,qprec,gen", [("bfloat16", "bf16", "v2"),
                                             ("int8", "int8", "v2"),
                                             ("int8", "bf16", "v1")])
def test_all_entries_masked(rng, dtype, qprec, gen):
    uniq, ok = _block_list(rng)
    ok[:] = 0
    sj, ij, st, it, _ = _run(rng, dtype, qprec, gen, 10, 5, uniq, ok)
    assert np.isneginf(sj).all() and np.isneginf(st).all()
    assert (it == -1).all() and (ij == -1).all()


@pytest.mark.parametrize("dtype,qprec", [("float32", "bf16"), ("int4", "int8")])
def test_k_beyond_valid_rows(rng, dtype, qprec):
    uniq, ok = _block_list(rng, u=4, hole=False, live=2)
    # ~0.5% of rows valid: fewer than k live rows in the two live blocks
    sj, ij, st, it, valid = _run(rng, dtype, qprec, "v2", 10, 5, uniq, ok,
                                 valid_frac=0.005)
    n_live = len(_live_positions(uniq, ok, valid))
    assert n_live < 10
    assert_topk_match(sj, ij, st, it, TOL[dtype])
    assert (it[:, n_live:] == -1).all() and (it[:, :n_live] >= 0).all()


def test_v1_refuses_int4_and_unknown_qprec(rng):
    _, ts, _, tsc, valid = _slab(rng, "int4")
    uniq, ok = (torch.from_numpy(a) for a in _block_list(rng))
    q = torch.zeros((2, D))
    with pytest.raises(ValueError, match="int4"):
        tcs.clustered_block_topk(ts, torch.from_numpy(valid), tsc, uniq, ok,
                                 q, k=4, c=C)
    with pytest.raises(ValueError, match="qprec"):
        tcs.clustered_block_topk_v2(ts, torch.from_numpy(valid), tsc, uniq,
                                    ok, q, k=4, c=C, int4=True, qprec="fp8")


def test_plan_groups_cover_the_list():
    smem = lambda qt, cap: 4 * (qt * cap * 2 + 8000)  # noqa: E731
    for u, b, k in [(512, 128, 10), (1, 1, 10), (4096, 8192, 128),
                    (37, 5, 1024)]:
        qt, ways, groups = tcs.plan(u, b, k, 132, smem)
        assert qt in (16, 64) and 1 <= ways <= 32
        assert groups * ways >= u > (groups - 1) * ways


# -- block dedup ---------------------------------------------------------

def _extents(rng, nlist, nblocks):
    cuts = np.sort(rng.choice(np.arange(1, nblocks * C), nlist - 1,
                              replace=False))
    start = np.concatenate([[0], cuts, [nblocks * C]])
    lo = (start[:-1] // C).astype(np.int32)
    hi = (-(-start[1:] // C)).astype(np.int32)
    m = 1 << max(0, int((hi - lo).max() - 1).bit_length())
    return lo, hi, m


def _dedup_both(probe, lo, hi, nblocks, u, m, valid=None):
    jv = jnp.asarray(valid) if valid is not None else None
    tv = torch.from_numpy(valid) if valid is not None else None
    uj, oj = j_dedup(jnp.asarray(probe), jnp.asarray(lo), jnp.asarray(hi),
                     nblocks, u, m, valid=jv, c=C)
    ut, ot = t_dedup(torch.from_numpy(probe.astype(np.int64)),
                     torch.from_numpy(lo.astype(np.int64)),
                     torch.from_numpy(hi.astype(np.int64)), nblocks, u, m,
                     valid=tv, c=C)
    return np.asarray(uj), np.asarray(oj), ut.numpy(), ot.numpy()


@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("kill_blocks", [False, True])
@pytest.mark.parametrize("u", [8, 64])
def test_dedup_blocks_entry_for_entry(rng, skewed, kill_blocks, u):
    nlist, nblocks, b, p = 24, 64, 32, 4
    lo, hi, m = _extents(rng, nlist, nblocks)
    if skewed:  # most queries hammer two buckets (after test_clustered.py)
        probe = np.zeros((b, p), np.int32)
        probe[:, 1] = 1
        probe[-4:] = rng.integers(0, nlist, (4, p))
    else:
        probe = np.stack([rng.permutation(nlist)[:p] for _ in range(b)])
        probe = probe.astype(np.int32)
    valid = None
    if kill_blocks:
        valid = rng.random(nblocks * C) < 0.9
        for blk in rng.choice(nblocks, 12, replace=False):
            valid[blk * C:(blk + 1) * C] = False
    uj, oj, ut, ot = _dedup_both(probe, lo, hi, nblocks, u, m, valid)
    np.testing.assert_array_equal(oj, ot)
    np.testing.assert_array_equal(uj, ut)
    if kill_blocks:
        live = valid.reshape(nblocks, C).any(axis=1)
        assert live[ut[ot]].all()


def test_dedup_blocks_skewed_counts_clamp():
    """The int32 clamp of the popularity counts ranks the hot bucket's
    blocks as JAX does (a wrapped count would drop them)."""
    b, p, m, nblocks = 1024, 32, 8, 32
    lo = np.asarray([0, 8, 16, 24], np.int32)
    hi = np.asarray([8, 16, 24, 32], np.int32)
    probe = np.zeros((b, p), np.int32)
    probe[-64:] = 1
    uj, oj, ut, ot = _dedup_both(probe, lo, hi, nblocks, 16, m)
    np.testing.assert_array_equal(uj, ut)
    np.testing.assert_array_equal(oj, ot)
    assert set(range(16)) <= set(ut[ot].tolist())


@pytest.mark.parametrize("u,b,k", [(512, 128, 10), (256, 128, 10),
                                   (1, 1, 10), (24, 128, 128),
                                   (4096, 8192, 128), (37, 5, 128),
                                   (8192, 128, 1)])
def test_plan_tiled_groups_whole_waves(u, b, k):
    qt, ways, groups = tcs.plan(u, b, k, 132, tiled_smem, body="fma_tiled")
    smem = tiled_smem(qt, tf.tiled_cap(qt, k, tiled_smem))
    assert qt in tf.TILED_QT and smem <= tf.SMEM_MAX and ways == 0
    assert qt >= min(b, 128) or tiled_smem(2 * qt, tf._cap(k)) > tf.SMEM_MAX
    # a CTA's span of the live tiles stays within 32 list entries
    assert groups * 31 >= u and groups <= 65535
    # the grid is a whole number of waves
    assert (-(-b // qt) * groups) % tf.cta_slots(132, smem) == 0


def test_plan_tiled_block_scan_at_the_driven_point():
    # 1M x 384 float32, nprobe 1, B=128 on 132 SMs: one wave of 132 CTAs
    assert tcs.plan(512, 128, 10, 132, tiled_smem,
                    body="fma_tiled") == (128, 0, 132)


def test_plan_tiled_block_scan_fits_every_k():
    # the clustered kernel path serves k <= 128 (KERNEL_K_MAX)
    for k in range(1, 129):
        qt = tcs.plan(512, 128, k, 132, tiled_smem, body="fma_tiled")[0]
        assert tiled_smem(qt, tf._cap(k)) <= tf.SMEM_MAX


@pytest.mark.parametrize("u,b,k,d", [
    (512, 128, 10, 384), (1024, 128, 10, 768), (512, 128, 50, 768),
    (4096, 8192, 10, 384), (1, 1, 10, 384), (37, 5, 64, 384)])
@pytest.mark.parametrize("slab", ["bfloat16", "int8"])
def test_plan_pipe_groups_whole_waves(u, b, k, d, slab):
    _check_pipe_groups(u, b, k, d, slab, "bfloat16")


@pytest.mark.parametrize("u,b,k,d", [
    (512, 128, 10, 384), (1024, 128, 10, 768), (512, 128, 50, 768),
    (4096, 8192, 10, 384), (1, 1, 10, 384), (37, 5, 64, 384)])
@pytest.mark.parametrize("slab,qtype", [
    ("int4", "bfloat16"), ("int8", "int8"), ("int4", "int8")])
def test_plan_pipe_groups_whole_waves_int4_and_int8_queries(u, b, k, d, slab,
                                                            qtype):
    _check_pipe_groups(u, b, k, d, slab, qtype)


def _check_pipe_groups(u, b, k, d, slab, qtype):
    smem = pipe_smem(slab, d, qtype)
    qt, ways, groups = tcs.plan(u, b, k, 132, smem, body="mma_pipe", d=d,
                                qtype=qtype)
    assert qt == tf.pipe_qt(b, k, d, smem, qtype) and ways == 0
    assert smem(qt, tf.tiled_cap(qt, k, smem)) <= tf.SMEM_MAX
    # a CTA's span of the live tiles stays within 32 list entries, and
    # the grid (one CTA a SM) is a whole number of waves
    assert groups * 31 >= u and groups <= 65535
    assert (-(-b // qt) * groups) % 132 == 0


@pytest.mark.parametrize("slab", ["int8", "int4"])
def test_plan_pipe_at_the_driven_int8_query_point(slab):
    # 10M x 768, nprobe 1, B=128, k=10 with int8 queries (about 490 live
    # blocks of a 512-entry list): 128 resident queries, one CTA a SM, one
    # whole wave
    smem = pipe_smem(slab, 768, "int8")
    assert tcs.plan(512, 128, 10, 132, smem, body="mma_pipe", d=768,
                    qtype="int8") == (128, 0, 132)
    # k=50 keeps the pipelined body with 64 queries a CTA: two tiles of
    # the batch, still whole waves
    qt, _, groups = tcs.plan(512, 128, 50, 132, smem, body="mma_pipe",
                             d=768, qtype="int8")
    assert qt == 64 and (2 * groups) % 132 == 0


def test_plan_pipe_block_scan_fits_every_k():
    # the clustered kernel path serves k <= 128 (KERNEL_K_MAX); the
    # pipelined body takes what fits, the rest stays on scan_mma
    for d in (384, 768):
        smem = pipe_smem("int8", d)
        served = [k for k in range(1, 129)
                  if tf.pipe_qt(128, k, d, smem) is not None]
        assert served == list(range(1, len(served) + 1))
        assert len(served) >= 50  # the filtered search's k=50 fits
