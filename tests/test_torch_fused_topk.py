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


def tiled_smem(qt, cap):
    """Shared memory of a tiled float32 CTA (``csrc/topk_common.cuh``):
    the 3-stage ring of (128 + qt) rows x 36 words, then the CtaSel."""
    return 4 * (3 * (128 + qt) * 36 + 8 * 256 + 2 * qt + 2 * qt * cap)


@pytest.mark.parametrize("n,b,k", [
    (1 << 20, 128, 10), (1 << 20, 8192, 10), (1 << 20, 1, 10),
    (65536, 128, 1), (65536, 128, 128), (65536, 128, 256),
    (65536, 128, 1024), (10_000, 5, 1024), (100, 3, 1)])
def test_plan_tiled_covers_slab_in_whole_waves(n, b, k):
    qt, chunks, rows = tf.plan(n, b, k, 132, tiled_smem, body="fma_tiled")
    smem = tiled_smem(qt, tf.tiled_cap(qt, k, tiled_smem))
    assert qt in tf.TILED_QT and smem <= tf.SMEM_MAX
    assert qt >= min(b, 128) or tiled_smem(2 * qt, tf._cap(k)) > tf.SMEM_MAX
    assert rows % 128 == 0 and chunks * rows >= n > (chunks - 1) * rows
    assert chunks <= 65535
    # every SM gets an equal share: the waves times the longest chunk
    # stay within 5% (and 2 tiles) of the tiles per CTA slot
    slots = tf.cta_slots(132, smem)
    qtiles, tiles = -(-b // qt), -(-n // 128)
    waves = -(-qtiles * chunks // slots)
    assert waves * rows // 128 <= 1.05 * qtiles * tiles / slots + 2


def test_plan_tiled_at_the_driven_point():
    # 1M x 384, B=128, k=10 on 132 SMs: one wave of 131 chunks of 63 tiles
    assert tf.plan(1 << 20, 128, 10, 132, tiled_smem,
                   body="fma_tiled") == (128, 131, 63 * 128)


@pytest.mark.parametrize("b", [1, 16, 40, 128, 8192])
def test_plan_tiled_fits_every_k(b):
    for k in range(1, tf.K_MAX + 1):
        qt = tf.plan(1 << 20, b, k, 132, tiled_smem, body="fma_tiled")[0]
        assert tiled_smem(qt, tf._cap(k)) <= tf.SMEM_MAX
        assert qt == tf.tiled_qt(b, k, tiled_smem)


@pytest.mark.parametrize("slab,qtype,d,db_off,q_off,want", [
    ("float32", "float32", 384, 0, 0, "fma_tiled"),
    ("float32", "float32", 100, 0, 0, "fma_tiled"),  # 100 % 4 == 0
    ("float32", "float32", 98, 0, 0, "fma"),
    ("float32", "float32", 384, 4, 0, "fma"),
    ("float32", "float32", 384, 0, 8, "fma"),
    ("bfloat16", "bfloat16", 384, 0, 0, "mma_pipe"),
    ("bfloat16", "bfloat16", 100, 0, 0, "fma"),
    ("bfloat16", "bfloat16", 384, 2, 0, "fma"),
    ("int8", "bfloat16", 96, 0, 0, "mma_pipe"),
    ("int8", "int8", 96, 0, 0, "fma"),  # s8 products take 64 dims a slice
    ("int4", "int8", 768, 0, 0, "mma_pipe"),
    ("int8", "int8", 768, 0, 0, "mma_pipe"),
    ("int4", "bfloat16", 384, 0, 0, "mma_pipe"),
    ("int4", "bfloat16", 768, 0, 0, "mma_pipe"),
    ("int4", "bfloat16", 96, 0, 0, "mma_pipe"),  # 48 packed bytes a row
    ("int4", "bfloat16", 48, 0, 0, "fma"),  # 24 bytes: not whole chunks
    ("int4", "int8", 96, 0, 0, "fma"),  # 48 bytes: not whole k32 steps
    ("int4", "bfloat16", 1568, 0, 0, "mma"),  # queries too wide to stay
])
def test_scan_body_rule(slab, qtype, d, db_off, q_off, want):
    assert tf.scan_body(slab, qtype, d, 4096 + db_off, 8192 + q_off) == want


def test_scan_body_of_an_unaligned_view():
    buf = torch.zeros(64 * 384 + 1)
    view, whole = buf[1:].view(64, 384), buf[:-1].view(64, 384)
    q = torch.zeros((5, 384))
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert tf.scan_body("float32", "float32", 384, view.data_ptr(),
                        q.data_ptr()) == "fma"
    assert tf.scan_body("float32", "float32", 384, whole.data_ptr(),
                        q.data_ptr()) == ("fma_tiled"
                                          if whole.data_ptr() % 16 == 0
                                          else "fma")


@pytest.mark.parametrize("k", [1, 10, 32, 45, 46, 64, 100, 128, 1024])
def test_tiled_cap_grows_into_the_spare_shared_memory(k):
    for b in (1, 128):
        qt = tf.tiled_qt(b, k, tiled_smem)
        cap = tf.tiled_cap(qt, k, tiled_smem)
        assert tf._cap(k) <= cap <= max(tf._cap(k), 128)
        assert tiled_smem(qt, cap) <= tf.SMEM_MAX
        assert cap == max(tf._cap(k), 128) or \
            tiled_smem(qt, cap + 1) > tf.SMEM_MAX


def pipe_smem(slab, d, qtype="bfloat16"):
    """Shared memory of a pipelined tensor-core CTA
    (``csrc/topk_common.cuh``, ``pipe_smem_bytes``): the 3-stage ring of
    128 rows x 128 bytes, the resident queries (a query's bytes rounded
    up to a whole 128-byte slice, plus 16, or 32 for bf16 queries against
    int8 / int4 codes), two tiles of row scales, then the 128 warp
    buffers, or for int4 rows against bf16 queries at least the 64 KB
    bf16 staging tile that takes their room."""
    qbytes = d * tf.QUERY_BYTES[qtype]
    pad = 32 if qtype == "bfloat16" and slab != "bfloat16" else 16
    stride = -(-qbytes // 128) * 128 + pad
    stage = 128 * 512 if slab == "int4" and qtype == "bfloat16" else 0

    def smem(qt, cap):
        return (4 * (3 * 128 * 128 // 4 + qt * stride // 4 + 2 * 128)
                + max(4 * (2 * 128 + 2 * 128 * cap), stage))

    return smem


@pytest.mark.parametrize("slab,qtype,d,db_off,q_off,want", [
    ("bfloat16", "bfloat16", 384, 0, 0, "mma_pipe"),
    ("bfloat16", "bfloat16", 768, 0, 0, "mma_pipe"),
    ("int8", "bfloat16", 384, 0, 0, "mma_pipe"),
    ("int8", "bfloat16", 768, 0, 0, "mma_pipe"),
    ("int8", "bfloat16", 1536, 0, 0, "mma_pipe"),
    ("int8", "bfloat16", 1568, 0, 0, "mma"),  # queries too wide to stay
    ("bfloat16", "bfloat16", 2048, 0, 0, "mma"),
    ("int4", "bfloat16", 384, 0, 0, "mma_pipe"),
    ("int8", "int8", 384, 0, 0, "mma_pipe"),
    ("int8", "int8", 768, 0, 0, "mma_pipe"),
    ("bfloat16", "bfloat16", 384, 0, 2, "fma"),  # unaligned queries
    ("int8", "bfloat16", 384, 8, 0, "fma"),  # unaligned slab
    ("int8", "bfloat16", 400, 0, 0, "fma"),
])
def test_scan_body_rule_for_the_pipelined_body(slab, qtype, d, db_off, q_off,
                                               want):
    assert tf.scan_body(slab, qtype, d, 4096 + db_off, 8192 + q_off) == want


def test_scan_body_of_unaligned_bf16_views():
    buf = torch.zeros(64 * 384 + 1, dtype=torch.bfloat16)
    view = buf[1:].view(64, 384)
    q = torch.zeros((5, 384), dtype=torch.bfloat16)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert tf.scan_body("bfloat16", "bfloat16", 384, view.data_ptr(),
                        q.data_ptr()) == "fma"


@pytest.mark.parametrize("slab", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("d", [384, 768])
def test_pipe_qt_rule_and_fit(slab, d):
    smem = pipe_smem(slab, d)
    for b in (1, 5, 37, 128, 8192):
        for k in range(1, tf.K_MAX + 1):
            qt = tf.pipe_qt(b, k, d, smem)
            if qt is None:
                # no query tile's 128 buffers fit beside its queries
                assert all(smem(x, tf._cap(k)) > tf.SMEM_MAX or
                           x * d * 2 > tf.PIPE_QUERY_BYTES
                           for x in tf.PIPE_QT)
                continue
            assert qt in tf.PIPE_QT and qt * d * 2 <= tf.PIPE_QUERY_BYTES
            cap = tf.tiled_cap(qt, k, smem)
            assert tf._cap(k) <= cap and smem(qt, cap) <= tf.SMEM_MAX
    # the driven points: k=10 at B=128 takes 128 queries at d=384, 64 at
    # d=768; k=50 fits too; k=1024 does not
    assert tf.pipe_qt(128, 10, d, smem) == (128 if d == 384 else 64)
    assert tf.pipe_qt(128, 50, d, smem) is not None
    assert tf.pipe_qt(128, 1024, d, smem) is None


def test_pick_body_sends_deep_k_to_scan_mma():
    def smem_of(code):
        return pipe_smem("int8", 384) if code == tf.BODY_CODES["mma_pipe"] \
            else (lambda qt, cap: 0)

    assert tf.pick_body("int8", "bfloat16", 128, 10, 384, 4096, 8192,
                        smem_of) == "mma_pipe"
    assert tf.pick_body("int8", "bfloat16", 128, 1024, 384, 4096, 8192,
                        smem_of) == "mma"
    assert tf.pick_body("int8", "int8", 128, 10, 384, 4096, 8192,
                        smem_of) == "mma_pipe"
    assert tf.pick_body("int4", "int8", 128, 1024, 384, 4096, 8192,
                        smem_of) == "mma"


@pytest.mark.parametrize("slab", ["int8", "int4"])
@pytest.mark.parametrize("d", [384, 768, 1536])
def test_pipe_qt_with_int8_queries(slab, d):
    # one byte a dim: 128 resident queries up to d = 768, 64 at 1536
    smem = pipe_smem(slab, d, "int8")
    for b in (1, 5, 37, 128, 8192):
        for k in range(1, 129):
            qt = tf.pipe_qt(b, k, d, smem, "int8")
            if qt is None:
                assert all(smem(x, tf._cap(k)) > tf.SMEM_MAX or
                           x * d > tf.PIPE_QUERY_BYTES for x in tf.PIPE_QT)
                continue
            assert qt in tf.PIPE_QT and qt * d <= tf.PIPE_QUERY_BYTES
            assert smem(qt, tf.tiled_cap(qt, k, smem)) <= tf.SMEM_MAX
    assert tf.pipe_qt(128, 10, d, smem, "int8") == (128 if d <= 768 else 64)
    assert tf.pipe_qt(128, 50, d, smem, "int8") is not None
    # bf16 queries of the same width take twice the bytes
    assert tf.pipe_qt(128, 10, 768, pipe_smem(slab, 768), "bfloat16") == 64


@pytest.mark.parametrize("n,b,k,d", [
    (1 << 20, 128, 10, 384), (1 << 20, 8192, 10, 384), (1 << 20, 1, 10, 384),
    (65536, 128, 1, 384), (65536, 128, 50, 768), (65536, 5, 64, 384),
    (10_000, 37, 10, 768), (100, 3, 1, 384)])
@pytest.mark.parametrize("slab", ["bfloat16", "int8", "int4"])
def test_plan_pipe_covers_slab_in_whole_waves(n, b, k, d, slab):
    smem = pipe_smem(slab, d)
    qt, chunks, rows = tf.plan(n, b, k, 132, smem, body="mma_pipe", d=d)
    assert qt == tf.pipe_qt(b, k, d, smem)
    assert smem(qt, tf.tiled_cap(qt, k, smem)) <= tf.SMEM_MAX
    # every row in exactly one chunk of whole 128-row tiles
    assert rows % 128 == 0 and chunks * rows >= n > (chunks - 1) * rows
    assert chunks <= 65535
    # one CTA a SM: the grid is whole waves of 132, each SM an equal share
    qtiles, tiles = -(-b // qt), -(-n // 128)
    waves = -(-qtiles * chunks // 132)
    assert waves * rows // 128 <= 1.05 * qtiles * tiles / 132 + 2


def test_plan_pipe_at_the_driven_point():
    # 1M x 384, B=128, k=10 on 132 SMs: one wave of 131 chunks of 63 tiles
    # (K2 int4 included: the flat engine at INDEX_DTYPE=int4)
    for slab in ("bfloat16", "int8", "int4"):
        assert tf.plan(1 << 20, 128, 10, 132, pipe_smem(slab, 384),
                       body="mma_pipe", d=384) == (128, 131, 63 * 128)


# The wgmma body (csrc/fused_topk_sm90.cu): K1 over bf16 slabs only.
@pytest.mark.parametrize("d", [128, 384, 768])
@pytest.mark.parametrize("k", [1, 10, 32])
def test_scan_body_takes_wgmma_for_k1_bf16(d, k):
    assert tf.scan_body("bfloat16", "bfloat16", d, 4096, 8192, k) == "wgmma"
    # without a K1 k (the block scan's launches) the rule is as before
    assert tf.scan_body("bfloat16", "bfloat16", d, 4096, 8192) == "mma_pipe"


@pytest.mark.parametrize("slab,qtype,d,k,db_off,q_off,want", [
    ("bfloat16", "bfloat16", 384, 33, 0, 0, "mma_pipe"),   # k > 32
    ("bfloat16", "bfloat16", 768, 33, 0, 0, "mma_pipe"),
    ("bfloat16", "bfloat16", 768, 1024, 0, 0, "mma_pipe"),
    ("bfloat16", "bfloat16", 832, 10, 0, 0, "mma_pipe"),   # over 768
    ("bfloat16", "bfloat16", 1536, 10, 0, 0, "mma_pipe"),
    ("bfloat16", "bfloat16", 736, 10, 0, 0, "mma_pipe"),   # d % 64 != 0
    ("bfloat16", "bfloat16", 96, 10, 0, 0, "mma_pipe"),
    ("bfloat16", "bfloat16", 100, 10, 0, 0, "fma"),
    ("bfloat16", "bfloat16", 768, 10, 2, 0, "fma"),        # unaligned slab
    ("bfloat16", "bfloat16", 768, 10, 0, 8, "fma"),        # unaligned queries
    ("int8", "bfloat16", 768, 10, 0, 0, "mma_pipe"),
    ("int8", "int8", 768, 10, 0, 0, "mma_pipe"),
    ("int4", "bfloat16", 768, 10, 0, 0, "mma_pipe"),
    ("int4", "int8", 384, 10, 0, 0, "mma_pipe"),
    ("float32", "float32", 768, 10, 0, 0, "fma_tiled"),
    ("float32", "float32", 384, 1, 0, 0, "fma_tiled"),
])
def test_scan_body_wgmma_fallbacks(slab, qtype, d, k, db_off, q_off, want):
    assert tf.scan_body(slab, qtype, d, 4096 + db_off, 8192 + q_off,
                        k) == want


def test_scan_body_wgmma_of_unaligned_views():
    buf = torch.zeros(64 * 768 + 1, dtype=torch.bfloat16)
    view = buf[1:].view(64, 768)
    q = torch.zeros((5, 768), dtype=torch.bfloat16)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert tf.scan_body("bfloat16", "bfloat16", 768, view.data_ptr(),
                        q.data_ptr(), 10) == "fma"


@pytest.mark.parametrize("slab,qtype,b,k,flat,want", [
    ("bfloat16", "bfloat16", 128, 10, True, "wgmma"),
    ("bfloat16", "bfloat16", 128, 32, True, "wgmma"),
    ("bfloat16", "bfloat16", 65, 1, True, "wgmma"),
    ("bfloat16", "bfloat16", 300, 10, True, "wgmma"),
    ("bfloat16", "bfloat16", 8192, 10, True, "wgmma"),
    # at most 64 queries: one CTA of the pair would hold them all
    ("bfloat16", "bfloat16", 64, 10, True, "mma_pipe"),
    ("bfloat16", "bfloat16", 37, 10, True, "mma_pipe"),
    ("bfloat16", "bfloat16", 1, 10, True, "mma_pipe"),
    ("bfloat16", "bfloat16", 128, 33, True, "mma_pipe"),
    ("bfloat16", "bfloat16", 128, 1024, True, "mma"),
    ("bfloat16", "bfloat16", 128, 10, False, "mma_pipe"),  # K3: no wgmma
    ("int8", "bfloat16", 128, 10, True, "mma_pipe"),
    ("int4", "bfloat16", 128, 10, True, "mma_pipe"),
    ("int8", "int8", 128, 10, True, "mma_pipe"),
])
def test_pick_body_gives_wgmma_to_k1_only(slab, qtype, b, k, flat, want):
    def smem_of(code):
        return pipe_smem(slab, 384, qtype) \
            if code == tf.BODY_CODES["mma_pipe"] else (lambda qt, cap: 0)

    assert tf.BODY_CODES["wgmma"] == 4
    assert tf.pick_body(slab, qtype, b, k, 384, 4096, 8192, smem_of,
                        flat=flat) == want


def _wgmma_grid(n, b, chunks, rows):
    """The CTAs of a wgmma launch (``fused_topk_sm90.cu``): grid (2 chunks,
    query tiles of 128), clusters of the two CTAs of a chunk; CTA x of
    row y holds queries [128 y + 64 (x % 2), + 64) and walks the rows of
    chunk x // 2, its consumer warpgroup w writing part 2 (x // 2) + w."""
    ctas = []
    for y in range(-(-b // tf.WGMMA_QT)):
        for x in range(2 * chunks):
            q0 = y * tf.WGMMA_QT + (x % 2) * (tf.WGMMA_QT // 2)
            r0 = (x // 2) * rows
            ctas.append(((q0, min(b, q0 + tf.WGMMA_QT // 2)),
                         (r0, min(n, r0 + rows)),
                         [tf.WGMMA_PARTS * (x // 2) + w
                          for w in range(tf.WGMMA_PARTS)]))
    return ctas


@pytest.mark.parametrize("n,b", [
    (10_000_000, 128), (10_000_000, 300), (10_000_000, 1),
    (1 << 20, 128), (1 << 20, 8192), (10_001, 37), (3000, 300), (100, 3)])
def test_plan_wgmma_covers_each_query_and_row_once(n, b):
    clusters = 66
    chunks, rows = tf.plan_wgmma(n, b, clusters)
    parts = tf.WGMMA_PARTS * chunks
    assert rows % 128 == 0 and chunks * rows >= n > (chunks - 1) * rows
    assert chunks <= 65535
    qtiles, tiles = -(-b // tf.WGMMA_QT), -(-n // 128)
    # whole waves of CTA pairs, unless the slab is too short for one wave
    assert (qtiles * chunks) % clusters == 0 or qtiles * chunks < clusters
    waves = -(-qtiles * chunks // clusters)
    assert waves * rows // 128 <= 1.05 * qtiles * tiles / clusters + 2
    # every (query, row) pair in exactly one CTA; every part written once
    cover_q, cover_r = {}, {}
    seen_parts = {}
    for (qa, qb), (ra, rb), ps in _wgmma_grid(n, b, chunks, rows):
        if qa >= b:
            continue  # a CTA past the batch writes nothing
        for p in ps:
            seen_parts[(qa, p)] = seen_parts.get((qa, p), 0) + 1
        cover_q.setdefault((ra, rb), []).append((qa, qb))
        cover_r[(ra, rb)] = True
    spans = sorted(cover_r)
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
    for span, qs in cover_q.items():
        qs = sorted(qs)
        assert qs[0][0] == 0 and qs[-1][1] == b
        assert all(a[1] == c[0] for a, c in zip(qs, qs[1:]))
    assert set(seen_parts.values()) == {1}
    assert {p for _, p in seen_parts} == set(range(parts))


def test_plan_wgmma_at_the_driven_points():
    # 10M x 768, B=128 on 132 SMs: 66 CTA pairs, one chunk of 1,184 tiles
    # each, 132 parts a query
    assert tf.plan_wgmma(10_000_000, 128, 66) == (66, 1184 * 128)
    # B=300: three query tiles of 128, 22 chunks each: one wave of 66
    chunks, rows = tf.plan_wgmma(10_000_000, 300, 66)
    assert (chunks, 3 * chunks) == (22, 66) and rows == 3552 * 128
    # fewer pairs on the card (a GPC with an odd SM count): still one wave
    assert tf.plan_wgmma(10_000_000, 128, 64)[0] == 64
