"""Parity of the port's ops and quantization with wdbx_tpu's, on the CPU.

The same seeded numpy inputs go through the JAX function and its torch
counterpart. Tolerances: float32 1e-5; bf16 / int8 / int4 2e-2 absolute
(bf16 rounds at other places in the two libraries). Quantized codes must
be bit-identical: both libraries round half to even.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wdbx_tpu.kernels import quant as jquant
from wdbx_tpu.ops.exact_search import exact_search as j_exact
from wdbx_tpu.ops.exact_search import score_block as j_score
from wdbx_tpu.ops.normalize import l2_normalize as j_norm
from wdbx_tpu.ops.topk import topk_merge as j_merge
from wdbx_tpu_torch.index import base as index_base
from wdbx_tpu_torch.index import flat as index_flat
from wdbx_tpu_torch.kernels import quant as tquant
from wdbx_tpu_torch.ops.exact_search import exact_search as t_exact
from wdbx_tpu_torch.ops.exact_search import score_block as t_score
from wdbx_tpu_torch.ops.normalize import l2_normalize as t_norm
from wdbx_tpu_torch.ops.topk import topk_merge as t_merge
from wdbx_tpu_torch.parallel import mesh as mesh_mod

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2, "int8": 2e-2, "int4": 2e-2}

#: logical mesh positions of the port's default mesh in the translated
#: reference cases: the 8 host devices that tests/conftest.py forces on JAX
PORT_MESH_SIZE = 8


def port_on_cpu(monkeypatch):
    """Run the JAX package's own cases on the port on the CPU as written.

    Those cases build ``WDBX()``, ``VectorStore(...)``, ``FlatIndex(...)``
    and ``ShardedFlatIndex(dim=...)`` with no device, where the port takes
    the card and raises without one. For one test, through
    ``monkeypatch``: ``resolve_device(None)`` gives the CPU in both modules
    that bind the name, the default mesh's base devices are ``[cpu]``, and
    ``make_mesh()`` has ``PORT_MESH_SIZE`` positions. An explicit device
    goes through unchanged; the package itself is not touched."""
    resolve = index_base.resolve_device
    base_devices = mesh_mod._base_devices

    def resolve_on_cpu(device=None):
        return resolve("cpu" if device is None else device)

    def base_on_cpu(device):
        return base_devices("cpu" if device is None else device)

    monkeypatch.setattr(index_base, "resolve_device", resolve_on_cpu)
    monkeypatch.setattr(index_flat, "resolve_device", resolve_on_cpu)
    monkeypatch.setattr(mesh_mod, "_base_devices", base_on_cpu)
    monkeypatch.setenv(mesh_mod.MESH_SIZE_ENV, str(PORT_MESH_SIZE))


def assert_topk_match(s_ref, i_ref, s_got, i_got, atol):
    """Scores agree within ``atol``; -inf (and slot -1) sit in the same
    places; the finite slot sets agree except for rows tied (within
    ``atol``) at the k-th score."""
    s_ref, s_got = np.asarray(s_ref, np.float32), np.asarray(s_got, np.float32)
    i_ref, i_got = np.asarray(i_ref), np.asarray(i_got)
    assert s_ref.shape == s_got.shape and i_ref.shape == i_got.shape
    neg_ref, neg_got = np.isneginf(s_ref), np.isneginf(s_got)
    np.testing.assert_array_equal(neg_ref, neg_got)
    np.testing.assert_allclose(
        s_got[~neg_got], s_ref[~neg_ref], atol=atol, rtol=0
    )
    s2 = s_ref.reshape(-1, s_ref.shape[-1])
    g2s = s_got.reshape(s2.shape)
    r2, g2 = i_ref.reshape(s2.shape), i_got.reshape(s2.shape)
    ok2 = ~np.isneginf(s2)
    np.testing.assert_array_equal(r2[~ok2], -1)
    np.testing.assert_array_equal(g2[~ok2], -1)
    for row in range(s2.shape[0]):
        ok = ok2[row]
        a, b = set(r2[row][ok].tolist()), set(g2[row][ok].tolist())
        if a != b:
            # every disagreeing slot must score at the tied boundary
            kth = s2[row][ok].min()
            score = dict(zip(g2[row][ok].tolist(), g2s[row][ok].tolist()))
            score.update(zip(r2[row][ok].tolist(), s2[row][ok].tolist()))
            for slot in a ^ b:
                assert abs(score[slot] - kth) <= atol, (row, slot)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_pair(x):
    """The same bf16 values for both libraries."""
    j = jnp.asarray(x, jnp.bfloat16)
    t = _t(x).to(torch.bfloat16)
    return j, t


@pytest.mark.parametrize("n,d", [(7, 16), (33, 64)])
def test_l2_normalize_matches_with_zero_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32) * 3
    x[0] = 0.0
    x[n // 2] = 1e-30
    got = t_norm(_t(x)).numpy()
    ref = np.asarray(j_norm(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got[0], 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k", [1, 10, 300])
def test_exact_search_matches(rng, dtype, k):
    n, d, b = 257, 32, 6
    db = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    valid = rng.random(n) > 0.1
    jv, tv = jnp.asarray(valid), _t(valid)
    if dtype == "int8":
        qc, sc = jquant.quantize_rows(jnp.asarray(db))
        jdb, jsc = qc, sc
        tdb, tsc = _t(np.asarray(qc)), _t(np.asarray(sc))
    elif dtype == "bfloat16":
        jdb, tdb = _bf16_pair(db)
        jsc = tsc = None
    else:
        jdb, tdb, jsc, tsc = jnp.asarray(db), _t(db), None, None
    prec = "highest" if dtype == "float32" else "default"
    sj, ij = j_exact(jdb, jnp.asarray(q), k=k, valid=jv, precision=prec,
                     scales=jsc, normalize=True)
    st, it = t_exact(tdb, _t(q), k=k, valid=tv, precision=prec,
                     scales=tsc, normalize=True)
    assert it.dtype == torch.int64
    ij = np.where(np.isneginf(np.asarray(sj)), -1, np.asarray(ij))
    it = np.where(np.isneginf(st.numpy()), -1, it.numpy())
    assert_topk_match(sj, ij, st.numpy(), it, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_block_matches(rng, dtype):
    db = rng.standard_normal((40, 24)).astype(np.float32)
    q = rng.standard_normal((5, 24)).astype(np.float32)
    if dtype == "bfloat16":
        jdb, tdb = _bf16_pair(db)
    else:
        jdb, tdb = jnp.asarray(db), _t(db)
    ref = np.asarray(j_score(jdb, jnp.asarray(q)), np.float32)
    got = t_score(tdb, _t(q)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("c,k", [(12, 5), (4, 9)])
def test_topk_merge_matches(rng, c, k):
    s = rng.standard_normal((3, c)).astype(np.float32)
    s[0, :2] = -np.inf
    ids = rng.permutation(1000)[: 3 * c].reshape(3, c).astype(np.int64)
    sj, ij = j_merge(jnp.asarray(s), jnp.asarray(ids), k=k)
    st, it = t_merge(_t(s), _t(ids), k=k)
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    fin = np.isfinite(st.numpy())  # ids of -inf candidates may differ
    np.testing.assert_array_equal(np.asarray(ij)[fin], it.numpy()[fin])
    assert it.dtype == torch.int64


@pytest.mark.parametrize("n,d", [(50, 32), (9, 384)])
def test_int8_codes_bit_identical(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[0] = 0.0
    x[1, :4] = [127.0, 63.5, -63.5, 0.5]  # exact halves round to even
    qj, sj = jquant.quantize_rows(jnp.asarray(x))
    qt, st = tquant.quantize_rows(_t(x))
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(
        np.asarray(jquant.dequantize_rows(qj, sj)),
        tquant.dequantize_rows(qt, st).numpy(),
    )
    q = rng.standard_normal((4, d)).astype(np.float32)
    np.testing.assert_allclose(
        tquant.int8_score(qt, st, _t(q)).numpy(),
        np.asarray(jquant.int8_score(qj, sj, jnp.asarray(q))),
        atol=1e-4, rtol=1e-5,
    )


@pytest.mark.parametrize("n,d", [(50, 32), (9, 384)])
def test_int4_codes_bit_identical(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[0] = 0.0
    x[1, :3] = [7.0, 3.5, -2.5]  # exact halves at scale 1 round to even
    pj, sj = jquant.quantize_rows_int4(jnp.asarray(x))
    pt, st = tquant.quantize_rows_int4(_t(x))
    assert pt.dtype == torch.uint8 and pt.shape == (n, d // 2)
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(
        np.asarray(jquant.unpack_int4(pj)), tquant.unpack_int4(pt).numpy()
    )
    np.testing.assert_array_equal(
        np.asarray(jquant.dequantize_rows_int4(pj, sj)),
        tquant.dequantize_rows_int4(pt, st).numpy(),
    )
    # nibble layout: byte j holds dim j low, dim j + d/2 high (offset 8)
    codes = tquant.unpack_int4(pt).numpy()
    raw = pt.numpy()
    np.testing.assert_array_equal((raw & 0xF).astype(np.int8) - 8, codes[:, : d // 2])
    np.testing.assert_array_equal((raw >> 4).astype(np.int8) - 8, codes[:, d // 2:])


def test_port_on_cpu_stays_in_the_tests(monkeypatch):
    """Without the helper the port's default is the card, and it raises
    where there is none; with it the default is the CPU; undone, it
    raises again."""
    from wdbx_tpu_torch.index.flat import FlatIndex
    from wdbx_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.is_available():
        pytest.skip("the port's default is a card on this host")
    monkeypatch.delenv(mesh_mod.MESH_SIZE_ENV, raising=False)

    def raises():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            index_base.resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            index_flat.resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FlatIndex(8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()

    raises()
    with monkeypatch.context() as mp:
        port_on_cpu(mp)
        cpu = torch.device("cpu")
        assert index_base.resolve_device(None) == cpu
        assert index_flat.resolve_device(None) == cpu
        assert FlatIndex(8).device == cpu
        mesh = make_mesh()
        assert mesh.size == PORT_MESH_SIZE
        assert set(mesh.devices) == {cpu}
        assert make_mesh(2, device="cpu").size == 2
    raises()
