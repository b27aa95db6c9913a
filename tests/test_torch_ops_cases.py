"""The cases of ``tests/test_ops.py`` on the port, on the CPU.

A translated copy of that file: the same classes, functions,
parametrisations and asserts, run on ``wdbx_tpu_torch``. Each
``wdbx_tpu`` import names its ``wdbx_tpu_torch`` counterpart; the
autouse fixture asks for the CPU through
``test_torch_ops.port_on_cpu`` (the default device and mesh of one
test), so the package keeps the card as its own default.

Translated (25 cases):
TestNormalize: test_unit_norm, test_zero_vector_safe; TestExactSearch:
test_matches_numpy_oracle, test_self_query_is_top1,
test_valid_mask_excludes, test_k_exceeds_n_pads, test_bf16_db_recall;
TestTopkMerge: test_merge_two_shards, test_neg_inf_padding_sinks,
test_k_exceeds_candidates; TestKmeans: test_recovers_separated_clusters,
test_assignment_is_nearest_centroid; TestClusteredKernelV2Matrix:
test_matches_exact_over_scanned_rows, test_all_masked_returns_neg;
TestKernelContracts: test_ivf_bucket_scan_rejects_deep_k,
test_ivf_bucket_scan_rejects_int8_table,
test_ivf_index_routes_deep_fetch_to_lax.

Changed beyond the imports and the fixture: every ``jnp`` value is its
torch counterpart on the CPU (``torch.as_tensor``, ``torch.zeros`` /
``torch.ones`` with the same dtype), and the bf16 slab of
``TestClusteredKernelV2Matrix`` reads back through ``.float()``. The
oracles stay: numpy, the bf16 recall bar, ``k > n`` padding, -inf
sinking in the merge, k-means on separated clusters, and K3 (v2)
against exact over the scanned rows at B 1 / 8 / 64 and bf16 / int8 /
int4. Left out, one case:
``TestKernelContracts::test_group_reduce_rejects_partial_tail``. It
imports ``_group_reduce`` / ``_pair_reduce``, and the port has no
``group`` pre-reduction (its K1 / K2 take ``group`` and ignore it).

The two ``TestKmeans`` cases showed a fault of the port, now fixed:
``from wdbx_tpu_torch.ops import kmeans`` gave the module where the
JAX package's gives the function.

The reference file's description:

Unit tests for the device op layer (exact search, normalize, merge, kmeans).
"""

import numpy as np
import pytest
import torch

from wdbx_tpu_torch.ops import exact_search, kmeans, l2_normalize, topk_merge
from test_torch_ops import port_on_cpu


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    port_on_cpu(monkeypatch)


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


class TestNormalize:
    def test_unit_norm(self, rng):
        x = rng.standard_normal((32, 384)).astype(np.float32) * 5
        out = np.asarray(l2_normalize(torch.as_tensor(x)))
        np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, rtol=1e-5)

    def test_zero_vector_safe(self):
        out = np.asarray(l2_normalize(torch.zeros((2, 8))))
        assert np.all(np.isfinite(out))
        np.testing.assert_array_equal(out, 0.0)


class TestExactSearch:
    def test_matches_numpy_oracle(self, rng):
        db = _normed(rng, 1000, 64)
        q = _normed(rng, 16, 64)
        scores, idx = exact_search(torch.as_tensor(db), torch.as_tensor(q), k=10)
        ref = q @ db.T
        ref_idx = np.argsort(-ref, axis=-1)[:, :10]
        ref_scores = np.take_along_axis(ref, ref_idx, axis=-1)
        np.testing.assert_allclose(np.asarray(scores), ref_scores, rtol=1e-4, atol=1e-5)
        # Indices may permute within score ties; compare via scores per rank.
        got = np.take_along_axis(ref, np.asarray(idx), axis=-1)
        np.testing.assert_allclose(got, ref_scores, rtol=1e-4, atol=1e-5)

    def test_self_query_is_top1(self, rng):
        db = _normed(rng, 500, 32)
        scores, idx = exact_search(torch.as_tensor(db), torch.as_tensor(db[:8]), k=1)
        np.testing.assert_array_equal(np.asarray(idx)[:, 0], np.arange(8))
        np.testing.assert_allclose(np.asarray(scores)[:, 0], 1.0, rtol=1e-4)

    def test_valid_mask_excludes(self, rng):
        db = _normed(rng, 100, 16)
        valid = np.ones(100, bool)
        valid[:50] = False
        _, idx = exact_search(
            torch.as_tensor(db), torch.as_tensor(db[:4]), k=5,
            valid=torch.as_tensor(valid),
        )
        assert np.all(np.asarray(idx) >= 50)

    def test_k_exceeds_n_pads(self, rng):
        db = _normed(rng, 3, 8)
        scores, idx = exact_search(torch.as_tensor(db), torch.as_tensor(db[:2]), k=8)
        assert scores.shape == (2, 8)
        assert np.all(np.asarray(scores)[:, 3:] == -np.inf)
        assert np.all(np.asarray(idx)[:, 3:] == -1)

    def test_bf16_db_recall(self, rng):
        db = _normed(rng, 2000, 128)
        q = _normed(rng, 8, 128)
        _, idx32 = exact_search(torch.as_tensor(db), torch.as_tensor(q), k=10)
        _, idx16 = exact_search(
            torch.as_tensor(db, dtype=torch.bfloat16), torch.as_tensor(q), k=10
        )
        overlap = np.mean(
            [
                len(set(a.tolist()) & set(b.tolist())) / 10
                for a, b in zip(np.asarray(idx32), np.asarray(idx16))
            ]
        )
        assert overlap >= 0.9


class TestTopkMerge:
    def test_merge_two_shards(self):
        s = torch.as_tensor([[0.9, 0.5, 0.1, 0.95, 0.4, 0.2]])
        i = torch.as_tensor([[0, 1, 2, 100, 101, 102]])
        scores, ids = topk_merge(s, i, k=3)
        np.testing.assert_allclose(np.asarray(scores)[0], [0.95, 0.9, 0.5], rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(ids)[0], [100, 0, 1])

    def test_neg_inf_padding_sinks(self):
        s = torch.as_tensor([[-np.inf, 0.3, -np.inf, 0.7]])
        i = torch.as_tensor([[-1, 5, -1, 9]])
        scores, ids = topk_merge(s, i, k=2)
        np.testing.assert_array_equal(np.asarray(ids)[0], [9, 5])

    def test_k_exceeds_candidates(self):
        s = torch.as_tensor([[0.5, 0.1]])
        i = torch.as_tensor([[3, 4]])
        scores, ids = topk_merge(s, i, k=4)
        assert scores.shape == (1, 4)
        assert np.asarray(scores)[0, 2] == -np.inf


class TestKmeans:
    def test_recovers_separated_clusters(self, rng):
        # 4 well-separated direction clusters on the sphere.
        centers = _normed(rng, 4, 32)
        pts = np.concatenate(
            [
                c + 0.05 * rng.standard_normal((64, 32)).astype(np.float32)
                for c in centers
            ]
        )
        pts = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
        cents, assign = kmeans(torch.as_tensor(pts), num_clusters=4, iters=20)
        assign = np.asarray(assign)
        # Every ground-truth cluster maps to one dominant learned cluster.
        for g in range(4):
            block = assign[g * 64 : (g + 1) * 64]
            dominant = np.bincount(block, minlength=4).max()
            assert dominant >= 60
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(cents), axis=-1), 1.0, rtol=1e-4
        )

    def test_assignment_is_nearest_centroid(self, rng):
        pts = _normed(rng, 200, 16)
        cents, assign = kmeans(torch.as_tensor(pts), num_clusters=8, iters=10)
        sims = pts @ np.asarray(cents).T
        np.testing.assert_array_equal(np.asarray(assign), np.argmax(sims, axis=-1))


class TestClusteredKernelV2Matrix:
    """Property matrix for the v2 block-scan kernel (interpret mode):
    across dtypes, widths, batch sizes, groups, and padded block lists,
    v2's top-k must agree with the exact oracle over the scanned rows
    (up to quantization noise on the VALUES; positions checked by
    score-parity, not identity — ties may reorder)."""

    @pytest.mark.parametrize("int_mode", ["bf16", "int8", "int4"])
    @pytest.mark.parametrize("b", [1, 8, 64])
    def test_matches_exact_over_scanned_rows(self, int_mode, b):
        from wdbx_tpu_torch.kernels.clustered_scan import clustered_block_topk_v2
        from wdbx_tpu_torch.kernels.quant import quantize_rows_int4

        # stable per-case seed (hash() is salted per process -> flaky)
        seed = ["bf16", "int8", "int4"].index(int_mode) * 1000 + b
        rng = np.random.default_rng(seed)
        d, c, k = 64, 256, 8
        nblocks = 24
        cap = nblocks * c
        slab = rng.standard_normal((cap, d)).astype(np.float32)
        slab /= np.linalg.norm(slab, axis=1, keepdims=True)
        valid = (rng.random(cap) > 0.1).astype(np.int8).reshape(1, -1)
        q = rng.standard_normal((b, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        live = 10
        u = 16  # live entries first, padding pinned + masked
        real = rng.permutation(nblocks)[:live].astype(np.int32)
        uniq = np.full(u, nblocks - 1, np.int32)
        uniq[:live] = real
        ok = np.zeros(u, np.int32)
        ok[:live] = 1
        int4 = int_mode == "int4"
        if int_mode == "bf16":
            sl = torch.as_tensor(slab, dtype=torch.bfloat16)
            sc = None
            stored = sl.float().numpy()
        elif int_mode == "int8":
            s_row = (np.abs(slab).max(axis=1) / 127.0).astype(np.float32)
            codes = np.clip(
                np.round(slab / s_row[:, None]), -127, 127
            ).astype(np.int8)
            sl = torch.as_tensor(codes)
            sc = torch.as_tensor(s_row.reshape(1, -1))
            stored = codes.astype(np.float32) * s_row[:, None]
        else:
            packed, s_row = quantize_rows_int4(torch.as_tensor(slab))
            sl = packed
            sc = torch.as_tensor(np.asarray(s_row).reshape(1, -1))
            lo = (np.asarray(packed) & 0xF).astype(np.int8) - 8
            hi = (np.asarray(packed) >> 4).astype(np.int8) - 8
            stored = np.concatenate([lo, hi], axis=1).astype(
                np.float32
            ) * np.asarray(s_row)[:, None]
        v, p = clustered_block_topk_v2(
            sl, torch.as_tensor(valid), sc, torch.as_tensor(uniq),
            torch.as_tensor(ok), torch.as_tensor(q),
            k=k, c=c, interpret=True, n_ways=4, int4=int4,
        )
        v, p = np.asarray(v), np.asarray(p)
        assert v.shape == (b, k) and p.shape == (b, k)
        rows = np.concatenate([np.arange(x * c, (x + 1) * c) for x in real])
        rows = rows[valid[0, rows] != 0]
        ref = q @ stored[rows].T  # exact over STORED (quantized) values
        ref_top = -np.sort(-ref, axis=1)[:, :k]
        # score parity: the kernel's k-th value within quantization-of-q
        # noise of the exact k-th over the same candidate set
        tol = 0.05 if int_mode != "bf16" else 0.02
        np.testing.assert_allclose(v, ref_top, atol=tol, rtol=0.05)
        # positions are from scanned, valid rows only
        rowset = set(rows.tolist())
        assert all(int(x) in rowset for x in p.ravel())

    def test_all_masked_returns_neg(self):
        from wdbx_tpu_torch.kernels.clustered_scan import clustered_block_topk_v2

        d, c = 64, 256
        cap = 8 * c
        sl = torch.zeros((cap, d), dtype=torch.bfloat16)
        uniq = np.full(8, 7, np.int32)
        ok = np.zeros(8, np.int32)  # nothing live
        v, p = clustered_block_topk_v2(
            sl, torch.ones((1, cap), dtype=torch.int8), None,
            torch.as_tensor(uniq), torch.as_tensor(ok),
            torch.ones((4, d), dtype=torch.float32),
            k=5, c=c, interpret=True, n_ways=4,
        )
        assert (np.asarray(v) <= -3.0e38).all()


class TestKernelContracts:
    """Regressions for the r3 kernel-layer review: silent-wrongness
    modes must raise (or route to a correct path) instead."""

    def _slab(self, rng, nblocks=8, c=256, d=64, dtype=None):
        cap = nblocks * c
        slab = rng.standard_normal((cap, d)).astype(np.float32)
        slab /= np.linalg.norm(slab, axis=1, keepdims=True)
        return torch.as_tensor(slab, dtype=dtype or torch.bfloat16)

    def test_ivf_bucket_scan_rejects_deep_k(self, rng):
        from wdbx_tpu_torch.kernels.ivf_scan import ivf_bucket_scan

        rows = torch.zeros((4, 256, 64), dtype=torch.bfloat16)
        v8 = torch.ones((4, 8, 256), dtype=torch.int8)
        probes = torch.zeros(4, dtype=torch.int32)
        qidx = torch.zeros(4, dtype=torch.int32)
        q = torch.zeros((2, 64), dtype=torch.float32)
        with pytest.raises(ValueError, match="k <= 128"):
            ivf_bucket_scan(rows, v8, probes, qidx, q, k=200,
                            interpret=True)

    def test_ivf_bucket_scan_rejects_int8_table(self, rng):
        from wdbx_tpu_torch.kernels.ivf_scan import ivf_bucket_scan

        rows = torch.zeros((4, 256, 64), dtype=torch.int8)
        v8 = torch.ones((4, 8, 256), dtype=torch.int8)
        probes = torch.zeros(4, dtype=torch.int32)
        qidx = torch.zeros(4, dtype=torch.int32)
        q = torch.zeros((2, 64), dtype=torch.float32)
        with pytest.raises(TypeError, match="float bucket table"):
            ivf_bucket_scan(rows, v8, probes, qidx, q, k=10,
                            interpret=True)

    def test_ivf_index_routes_deep_fetch_to_lax(self, rng):
        """k*assignments > 128 must fall back to the (exact) lax scan,
        not truncate candidates inside the pallas kernel."""
        from wdbx_tpu_torch.index.ivf import IVFIndex

        # k=150 > 128: crosses the kernel's result-lane budget, so the
        # router MUST take the lax scan (k=80 would legally stay on the
        # pallas kernel and never exercise the fallback)
        d, n, k = 32, 3000, 150
        idx = IVFIndex(d, nlist=8, nprobe=8, train_threshold=256)
        idx.ivf_kernel = "pallas"
        idx.batch_flat_fallback = False
        db = rng.standard_normal((n, d)).astype(np.float32)
        db /= np.linalg.norm(db, axis=1, keepdims=True)
        slots = idx.add_batch(db)
        idx.build()
        q = rng.standard_normal((4, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        _, got = idx.search(q, k)
        exp = slots[np.argsort(-(q @ db.T), axis=-1)[:, :k]]
        recall = np.mean([
            len(set(a.tolist()) & set(b.tolist())) / k
            for a, b in zip(got, exp)
        ])
        assert recall >= 0.95, recall
