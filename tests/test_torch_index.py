"""The cases of ``tests/test_index.py`` on the port, on the CPU.

A translated copy of that file: the same classes, functions,
parametrisations and asserts, run on ``wdbx_tpu_torch``. Each
``wdbx_tpu`` import names its ``wdbx_tpu_torch`` counterpart; the
autouse fixture asks for the CPU through
``test_torch_ops.port_on_cpu`` (the default device and mesh of one
test), so the package keeps the card as its own default.

Translated, every case (68 cases):
TestFlatIndex: test_add_search_roundtrip, test_dim_mismatch_raises,
test_growth_beyond_capacity, test_remove_tombstones_and_reuse,
test_update_slots, test_slot_mask_prefilter,
test_cosine_normalizes_unnormalized_input, test_persistence_roundtrip,
test_load_missing_returns_false, test_bfloat16_slab, test_clear,
test_stats; TestIVFIndex: test_recall_vs_exact,
test_tune_hits_target_recall, test_untrained_falls_back_to_flat,
test_auto_train_on_search, test_fresh_buffer_adds_visible,
test_delete_after_build_invisible,
test_no_duplicate_results_after_reuse, test_rebuild_absorbs_residual,
test_slot_mask_filters_bucket_rows,
test_int8_ip_bucket_residual_consistent, test_persistence_roundtrip;
TestFactory: test_create_flat, test_create_ivf_aliases_to_clustered,
test_faiss_ivf_factory_string_routes_clustered,
test_dense_checkpoint_adopts_into_clustered, test_unknown_raises,
test_kernel_knobs_from_config; TestInt8: test_int8_flat_recall,
test_int8_self_query, test_int8_get_vectors_dequantized,
test_int8_persistence, test_int8_sharded; TestTopkMethods:
test_fused_matches_exact, test_fused_respects_tombstones_and_mask,
test_fused_k_exceeds_live, test_approx_method,
test_unknown_method_raises, test_auto_resolves_by_backend,
test_fused_int8_scales, test_search_pipelined_matches_search,
test_search_pipelined_fused_interpret; TestCompaction:
test_compact_repacks_live_rows, test_store_optimize_compacts_and_remaps,
test_ivf_compact_rebuilds_overlay; TestOrbaxPersistence:
test_flat_orbax_roundtrip, test_sharded_orbax_roundtrip,
test_int8_orbax; TestIVFUpdate:
test_update_after_build_visible_with_new_value; TestIVFScanPath:
test_scan_self_query, test_scan_full_probe_is_exact,
test_scan_respects_deletes, test_scan_sees_residual_adds,
test_scan_update_serves_new_value; TestIVFPallasKernel:
test_pallas_matches_lax, test_pallas_with_residual_and_deletes;
TestMultiAssignment: test_soar_improves_recall_at_fixed_nprobe,
test_no_duplicates_with_multi_assignment,
test_multi_assign_delete_removes_all_copies; TestIVFInt8:
test_ivf_int8_end_to_end; test_ivf_search_pipelined_matches_search;
test_ivf_inflight_pipelined_matches_blocking;
test_half_precision_query_stacks; test_ivf_int8_tables_stay_int8;
test_spill_does_not_trigger_rebuild_loop;
test_ivf_pipelined_dedups_multi_assignment.

Changed beyond the imports and the fixture, two cases:
``test_ivf_int8_tables_stay_int8`` holds the dense engine's bucket table
(``_bucket_rows``, where the port keeps it too) to ``torch.int8`` where
the reference names ``jnp.int8``;
``TestTopkMethods::test_auto_resolves_by_backend`` reads the backend
from the index's ``device.type`` (the port's ``_resolve_topk`` reads it
there) where the reference asks ``jax.default_backend()``. Left out:
nothing.

The reference file's description:

Index layer tests: flat slab CRUD, growth, tombstones, persistence,
and IVF recall vs the exact oracle (the parity spec the reference lacks —
SURVEY.md §4 'implication for our build').
"""

import numpy as np
import pytest

from wdbx_tpu_torch.index import FlatIndex, IVFIndex, create_index
from test_torch_ops import port_on_cpu


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    port_on_cpu(monkeypatch)


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


class TestFlatIndex:
    def test_add_search_roundtrip(self, rng):
        idx = FlatIndex(dim=32)
        vecs = _normed(rng, 100, 32)
        slots = idx.add_batch(vecs)
        assert len(set(slots.tolist())) == 100
        scores, got = idx.search(vecs[:5], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[:5])
        np.testing.assert_allclose(scores[:, 0], 1.0, rtol=1e-4)

    def test_dim_mismatch_raises(self):
        idx = FlatIndex(dim=8)
        with pytest.raises(ValueError, match="dimension"):
            idx.add_batch(np.ones((1, 4), np.float32))

    def test_growth_beyond_capacity(self, rng):
        idx = FlatIndex(dim=16, capacity=32)
        vecs = _normed(rng, 200, 16)
        idx.add_batch(vecs)
        assert idx.count() == 200
        assert idx.capacity >= 200
        _, got = idx.search(vecs[150:152], k=1)
        assert got[0, 0] == 150 and got[1, 0] == 151

    def test_remove_tombstones_and_reuse(self, rng):
        idx = FlatIndex(dim=16)
        vecs = _normed(rng, 10, 16)
        slots = idx.add_batch(vecs)
        idx.remove_slots(slots[:5])
        assert idx.count() == 5
        _, got = idx.search(vecs[0], k=3)
        assert slots[0] not in got[0]
        # freed slots get recycled
        new_slots = idx.add_batch(_normed(rng, 5, 16))
        assert set(new_slots.tolist()) == set(slots[:5].tolist())

    def test_update_slots(self, rng):
        idx = FlatIndex(dim=16)
        vecs = _normed(rng, 4, 16)
        slots = idx.add_batch(vecs)
        new_vec = _normed(rng, 1, 16)
        idx.update_slots(slots[:1], new_vec)
        scores, got = idx.search(new_vec, k=1)
        assert got[0, 0] == slots[0]
        np.testing.assert_allclose(scores[0, 0], 1.0, rtol=1e-4)

    def test_slot_mask_prefilter(self, rng):
        idx = FlatIndex(dim=16)
        vecs = _normed(rng, 20, 16)
        slots = idx.add_batch(vecs)
        mask = np.zeros(idx.capacity + 1, bool)
        mask[slots[10:]] = True
        _, got = idx.search(vecs[0], k=5, slot_mask=mask)
        assert all(g in slots[10:] for g in got[0] if g >= 0)

    def test_cosine_normalizes_unnormalized_input(self, rng):
        idx = FlatIndex(dim=16)
        raw = rng.standard_normal((10, 16)).astype(np.float32) * 7
        slots = idx.add_batch(raw)
        scores, got = idx.search(raw[3] * 2.5, k=1)
        assert got[0, 0] == slots[3]
        np.testing.assert_allclose(scores[0, 0], 1.0, rtol=1e-4)

    def test_persistence_roundtrip(self, rng, temp_dir):
        idx = FlatIndex(dim=16)
        vecs = _normed(rng, 50, 16)
        slots = idx.add_batch(vecs)
        idx.remove_slots(slots[:3])
        idx.save(f"{temp_dir}/flat")
        idx2 = FlatIndex(dim=16)
        assert idx2.load(f"{temp_dir}/flat")
        assert idx2.count() == 47
        _, got = idx2.search(vecs[10], k=1)
        assert got[0, 0] == slots[10]
        _, got = idx2.search(vecs[0], k=50)
        assert slots[0] not in got[0]

    def test_load_missing_returns_false(self, temp_dir):
        assert not FlatIndex(dim=8).load(f"{temp_dir}/nope")

    def test_bfloat16_slab(self, rng, temp_dir):
        idx = FlatIndex(dim=32, dtype="bfloat16")
        vecs = _normed(rng, 64, 32)
        slots = idx.add_batch(vecs)
        _, got = idx.search(vecs[:4], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[:4])
        idx.save(f"{temp_dir}/bf16")
        idx2 = FlatIndex(dim=32, dtype="bfloat16")
        assert idx2.load(f"{temp_dir}/bf16")
        _, got = idx2.search(vecs[:4], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[:4])

    def test_clear(self, rng):
        idx = FlatIndex(dim=8)
        idx.add_batch(_normed(rng, 10, 8))
        idx.clear()
        assert idx.count() == 0
        scores, got = idx.search(_normed(rng, 1, 8), k=3)
        assert np.all(got == -1)

    def test_stats(self, rng):
        idx = FlatIndex(dim=8)
        idx.add_batch(_normed(rng, 10, 8))
        s = idx.get_stats()
        assert s["size"] == 10 and s["type"] == "flat" and s["dim"] == 8


class TestIVFIndex:
    def test_recall_vs_exact(self, rng):
        # Clustered data (what real embedding corpora look like); uniform
        # random vectors are the known-adversarial case for any IVF.
        n, d, k = 20_000, 64, 10
        centers = _normed(rng, 128, d)
        noise = 0.4 / np.sqrt(d)
        db = centers[rng.integers(0, 128, n)] + noise * rng.standard_normal(
            (n, d)
        ).astype(np.float32)
        db /= np.linalg.norm(db, axis=-1, keepdims=True)
        queries = db[rng.integers(0, n, 32)] + noise * rng.standard_normal(
            (32, d)
        ).astype(np.float32)
        queries /= np.linalg.norm(queries, axis=-1, keepdims=True)
        ivf = IVFIndex(
            dim=d, nlist=64, nprobe=8, train_threshold=1000, capacity=n
        )
        slots = ivf.add_batch(db)
        ivf.build()
        _, got = ivf.search(queries, k=k)
        exact = np.argsort(-(queries @ db.T), axis=-1)[:, :k]
        exact_slots = slots[exact]
        recall = np.mean(
            [
                len(set(a.tolist()) & set(b.tolist())) / k
                for a, b in zip(got, exact_slots)
            ]
        )
        assert recall >= 0.9, f"recall {recall}"

    def test_tune_hits_target_recall(self, rng):
        n, d, k = 5000, 32, 10
        db = _normed(rng, n, d)  # uniform random: worst case for IVF
        queries = _normed(rng, 16, d)
        ivf = IVFIndex(dim=d, nlist=32, nprobe=1, train_threshold=1000)
        slots = ivf.add_batch(db)
        ivf.build()
        achieved = ivf.tune(queries, k=k, target_recall=0.95)
        assert achieved >= 0.95
        _, got = ivf.search(queries, k=k)
        exact = np.argsort(-(queries @ db.T), axis=-1)[:, :k]
        exact_slots = slots[exact]
        recall = np.mean(
            [
                len(set(a.tolist()) & set(b.tolist())) / k
                for a, b in zip(got, exact_slots)
            ]
        )
        assert recall >= 0.9

    def test_untrained_falls_back_to_flat(self, rng):
        ivf = IVFIndex(dim=16, train_threshold=10_000)
        vecs = _normed(rng, 100, 16)
        slots = ivf.add_batch(vecs)
        assert not ivf.is_trained
        _, got = ivf.search(vecs[:3], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[:3])

    def test_auto_train_on_search(self, rng):
        ivf = IVFIndex(dim=16, nlist=8, train_threshold=256)
        ivf.add_batch(_normed(rng, 300, 16))
        ivf.search(_normed(rng, 1, 16), k=5)
        assert ivf.is_trained

    def test_fresh_buffer_adds_visible(self, rng):
        ivf = IVFIndex(dim=16, nlist=8, train_threshold=64)
        ivf.add_batch(_normed(rng, 100, 16))
        ivf.build()
        late = _normed(rng, 5, 16)
        late_slots = ivf.add_batch(late)
        scores, got = ivf.search(late, k=1)
        np.testing.assert_array_equal(got[:, 0], late_slots)
        np.testing.assert_allclose(scores[:, 0], 1.0, rtol=1e-4)

    def test_delete_after_build_invisible(self, rng):
        ivf = IVFIndex(dim=16, nlist=4, train_threshold=32)
        vecs = _normed(rng, 64, 16)
        slots = ivf.add_batch(vecs)
        ivf.build()
        ivf.remove_slots(slots[:1])
        _, got = ivf.search(vecs[0], k=5)
        assert slots[0] not in got[0]

    def test_no_duplicate_results_after_reuse(self, rng):
        ivf = IVFIndex(dim=16, nlist=4, train_threshold=32)
        vecs = _normed(rng, 64, 16)
        slots = ivf.add_batch(vecs)
        ivf.build()
        ivf.remove_slots(slots[:8])
        ivf.add_batch(_normed(rng, 8, 16))
        _, got = ivf.search(vecs[8:12], k=10)
        for row in got:
            live = [s for s in row if s >= 0]
            assert len(live) == len(set(live))

    def test_rebuild_absorbs_residual(self, rng):
        ivf = IVFIndex(
            dim=16, nlist=4, train_threshold=32, rebuild_fraction=0.1
        )
        ivf.add_batch(_normed(rng, 64, 16))
        ivf.build()
        ivf.add_batch(_normed(rng, 32, 16))  # > 10% of built size
        ivf.search(_normed(rng, 1, 16), k=1)  # triggers rebuild
        assert len(ivf._residual) == 0
        assert ivf._built_size == 96

    @pytest.mark.parametrize("kernel", ["lax", "pallas"])
    def test_slot_mask_filters_bucket_rows(self, rng, kernel):
        """Pre-filter masks must apply to bucket-resident rows, not just
        the fresh buffer (advisor finding r1: filtered searches returned
        trained-in vectors whose metadata failed the filter)."""
        ivf = IVFIndex(dim=16, nlist=4, train_threshold=32)
        ivf.batch_flat_fallback = False  # force the bucket-scan path
        ivf.ivf_kernel = kernel
        vecs = _normed(rng, 64, 16)
        slots = ivf.add_batch(vecs)
        ivf.build()
        assert ivf.is_trained
        mask = np.zeros(ivf.capacity, bool)
        allowed = set(int(s) for s in slots[::2])
        mask[list(allowed)] = True
        ivf.nprobe = 4  # probe everything: max chance to surface masked rows
        _, got = ivf.search(vecs[:16], k=8, slot_mask=mask)
        for row in got:
            for s in row:
                assert s < 0 or int(s) in allowed, f"masked slot {s} returned"
        # self-queries of allowed rows still rank first
        _, got_self = ivf.search(vecs[::2][:4], k=1, slot_mask=mask)
        np.testing.assert_array_equal(got_self[:, 0], slots[::2][:4])

    def test_int8_ip_bucket_residual_consistent(self, rng):
        """With metric='ip' + int8, bucketed and fresh-buffer candidates
        must rank on the same (dequantized, unnormalized) scale."""
        ivf = IVFIndex(dim=16, metric="ip", dtype="int8", nlist=2,
                       train_threshold=16)
        ivf.batch_flat_fallback = False
        base = _normed(rng, 48, 16)
        mags = rng.uniform(0.5, 2.0, size=(48, 1)).astype(np.float32)
        vecs = base * mags  # distinct magnitudes matter for ip
        slots = ivf.add_batch(vecs)
        ivf.build()
        fresh = ivf.add_batch(vecs[:4] * 3.0)  # same directions, bigger
        ivf.nprobe = 2
        scores, got = ivf.search(base[:4], k=2)
        # the 3x fresh copy must beat its bucketed original on raw ip
        for qi in range(4):
            assert got[qi, 0] == fresh[qi], (
                f"q{qi}: fresh (3x magnitude) copy should win ip ranking, "
                f"got slot {got[qi, 0]} scores {scores[qi]}"
            )

    def test_persistence_roundtrip(self, rng, temp_dir):
        ivf = IVFIndex(dim=16, nlist=4, train_threshold=32)
        vecs = _normed(rng, 64, 16)
        slots = ivf.add_batch(vecs)
        ivf.build()
        ivf.add_batch(_normed(rng, 3, 16))
        ivf.save(f"{temp_dir}/ivf")
        ivf2 = IVFIndex(dim=16)
        assert ivf2.load(f"{temp_dir}/ivf")
        assert ivf2.is_trained and ivf2.count() == 67
        _, got = ivf2.search(vecs[:4], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[:4])


class TestFactory:
    def test_create_flat(self):
        assert create_index("flat", 8).kind == "flat"

    def test_create_ivf_aliases_to_clustered(self):
        """r4 matrix pruning: user-facing "ivf" serves via the clustered
        engine (dominates the dense table in every measured regime);
        the dense table stays reachable as "ivf_dense" and for SOAR
        spilled assignment."""
        assert create_index("ivf", 8).kind == "ivf_clustered"
        assert create_index("ivf_dense", 8).kind == "ivf"
        from wdbx_tpu_torch.core.config import WDBXConfig

        cfg = WDBXConfig({"IVF_ASSIGNMENTS": 2})
        idx = create_index("ivf", 8, cfg)
        assert idx.kind == "ivf" and idx.assignments == 2

    def test_faiss_ivf_factory_string_routes_clustered(self):
        from wdbx_tpu_torch.core.config import WDBXConfig

        cfg = WDBXConfig({"FAISS_INDEX_TYPE": "IVF64,Flat"})
        idx = create_index("faiss", 8, cfg)
        assert idx.kind == "ivf_clustered"
        assert idx.nlist == 64  # factory-string nlist wins over IVF_NLIST

    def test_dense_checkpoint_adopts_into_clustered(self, rng, tmp_path):
        """A store saved under the old dense-table "ivf" kind must come
        back up when "ivf" now serves via the clustered engine (identity
        slot adoption; untrained until the next build)."""
        from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex
        from wdbx_tpu_torch.index.ivf import IVFIndex

        dense = IVFIndex(16, nlist=4, nprobe=4, train_threshold=64)
        db = _normed(rng, 200, 16)
        slots = dense.add_batch(db)
        dense.build()
        path = str(tmp_path / "dense_ckpt")
        dense.save(path)
        clu = ClusteredIVFIndex(16, nlist=4, nprobe=4, train_threshold=64)
        assert clu.load(path)
        assert clu.count() == 200
        _, got = clu.search(db[:4], 1)
        assert (got.ravel() == slots[:4]).all()

    def test_unknown_raises(self):
        with pytest.raises(ValueError):
            create_index("hnsw-graph", 8)

    def test_kernel_knobs_from_config(self):
        """IVF_KERNEL_VERSION / IVF_KERNEL_QPREC reach the clustered
        engines (operator control of the scan generation and the
        recall-vs-turbo query precision)."""
        from wdbx_tpu_torch.core.config import WDBXConfig

        cfg = WDBXConfig()
        cfg.set("IVF_KERNEL_VERSION", "v1")
        cfg.set("IVF_KERNEL_QPREC", "int8")
        idx = create_index("ivf_clustered", 8, cfg)
        assert idx.kernel_version == "v1"
        assert idx.kernel_qprec == "int8"
        # invalid spellings fall back to the defaults, not crashes —
        # including the retired "v3" (removed r4), which old configs
        # may still carry
        for stale in ("v9", "v3"):
            cfg.set("IVF_KERNEL_VERSION", stale)
            cfg.set("IVF_KERNEL_QPREC", "fp8")
            idx2 = create_index("ivf_clustered", 8, cfg)
            assert getattr(idx2, "kernel_version", "auto") == "auto"
            assert getattr(idx2, "kernel_qprec", "bf16") == "bf16"


class TestInt8:
    def test_int8_flat_recall(self, rng):
        from wdbx_tpu_torch.index import FlatIndex

        db = _normed(rng, 5000, 64)
        idx = FlatIndex(dim=64, dtype="int8", capacity=5000)
        slots = idx.add_batch(db)
        q = _normed(rng, 16, 64)
        _, got = idx.search(q, k=10)
        exact = np.argsort(-(q @ db.T), axis=-1)[:, :10]
        exact_slots = slots[exact]
        recall = np.mean(
            [
                len(set(a.tolist()) & set(b.tolist())) / 10
                for a, b in zip(got, exact_slots)
            ]
        )
        assert recall >= 0.95, f"int8 recall {recall}"

    def test_int8_self_query(self, rng):
        from wdbx_tpu_torch.index import FlatIndex

        idx = FlatIndex(dim=32, dtype="int8")
        vecs = _normed(rng, 100, 32)
        slots = idx.add_batch(vecs)
        scores, got = idx.search(vecs[:8], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[:8])
        np.testing.assert_allclose(scores[:, 0], 1.0, atol=0.02)

    def test_int8_get_vectors_dequantized(self, rng):
        from wdbx_tpu_torch.index import FlatIndex

        idx = FlatIndex(dim=16, dtype="int8")
        vecs = _normed(rng, 4, 16)
        slots = idx.add_batch(vecs)
        back = idx.get_vectors(slots)
        np.testing.assert_allclose(back, vecs, atol=0.02)

    def test_int8_persistence(self, rng, temp_dir):
        from wdbx_tpu_torch.index import FlatIndex

        idx = FlatIndex(dim=16, dtype="int8")
        vecs = _normed(rng, 50, 16)
        slots = idx.add_batch(vecs)
        idx.save(f"{temp_dir}/i8")
        idx2 = FlatIndex(dim=16, dtype="int8")
        assert idx2.load(f"{temp_dir}/i8")
        _, got = idx2.search(vecs[:4], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[:4])

    def test_int8_sharded(self, rng, temp_dir):
        from wdbx_tpu_torch.parallel import ShardedFlatIndex

        idx = ShardedFlatIndex(dim=32, dtype="int8")
        vecs = _normed(rng, 200, 32)
        slots = idx.add_batch(vecs)
        scores, got = idx.search(vecs[:8], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[:8])
        np.testing.assert_allclose(scores[:, 0], 1.0, atol=0.02)
        idx.remove_slots(slots[:2])
        _, got = idx.search(vecs[0], k=5)
        assert slots[0] not in got[0]
        idx.save(f"{temp_dir}/i8s")
        idx2 = ShardedFlatIndex(dim=32, dtype="int8")
        assert idx2.load(f"{temp_dir}/i8s")
        _, got = idx2.search(vecs[2:6], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[2:6])


class TestTopkMethods:
    def test_fused_matches_exact(self, rng):
        from wdbx_tpu_torch.index import FlatIndex

        vecs = _normed(rng, 600, 32)
        exact_idx = FlatIndex(dim=32, capacity=1024)
        fused_idx = FlatIndex(dim=32, capacity=1024, topk_method="fused")
        s1 = exact_idx.add_batch(vecs)
        s2 = fused_idx.add_batch(vecs)
        q = _normed(rng, 8, 32)
        _, got_e = exact_idx.search(q, k=10)
        _, got_f = fused_idx.search(q, k=10)
        for a, b in zip(got_e, got_f):
            assert set(a.tolist()) == set(b.tolist())

    def test_fused_respects_tombstones_and_mask(self, rng):
        from wdbx_tpu_torch.index import FlatIndex

        idx = FlatIndex(dim=16, capacity=1024, topk_method="fused")
        vecs = _normed(rng, 50, 16)
        slots = idx.add_batch(vecs)
        idx.remove_slots(slots[:5])
        _, got = idx.search(vecs[0], k=5)
        assert slots[0] not in got[0]
        mask = np.zeros(idx.capacity, bool)
        mask[slots[20:]] = True
        _, got = idx.search(vecs[25], k=3, slot_mask=mask)
        assert got[0, 0] == slots[25]

    def test_fused_k_exceeds_live(self, rng):
        from wdbx_tpu_torch.index import FlatIndex

        idx = FlatIndex(dim=8, capacity=1024, topk_method="fused")
        vecs = _normed(rng, 3, 8)
        idx.add_batch(vecs)
        scores, got = idx.search(vecs[:1], k=8)
        live = got[0][got[0] >= 0]
        assert len(live) == 3

    def test_approx_method(self, rng):
        from wdbx_tpu_torch.index import FlatIndex

        idx = FlatIndex(dim=32, capacity=2048, topk_method="approx")
        vecs = _normed(rng, 500, 32)
        slots = idx.add_batch(vecs)
        _, got = idx.search(vecs[:4], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[:4])

    def test_unknown_method_raises(self):
        from wdbx_tpu_torch.index import FlatIndex

        with pytest.raises(ValueError):
            FlatIndex(dim=8, topk_method="magic")

    def test_auto_resolves_by_backend(self):
        from wdbx_tpu_torch.index import FlatIndex

        idx = FlatIndex(dim=8)  # default is auto
        expected = "fused" if idx.device.type == "cuda" else "exact"
        assert idx._resolve_topk() == expected

    def test_fused_int8_scales(self, rng):
        """int8 slabs go through the fused kernel with per-row scales;
        ip ranking must respect magnitudes (not just directions)."""
        from wdbx_tpu_torch.index import FlatIndex

        idx = FlatIndex(dim=32, metric="ip", dtype="int8", capacity=1024,
                        topk_method="fused")
        base = np.eye(32, dtype=np.float32)  # orthogonal: no cross-talk
        vecs = base * rng.uniform(0.5, 2.0, size=(32, 1)).astype(np.float32)
        slots = idx.add_batch(vecs)
        big = idx.add_batch(vecs[:4] * 3.0)  # same direction, 3x magnitude
        scores, got = idx.search(base[:4], k=2)
        np.testing.assert_array_equal(got[:, 0], big)
        np.testing.assert_array_equal(got[:, 1], slots[:4])

    def test_search_pipelined_matches_search(self, rng):
        from wdbx_tpu_torch.index import FlatIndex

        idx = FlatIndex(dim=16, capacity=1024)
        vecs = _normed(rng, 300, 16)
        slots = idx.add_batch(vecs)
        idx.remove_slots(slots[:10])
        qstack = _normed(rng, 24, 16).reshape(3, 8, 16)
        s3, i3 = idx.search_pipelined(qstack, k=5)
        assert s3.shape == (3, 8, 5) and i3.shape == (3, 8, 5)
        for nb in range(3):
            s1, i1 = idx.search(qstack[nb], k=5)
            np.testing.assert_array_equal(i3[nb], i1)
            np.testing.assert_allclose(s3[nb], s1, rtol=1e-5)

    def test_search_pipelined_fused_interpret(self, rng):
        from wdbx_tpu_torch.index import FlatIndex

        idx = FlatIndex(dim=16, capacity=256, topk_method="fused")
        vecs = _normed(rng, 100, 16)
        slots = idx.add_batch(vecs)
        qstack = vecs[:8].reshape(2, 4, 16)
        _, i3 = idx.search_pipelined(qstack, k=1)
        np.testing.assert_array_equal(i3.reshape(-1), slots[:8])


class TestCompaction:
    def test_compact_repacks_live_rows(self, rng):
        from wdbx_tpu_torch.index import FlatIndex

        idx = FlatIndex(dim=16)
        vecs = _normed(rng, 40, 16)
        slots = idx.add_batch(vecs)
        idx.remove_slots(slots[10:30])
        old, new = idx.compact()
        assert len(old) == 20 and (new == np.arange(20)).all()
        assert idx.count() == 20
        assert idx.get_stats()["tombstones"] == 0
        # survivors still findable at their new slots
        remap = dict(zip(old.tolist(), new.tolist()))
        _, got = idx.search(vecs[0], k=1)
        assert got[0, 0] == remap[slots[0]]

    def test_store_optimize_compacts_and_remaps(self, temp_dir, rng):
        from wdbx_tpu_torch.core.config import WDBXConfig
        from wdbx_tpu_torch.store.vector_store import VectorStore

        cfg = WDBXConfig(
            {"VECTOR_DIMENSION": 8, "NUM_SHARDS": 1, "DATA_DIR": temp_dir}
        )
        store = VectorStore(cfg)
        vecs = {f"v{i}": rng.standard_normal(8).astype(np.float32) for i in range(200)}
        store.batch_store(vecs)
        for i in range(150):
            store.delete(f"v{i}")
        assert store.optimize()
        assert store.indices[0].get_stats()["tombstones"] == 0
        # remaining ids still resolve correctly after remap
        hits = store.search(vecs["v180"], limit=1)
        assert hits[0][0] == "v180"
        assert store.get("v199") is not None

    def test_ivf_compact_rebuilds_overlay(self, rng):
        from wdbx_tpu_torch.index import IVFIndex

        ivf = IVFIndex(dim=16, nlist=4, train_threshold=32)
        vecs = _normed(rng, 64, 16)
        slots = ivf.add_batch(vecs)
        ivf.build()
        ivf.remove_slots(slots[:32])
        old, new = ivf.compact()
        assert ivf.count() == 32
        assert ivf.is_trained  # rebuilt (32 >= train_threshold)
        remap = dict(zip(old.tolist(), new.tolist()))
        _, got = ivf.search(vecs[40], k=1)
        assert got[0, 0] == remap[slots[40]]


class TestOrbaxPersistence:
    def test_flat_orbax_roundtrip(self, rng, temp_dir):
        from wdbx_tpu_torch.index import FlatIndex

        idx = FlatIndex(dim=16)
        idx.persist_backend = "orbax"
        vecs = _normed(rng, 30, 16)
        slots = idx.add_batch(vecs)
        idx.remove_slots(slots[:2])
        idx.save(f"{temp_dir}/ob")
        idx2 = FlatIndex(dim=16)
        assert idx2.load(f"{temp_dir}/ob")
        assert idx2.persist_backend == "orbax"
        assert idx2.count() == 28
        _, got = idx2.search(vecs[5], k=1)
        assert got[0, 0] == slots[5]
        _, got = idx2.search(vecs[0], k=28)
        assert slots[0] not in got[0]

    def test_sharded_orbax_roundtrip(self, rng, temp_dir):
        from wdbx_tpu_torch.parallel import ShardedFlatIndex

        idx = ShardedFlatIndex(dim=16)
        idx.persist_backend = "orbax"
        vecs = _normed(rng, 40, 16)
        slots = idx.add_batch(vecs)
        idx.save(f"{temp_dir}/obs")
        idx2 = ShardedFlatIndex(dim=16)
        assert idx2.load(f"{temp_dir}/obs")
        _, got = idx2.search(vecs[:4], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[:4])

    def test_int8_orbax(self, rng, temp_dir):
        from wdbx_tpu_torch.index import FlatIndex

        idx = FlatIndex(dim=16, dtype="int8")
        idx.persist_backend = "orbax"
        vecs = _normed(rng, 20, 16)
        slots = idx.add_batch(vecs)
        idx.save(f"{temp_dir}/obi")
        idx2 = FlatIndex(dim=16, dtype="int8")
        assert idx2.load(f"{temp_dir}/obi")
        _, got = idx2.search(vecs[:4], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[:4])


class TestIVFUpdate:
    def test_update_after_build_visible_with_new_value(self, rng):
        from wdbx_tpu_torch.index import IVFIndex

        ivf = IVFIndex(dim=16, nlist=4, train_threshold=32)
        vecs = _normed(rng, 64, 16)
        slots = ivf.add_batch(vecs)
        ivf.build()
        new_vec = _normed(rng, 1, 16)
        ivf.update_slots(slots[:1], new_vec)
        scores, got = ivf.search(new_vec, k=1)
        assert got[0, 0] == slots[0]
        np.testing.assert_allclose(scores[0, 0], 1.0, rtol=1e-3)
        # the stale bucket copy must not surface the old vector's score
        _, got_old = ivf.search(vecs[0], k=64)
        row = [int(s) for s in got_old[0]]
        assert row.count(slots[0]) <= 1


class TestIVFScanPath:
    """Exercise the lax.scan bucket path explicitly (small corpora would
    otherwise hit the batch flat fallback)."""

    def _make(self, rng, n=2000, d=32, nlist=64, nprobe=8):
        ivf = IVFIndex(dim=d, nlist=nlist, nprobe=nprobe,
                       train_threshold=10**9, capacity=n)
        ivf.batch_flat_fallback = False
        vecs = _normed(rng, n, d)
        slots = ivf.add_batch(vecs)
        ivf.build()
        return ivf, vecs, slots

    def test_scan_self_query(self, rng):
        ivf, vecs, slots = self._make(rng)
        scores, got = ivf.search(vecs[:4], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[:4])
        # bucket tables are bf16 (candidate ranking only), so scores
        # carry bf16 rounding; ranking correctness asserted above
        np.testing.assert_allclose(scores[:, 0], 1.0, rtol=4e-3)

    def test_scan_full_probe_is_exact(self, rng):
        ivf, vecs, slots = self._make(rng, nprobe=64)  # probe everything
        q = _normed(rng, 4, 32)
        _, got = ivf.search(q, k=10)
        exact = np.argsort(-(q @ vecs.T), axis=-1)[:, :10]
        for a, b in zip(got, slots[exact]):
            assert set(a.tolist()) == set(b.tolist())

    def test_scan_respects_deletes(self, rng):
        ivf, vecs, slots = self._make(rng)
        ivf.remove_slots(slots[:1])
        _, got = ivf.search(vecs[0], k=10)
        assert slots[0] not in got[0]

    def test_scan_sees_residual_adds(self, rng):
        ivf, vecs, slots = self._make(rng)
        late = _normed(rng, 3, 32)
        late_slots = ivf.add_batch(late)
        scores, got = ivf.search(late, k=1)
        np.testing.assert_array_equal(got[:, 0], late_slots)

    def test_scan_update_serves_new_value(self, rng):
        ivf, vecs, slots = self._make(rng)
        new_vec = _normed(rng, 1, 32)
        ivf.update_slots(slots[:1], new_vec)
        scores, got = ivf.search(new_vec, k=1)
        assert got[0, 0] == slots[0]
        np.testing.assert_allclose(scores[0, 0], 1.0, rtol=1e-3)


class TestIVFPallasKernel:
    def test_pallas_matches_lax(self, rng):
        ivf = IVFIndex(dim=64, nlist=16, nprobe=4, train_threshold=10**9,
                       capacity=4096)
        ivf.batch_flat_fallback = False
        vecs = _normed(rng, 4000, 64)
        slots = ivf.add_batch(vecs)
        ivf.build()
        q = _normed(rng, 4, 64)
        _, got_lax = ivf.search(q, k=10)
        ivf.ivf_kernel = "pallas"
        _, got_pl = ivf.search(q, k=10)
        for a, b in zip(got_lax, got_pl):
            assert set(a.tolist()) == set(b.tolist())

    def test_pallas_with_residual_and_deletes(self, rng):
        ivf = IVFIndex(dim=32, nlist=8, nprobe=8, train_threshold=10**9,
                       capacity=1024)
        ivf.batch_flat_fallback = False
        ivf.ivf_kernel = "pallas"
        vecs = _normed(rng, 800, 32)
        slots = ivf.add_batch(vecs)
        ivf.build()
        ivf.remove_slots(slots[:1])
        late = _normed(rng, 3, 32)
        late_slots = ivf.add_batch(late)
        _, got = ivf.search(vecs[0], k=10)
        assert slots[0] not in got[0]
        scores, got = ivf.search(late, k=1)
        np.testing.assert_array_equal(got[:, 0], late_slots)


class TestMultiAssignment:
    def test_soar_improves_recall_at_fixed_nprobe(self, rng):
        n, d, k = 20_000, 64, 10
        db = _normed(rng, n, d)  # uniform random: hardest case
        queries = _normed(rng, 32, d)
        exact = np.argsort(-(queries @ db.T), axis=-1)[:, :k]

        recalls = {}
        for a in (1, 2):
            ivf = IVFIndex(dim=d, nlist=64, nprobe=8, train_threshold=10**9,
                           capacity=n, assignments=a)
            ivf.batch_flat_fallback = False
            slots = ivf.add_batch(db)
            ivf.build()
            _, got = ivf.search(queries, k=k)
            es = slots[exact]
            recalls[a] = np.mean(
                [len(set(x.tolist()) & set(y.tolist())) / k
                 for x, y in zip(got, es)]
            )
        assert recalls[2] > recalls[1]

    def test_no_duplicates_with_multi_assignment(self, rng):
        ivf = IVFIndex(dim=16, nlist=4, nprobe=4, train_threshold=10**9,
                       assignments=2)
        ivf.batch_flat_fallback = False
        vecs = _normed(rng, 300, 16)
        slots = ivf.add_batch(vecs)
        ivf.build()
        _, got = ivf.search(vecs[:8], k=10)
        for row in got:
            live = [s for s in row if s >= 0]
            assert len(live) == len(set(live))
        assert (got[:, 0] == slots[:8]).all()

    def test_multi_assign_delete_removes_all_copies(self, rng):
        ivf = IVFIndex(dim=16, nlist=4, nprobe=4, train_threshold=10**9,
                       assignments=2)
        ivf.batch_flat_fallback = False
        vecs = _normed(rng, 200, 16)
        slots = ivf.add_batch(vecs)
        ivf.build()
        ivf.remove_slots(slots[:1])
        _, got = ivf.search(vecs[0], k=20)
        assert slots[0] not in got[0]


class TestIVFInt8:
    def test_ivf_int8_end_to_end(self, rng):
        ivf = IVFIndex(dim=32, dtype="int8", nlist=8, nprobe=8,
                       train_threshold=10**9)
        ivf.batch_flat_fallback = False
        vecs = _normed(rng, 600, 32)
        slots = ivf.add_batch(vecs)
        ivf.build()
        scores, got = ivf.search(vecs[:8], k=1)
        np.testing.assert_array_equal(got[:, 0], slots[:8])
        np.testing.assert_allclose(scores[:, 0], 1.0, atol=0.03)
        # residual adds on an int8 slab get scale-corrected scores
        late = _normed(rng, 2, 32)
        late_slots = ivf.add_batch(late)
        scores, got = ivf.search(late, k=1)
        np.testing.assert_array_equal(got[:, 0], late_slots)
        np.testing.assert_allclose(scores[:, 0], 1.0, atol=0.03)


def test_ivf_search_pipelined_matches_search(rng):
    ivf = IVFIndex(dim=16, nlist=8, train_threshold=64)
    ivf.batch_flat_fallback = False
    vecs = _normed(rng, 400, 16)
    slots = ivf.add_batch(vecs)
    ivf.build()
    ivf.nprobe = 8
    qs = vecs[:24].reshape(3, 8, 16)
    s3, i3 = ivf.search_pipelined(qs, k=4)
    assert s3.shape == (3, 8, 4)
    for nbatch in range(3):
        _, i1 = ivf.search(qs[nbatch], k=4)
        np.testing.assert_array_equal(i3[nbatch], i1[:, :4])
    # untrained fallback
    fresh = IVFIndex(dim=16, train_threshold=10**9)
    fresh.add_batch(vecs[:64])
    s, i = fresh.search_pipelined(qs, k=2)
    assert s.shape == (3, 8, 2)


def test_ivf_inflight_pipelined_matches_blocking(rng):
    """materialize=False handles (flat + IVF, trained + untrained)
    resolve to the blocking path's exact output."""
    from wdbx_tpu_torch.index.flat import FlatIndex

    vecs = _normed(rng, 400, 16)
    qs = vecs[:24].reshape(3, 8, 16)

    flat = FlatIndex(dim=16)
    flat.add_batch(vecs)
    want = flat.search_pipelined(qs, k=4)
    got = FlatIndex.resolve_pipelined(
        flat.search_pipelined(qs, k=4, materialize=False)
    )
    np.testing.assert_array_equal(got[1], want[1])

    ivf = IVFIndex(dim=16, nlist=8, train_threshold=64)
    ivf.batch_flat_fallback = False
    ivf.add_batch(vecs)
    ivf.build()
    ivf.nprobe = 8
    want = ivf.search_pipelined(qs, k=4)
    handles = [
        ivf.search_pipelined(qs, k=4, materialize=False)
        for _ in range(2)
    ]
    for h in handles:
        ss, ii = ivf.resolve_pipelined(h)
        np.testing.assert_array_equal(ii, want[1])
        np.testing.assert_array_equal(ss, want[0])
    # untrained fallback handle routes through the flat resolve
    fresh = IVFIndex(dim=16, train_threshold=10**9)
    fresh.add_batch(vecs[:64])
    want = fresh.search_pipelined(qs, k=2)
    got = fresh.resolve_pipelined(
        fresh.search_pipelined(qs, k=2, materialize=False)
    )
    np.testing.assert_array_equal(got[1], want[1])


def test_half_precision_query_stacks(rng):
    """float16 / bfloat16 numpy query stacks are accepted end-to-end
    (half the H2D bytes — the serving wall on network-attached
    devices) and rank like the f32 stack: the per-query normalize /
    quantize scale is a positive scalar, so only bf16 rounding of the
    query itself can perturb near-ties."""
    import ml_dtypes

    from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex
    from wdbx_tpu_torch.index.flat import FlatIndex

    vecs = _normed(rng, 600, 32)
    qs32 = vecs[:24].reshape(3, 8, 32).copy()

    flat = FlatIndex(dim=32)
    flat.add_batch(vecs)
    clu = ClusteredIVFIndex(32, nlist=8, nprobe=8, train_threshold=256)
    clu.batch_flat_fallback = False
    clu.add_batch(vecs)
    clu.build()

    for idx in (flat, clu):
        _, want = idx.search_pipelined(qs32, 5)
        for half in (np.float16, ml_dtypes.bfloat16):
            _, got = idx.search_pipelined(qs32.astype(half), 5)
            overlap = np.mean([
                len(set(a.tolist()) & set(b.tolist())) / 5
                for a, b in zip(
                    got.reshape(-1, 5), want.reshape(-1, 5)
                )
            ])
            assert overlap >= 0.9, (idx.__class__.__name__, half, overlap)
            # self-queries must still hit themselves at rank 1
            assert (got[:, :, 0].reshape(-1) == want[:, :, 0].reshape(-1)).mean() >= 0.9


def test_ivf_int8_tables_stay_int8(rng, temp_dir):
    """int8 slabs must keep int8 bucket tables + scale table (bf16 tables
    would double HBM at 10M x 768 and OOM beside the slab)."""
    import torch

    ivf = IVFIndex(dim=16, dtype="int8", nlist=4, train_threshold=32)
    ivf.batch_flat_fallback = False
    vecs = _normed(rng, 128, 16)
    slots = ivf.add_batch(vecs)
    ivf.build()
    assert ivf._bucket_rows.dtype == torch.int8
    assert ivf._bucket_scale is not None
    ivf.nprobe = 4
    _, got = ivf.search(vecs[:8], k=1)
    np.testing.assert_array_equal(got[:, 0], slots[:8])
    # persistence round trip keeps the scale table
    ivf.save(f"{temp_dir}/i8ivf")
    ivf2 = IVFIndex(dim=16, dtype="int8")
    assert ivf2.load(f"{temp_dir}/i8ivf")
    assert ivf2._bucket_rows.dtype == torch.int8
    assert ivf2._bucket_scale is not None
    ivf2.batch_flat_fallback = False
    ivf2.nprobe = 4
    _, got2 = ivf2.search(vecs[:8], k=1)
    np.testing.assert_array_equal(got2[:, 0], slots[:8])


def test_spill_does_not_trigger_rebuild_loop(rng):
    """Capacity-capped placement seeds the residual buffer; only residual
    GROWTH beyond that baseline should trigger a rebuild. (k-means
    subdivides dense regions, so organic spill is rare — the trigger
    semantics are exercised directly.)"""
    vecs = _normed(rng, 300, 16)
    ivf = IVFIndex(dim=16, nlist=8, train_threshold=64,
                   rebuild_fraction=0.2)
    ivf.batch_flat_fallback = False
    slots = ivf.add_batch(vecs)
    ivf.build()
    # placement respects the cap everywhere
    bv = np.asarray(ivf._bucket_valid)
    assert bv.shape[1] >= 128 and bv.sum(1).max() <= bv.shape[1]
    # simulate a spill-seeded residual: baseline alone must not retrigger
    ivf._residual = [int(s) for s in slots[:100]]
    ivf._residual_base = 100
    assert not ivf._needs_build()
    # growth beyond the baseline + fraction does
    ivf._residual.extend(int(s) for s in slots[100:200])
    assert ivf._needs_build()
    # and the spill-resident rows are still findable (residual scan)
    ivf._residual = [int(s) for s in slots[:100]]
    ivf._residual_base = 100
    _, got = ivf.search(vecs[:4], k=1)
    np.testing.assert_array_equal(got[:, 0], slots[:4])


def test_ivf_pipelined_dedups_multi_assignment(rng):
    """SOAR multi-assignment must not surface the same slot twice in a
    pipelined result row (review finding r2)."""
    ivf = IVFIndex(dim=16, nlist=8, train_threshold=64, assignments=2)
    ivf.batch_flat_fallback = False
    vecs = _normed(rng, 400, 16)
    ivf.add_batch(vecs)
    ivf.build()
    ivf.nprobe = 8
    qs = vecs[:16].reshape(2, 8, 16)
    _, got = ivf.search_pipelined(qs, k=4)
    for nb in range(2):
        for row in got[nb]:
            live = [int(s) for s in row if s >= 0]
            assert len(live) == len(set(live)), row
