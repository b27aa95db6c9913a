"""The cases of ``tests/test_clustered.py`` on the port, on the CPU.

A translated copy of that file: the same classes, functions,
parametrisations and asserts, run on ``wdbx_tpu_torch``. Each
``wdbx_tpu`` import names its ``wdbx_tpu_torch`` counterpart; the
autouse fixture asks for the CPU through
``test_torch_ops.port_on_cpu`` (the default device and mesh of one
test), so the package keeps the card as its own default.

Translated, every case (95 cases):
TestClusteredIVF: test_full_probe_matches_exact,
test_recall_clustered_data, test_no_side_tables,
test_slots_stable_across_rebuild, test_delete_after_build_invisible,
test_fresh_adds_visible_and_unique, test_update_moves_vector,
test_compact_identity_remap, test_build_from_streaming,
test_build_from_requires_empty, test_slot_mask_prefilter,
test_int8_recall, test_pipelined_matches_search,
test_ranges_gate_budgets_bytes, test_v2_qprec_int8_mode,
test_inflight_pipelined_matches_blocking, test_persistence_roundtrip,
test_untrained_falls_back_to_flat, test_auto_train_on_search, test_tune,
test_clear, test_factory, test_kernel_path_matches_lax,
test_kernel_path_mutations_no_duplicates,
test_kernel_pipelined_matches_search, test_kernel_int8,
test_residual_region_positions_recycle_immediately,
test_delete_churn_triggers_rebuild,
test_quarantine_recycles_after_rebuild, test_non_pow2_nprobe_lax_path,
test_build_from_after_mutation_cycle,
test_differential_random_ops_sharded,
test_differential_background_rebuild_sharded,
test_differential_sharded_masked_remesh,
test_differential_sharded_flat_masked,
test_differential_sharded_ivf_masked, test_differential_random_ops,
test_deep_overfetch_routes_off_kernel,
test_ranges_path_matches_block_paths,
test_differential_background_rebuild_concurrent,
test_differential_random_ops_dense_ivf, test_ip_metric;
TestAdvisoryRegressions: test_dedup_blocks_skewed_probe_no_overflow,
test_load_adopts_flat_checkpoint_with_identity_slots,
test_load_missing_sidecar_refuses, test_duplicate_slots_one_batch;
TestHoleRecycling: test_insert_fills_bucket_matched_holes,
test_update_rewrites_in_place,
test_recycle_holes_off_preserves_quarantine,
test_recycling_defers_rebuild_trigger,
test_quarantine_persists_with_buckets, test_factory_config_knob,
test_quar_counter_tracks_dict; TestBackgroundRebuild:
test_equivalent_to_blocking_build, test_mutations_during_rebuild_replay,
test_search_does_not_block_during_rebuild; TestInt4:
test_flat_int4_crud_and_persistence,
test_clustered_int4_recall_lax_and_kernel,
test_flat_int4_fused_kernel_matches_exact, test_int4_dim_must_be_even,
test_dense_ivf_rejects_int4, test_store_rerank_recovers_int4_recall;
TestReviewRound3Regressions: test_int4_build_permutes_scales,
test_background_rebuild_no_removed_slot_resurrection,
test_load_during_background_rebuild_wins,
test_v2_kernel_pads_small_batches,
test_filter_selectivity_counts_live_rows_only;
TestBackgroundRebuildWindow: test_scripted_mutations_inside_open_window,
test_capacity_growth_inside_window_falls_back,
test_remesh_inside_open_window_still_rebuilds,
test_clear_inside_open_window_allows_blocking_build; TestFilteredTuning:
test_tune_filtered_meets_bar_clustered, test_tune_filtered_dense_ivf,
test_tune_filtered_deescalates_overprobing_default,
test_tune_filtered_sparse_mask_routes_exact,
test_calibrated_boost_overrides_default; TestStaleLabelAliasing:
test_update_clears_moved_from_label,
test_update_save_load_churn_no_ghost,
test_load_drops_stale_labels_from_old_checkpoints.

Changed beyond the imports and the fixture, three cases, each with the
torch counterpart of the reference's JAX value:
``TestInt4::test_flat_int4_crud_and_persistence`` holds the packed slab
to ``torch.uint8``;
``TestAdvisoryRegressions::test_dedup_blocks_skewed_probe_no_overflow``
passes CPU tensors (int32, as the reference's) to the port's
``_dedup_blocks``;
``TestReviewRound3Regressions::test_v2_kernel_pads_small_batches``
passes CPU tensors to
``clustered_block_topk_v2``, which runs K3's plain version there and
ignores ``interpret`` as the port does. One case spies on the port's
exact route by another name:
``TestReviewRound3Regressions::test_filter_selectivity_counts_live_rows_only``
wraps ``FlatIndex._enqueue`` (the flat route every engine's plan
reaches) where the reference wraps ``FlatIndex.search``. Left out:
nothing.

The reference file's description:

ClusteredIVFIndex: cluster-ordered slab IVF (zero-copy bucket layout).

Covers the properties the layout must guarantee beyond plain IVF
semantics: external slot stability across rebuilds (the store's registry
must never need a remap), no duplicate candidates from recycled/updated
rows, identity compaction, the two-pass streaming build, and memory
accounting (no side tables).
"""

import os

import numpy as np
import pytest
import torch

from wdbx_tpu_torch.index import create_index
from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex
from wdbx_tpu_torch.index.flat import FlatIndex
from test_torch_ops import port_on_cpu


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    port_on_cpu(monkeypatch)


def _normed(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _make(dim=32, **kw):
    kw.setdefault("nlist", 16)
    kw.setdefault("nprobe", 16)
    kw.setdefault("train_threshold", 256)
    idx = ClusteredIVFIndex(dim, **kw)
    idx.batch_flat_fallback = False  # exercise the real block scan
    return idx


class TestClusteredIVF:
    def test_full_probe_matches_exact(self, rng):
        n, d, k = 3000, 32, 10
        db = _normed(rng, n, d)
        q = _normed(rng, 8, d)
        idx = _make(d)
        slots = idx.add_batch(db)
        idx.build()
        _, got = idx.search(q, k)
        flat = FlatIndex(d)
        fslots = flat.add_batch(db)
        _, exp = flat.search(q, k)
        recall = np.mean(
            [len(set(a.tolist()) & set(b.tolist())) / k
             for a, b in zip(got, exp)]
        )
        assert recall >= 0.99, recall
        assert (slots == fslots).all()  # identity slots on bulk add

    def test_recall_clustered_data(self, rng):
        n, d, k = 20_000, 64, 10
        centers = _normed(rng, 128, d)
        noise = 0.4 / np.sqrt(d)
        db = centers[rng.integers(0, 128, n)] + noise * rng.standard_normal(
            (n, d)
        ).astype(np.float32)
        db /= np.linalg.norm(db, axis=-1, keepdims=True)
        q = db[rng.integers(0, n, 32)] + noise * rng.standard_normal(
            (32, d)
        ).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        idx = _make(d, nlist=64, nprobe=8, capacity=n)
        slots = idx.add_batch(db)
        idx.build()
        _, got = idx.search(q, k)
        exact_slots = slots[np.argsort(-(q @ db.T), axis=-1)[:, :k]]
        recall = np.mean(
            [len(set(a.tolist()) & set(b.tolist())) / k
             for a, b in zip(got, exact_slots)]
        )
        assert recall >= 0.9, recall

    def test_no_side_tables(self, rng):
        """The point of the layout: HBM = slab only (vs IVFIndex's
        bucket_rows table duplicating the corpus)."""
        idx = _make(32)
        idx.add_batch(_normed(rng, 2000, 32))
        idx.build()
        assert not hasattr(idx, "_bucket_rows") or idx.__dict__.get(
            "_bucket_rows") is None
        stats = idx.get_stats()
        assert stats["hbm_bytes"] == idx.capacity * 32 * 4

    def test_slots_stable_across_rebuild(self, rng):
        d = 32
        idx = _make(d)
        db = _normed(rng, 1500, d)
        slots = idx.add_batch(db)
        idx.build()
        fresh = _normed(rng, 40, d)
        fslots = idx.add_batch(fresh)
        _, pre = idx.search(fresh, 3)
        idx.build()  # rebuild permutes the slab
        _, post = idx.search(fresh, 3)
        assert (pre == post).all()
        # originals still resolve to their original slot ids
        _, got = idx.search(db[:5], 1)
        assert (got.ravel() == slots[:5]).all()
        assert (fslots >= 0).all()

    def test_delete_after_build_invisible(self, rng):
        d = 32
        idx = _make(d)
        db = _normed(rng, 1200, d)
        slots = idx.add_batch(db)
        idx.build()
        idx.remove_slots(slots[:100])
        _, got = idx.search(db[:100], 1)
        dead = set(slots[:100].tolist())
        assert not any(int(g) in dead for g in got.ravel() if g >= 0)
        assert idx.count() == 1100

    def test_fresh_adds_visible_and_unique(self, rng):
        d = 32
        idx = _make(d)
        slots = idx.add_batch(_normed(rng, 1000, d))
        idx.build()
        idx.remove_slots(slots[:20])  # force slot+position recycling
        fresh = _normed(rng, 20, d)
        fslots = idx.add_batch(fresh)
        _, got = idx.search(fresh, 1)
        assert (got.ravel() == fslots).all()
        # recycled positions must not double-surface via their old bucket
        _, got10 = idx.search(fresh, 10)
        for row in got10:
            live = [int(g) for g in row if g >= 0]
            assert len(live) == len(set(live)), row

    def test_update_moves_vector(self, rng):
        d = 32
        idx = _make(d)
        db = _normed(rng, 1000, d)
        slots = idx.add_batch(db)
        idx.build()
        target = _normed(rng, 1, d)
        idx.update_slots(slots[7:8], target)
        _, got = idx.search(target, 1)
        assert int(got.ravel()[0]) == int(slots[7])
        live = [int(g) for g in idx.search(target, 10)[1].ravel() if g >= 0]
        assert len(live) == len(set(live))

    def test_compact_identity_remap(self, rng):
        d = 32
        idx = _make(d)
        slots = idx.add_batch(_normed(rng, 1000, d))
        idx.build()
        idx.remove_slots(slots[::3])
        old, new = idx.compact()
        assert (old == new).all()
        keep = np.setdiff1d(slots, slots[::3])
        assert set(old.tolist()) == set(keep.tolist())
        # searches still resolve post-compaction
        db_keep = db_row = None
        _, got = idx.search(_normed(rng, 4, d), 5)
        assert all(int(g) in set(keep.tolist()) for g in got.ravel() if g >= 0)

    def test_build_from_streaming(self, rng):
        d, n_chunks, rows = 32, 6, 400

        def chunks():
            r = np.random.default_rng(11)
            for _ in range(n_chunks):
                yield r.standard_normal((rows, d)).astype(np.float32)

        idx = _make(d)
        slots = idx.build_from(chunks, train_chunks=2)
        n = n_chunks * rows
        assert len(slots) == n and idx.count() == n and idx.is_trained
        all_rows = np.concatenate(list(chunks()))
        all_rows /= np.linalg.norm(all_rows, axis=-1, keepdims=True)
        q = _normed(rng, 4, d)
        _, got = idx.search(q, 10)
        inv = np.empty(n, np.int64)
        inv[slots] = np.arange(n)
        got_src = np.where(got >= 0, inv[np.clip(got, 0, n - 1)], -1)
        exp = np.argsort(-(q @ all_rows.T), axis=-1)[:, :10]
        recall = np.mean(
            [len(set(a.tolist()) & set(b.tolist())) / 10
             for a, b in zip(got_src, exp)]
        )
        assert recall >= 0.99, recall

    def test_build_from_requires_empty(self, rng):
        idx = _make(32)
        idx.add_batch(_normed(rng, 10, 32))
        with pytest.raises(ValueError):
            idx.build_from(lambda: iter([_normed(rng, 10, 32)]))

    def test_slot_mask_prefilter(self, rng):
        d = 32
        idx = _make(d)
        slots = idx.add_batch(_normed(rng, 1500, d))
        idx.build()
        mask = np.zeros(1500, bool)
        mask[::2] = True
        _, got = idx.search(_normed(rng, 4, d), 10, slot_mask=mask)
        assert all(int(g) % 2 == 0 for g in got.ravel() if g >= 0)

    def test_int8_recall(self, rng):
        d = 64
        db = _normed(rng, 4000, d)
        q = _normed(rng, 8, d)
        idx = _make(d, dtype="int8")
        idx.add_batch(db)
        idx.build()
        _, got = idx.search(q, 10)
        exp = np.argsort(-(q @ db.T), axis=-1)[:, :10]
        recall = np.mean(
            [len(set(int(x) for x in a) & set(b.tolist())) / 10
             for a, b in zip(got, exp)]
        )
        assert recall >= 0.9, recall

    def test_pipelined_matches_search(self, rng):
        d = 32
        idx = _make(d)
        idx.add_batch(_normed(rng, 2000, d))
        idx.build()
        qs = rng.standard_normal((3, 4, d)).astype(np.float32)
        sp, gp = idx.search_pipelined(qs, 5)
        assert sp.shape == (3, 4, 5)
        for i in range(3):
            _, gi = idx.search(qs[i], 5)
            assert (gp[i] == gi).all()

    def test_ranges_gate_budgets_bytes(self, rng):
        """The auto small-batch routing picks the exact-range program
        only while its read footprint (L × nprobe × row bytes) stays
        under 8 MB — past that, max-bucket-sized slices read more than
        narrow covering blocks (measured 3× slower at 10M×768)."""
        d = 32
        idx = _make(d, dtype="int8")
        idx.add_batch(_normed(rng, 2000, d))
        idx.build()
        assert idx._use_ranges(1, idx.nprobe)  # tiny footprint: on
        idx._range_L = (1 << 23) // d // min(
            idx.nprobe, len(idx._row_cnt)
        ) + 1024  # inflate past the byte budget
        assert not idx._use_ranges(1, idx.nprobe)
        idx.latency_path = "ranges"  # explicit force still wins
        assert idx._use_ranges(1, idx.nprobe)

    def test_v2_qprec_int8_mode(self, rng):
        """kernel_qprec='int8' (int8×int8 MXU with per-query
        quantization) stays rank-consistent with the default bf16
        query mode on an int8 slab — quantization noise may flip
        near-ties but self-queries and high recall must hold."""
        d = 64
        db = _normed(rng, 3000, d)
        q = _normed(rng, 8, d)
        idx = _make(d, dtype="int8")
        idx.kernel_version = "v2"
        idx.add_batch(db)
        idx.build()
        _, want = idx.search(q, 10)  # qprec default: bf16
        idx.kernel_qprec = "int8"
        _, got = idx.search(q, 10)
        overlap = np.mean([
            len(set(a.tolist()) & set(b.tolist())) / 10
            for a, b in zip(got, want)
        ])
        assert overlap >= 0.9, overlap
        # self-query must return itself at rank 1 (strongest invariant),
        # and the pipelined program must agree with the per-batch one
        _, got_self = idx.search(db[:8], 1)
        _, g2 = idx.search_pipelined(db[:8].reshape(2, 4, d), 1)
        assert (g2.reshape(-1) == got_self.ravel()).all()

    def test_inflight_pipelined_matches_blocking(self, rng):
        """materialize=False handles resolve to exactly the blocking
        path's output (the double-buffered serving contract), both
        trained and on the untrained flat fallback."""
        d = 32
        idx = _make(d)
        idx.add_batch(_normed(rng, 2000, d))
        idx.build()
        qs = rng.standard_normal((3, 4, d)).astype(np.float32)
        want = idx.search_pipelined(qs, 5)
        handles = [
            idx.search_pipelined(qs, 5, materialize=False)
            for _ in range(2)
        ]
        for h in handles:
            ss, gg = idx.resolve_pipelined(h)
            assert (ss == want[0]).all() and (gg == want[1]).all()
        # untrained fallback returns flat positions needing slot mapping
        cold = _make(d, train_threshold=10_000)
        cold.add_batch(_normed(rng, 64, d))
        want_c = cold.search_pipelined(qs, 3)
        got_c = cold.resolve_pipelined(
            cold.search_pipelined(qs, 3, materialize=False)
        )
        assert (got_c[1] == want_c[1]).all()

    def test_persistence_roundtrip(self, rng, temp_dir):
        d = 32
        idx = _make(d)
        db = _normed(rng, 1200, d)
        slots = idx.add_batch(db)
        idx.build()
        idx.remove_slots(slots[:10])
        fresh = _normed(rng, 5, d)
        fslots = idx.add_batch(fresh)
        path = os.path.join(temp_dir, "cidx")
        idx.save(path)
        idx2 = _make(d)
        assert idx2.load(path)
        assert idx2.count() == idx.count()
        _, got = idx.search(fresh, 3)
        _, got2 = idx2.search(fresh, 3)
        assert (got == got2).all()
        # mutation still works post-load (slot bookkeeping restored)
        more = idx2.add_batch(_normed(rng, 3, d))
        assert len(set(more.tolist()) & set(fslots.tolist())) == 0

    def test_untrained_falls_back_to_flat(self, rng):
        idx = _make(16, train_threshold=10_000)
        db = _normed(rng, 50, 16)
        slots = idx.add_batch(db)
        _, got = idx.search(db[:3], 1)
        assert (got.ravel() == slots[:3]).all()

    def test_auto_train_on_search(self, rng):
        idx = _make(16, train_threshold=128)
        idx.add_batch(_normed(rng, 300, 16))
        assert not idx.is_trained
        idx.search(_normed(rng, 1, 16), 3)
        assert idx.is_trained

    def test_tune(self, rng):
        d = 32
        idx = _make(d, nlist=32, nprobe=1)
        db = _normed(rng, 5000, d)
        idx.add_batch(db)
        idx.build()
        achieved = idx.tune(_normed(rng, 16, d), k=10, target_recall=0.9)
        assert achieved >= 0.9

    def test_clear(self, rng):
        idx = _make(16)
        idx.add_batch(_normed(rng, 500, 16))
        idx.build()
        idx.clear()
        assert idx.count() == 0 and not idx.is_trained
        slots = idx.add_batch(_normed(rng, 5, 16))
        assert (slots == np.arange(5)).all()

    def test_factory(self):
        idx = create_index("ivf_clustered", 8)
        assert isinstance(idx, ClusteredIVFIndex)

    def test_kernel_path_matches_lax(self, rng):
        """Pallas block-scan kernel (interpret mode off-TPU) agrees with
        the lax scan at full probe — both exact against the oracle."""
        d = 32
        db = _normed(rng, 1536, d)
        q = _normed(rng, 4, d)
        idx = _make(d, nlist=8, nprobe=8)
        idx.add_batch(db)
        idx.build()
        idx.ivf_kernel = "lax"
        s_lax, g_lax = idx.search(q, 10)
        idx.ivf_kernel = "pallas"
        s_k, g_k = idx.search(q, 10)
        assert (g_lax == g_k).all(), (g_lax, g_k)
        np.testing.assert_allclose(s_lax, s_k, rtol=1e-5)

    def test_kernel_path_mutations_no_duplicates(self, rng):
        """Kernel semantics (no bucket mask) rely on fresh/updated rows
        never sharing scanned blocks: delete + re-add + update must not
        double-surface any candidate."""
        d = 32
        idx = _make(d, nlist=8, nprobe=8)
        idx.ivf_kernel = "pallas"
        db = _normed(rng, 1200, d)
        slots = idx.add_batch(db)
        idx.build()
        idx.remove_slots(slots[:30])
        # deleted rows invisible (checked before their slot ids recycle)
        _, gd = idx.search(db[:30], 1)
        gone = set(slots[:30].tolist())
        assert not any(int(g) in gone for g in gd.ravel() if g >= 0)
        fresh = _normed(rng, 30, d)
        fslots = idx.add_batch(fresh)
        target = _normed(rng, 1, d)
        idx.update_slots(slots[50:51], target)
        _, got = idx.search(target, 10)
        live = [int(g) for g in got.ravel() if g >= 0]
        assert len(live) == len(set(live)), got
        assert int(got.ravel()[0]) == int(slots[50])
        _, gf = idx.search(fresh, 1)
        assert (gf.ravel() == fslots).all()
        # the fresh rows surface exactly once each (no block/residual
        # double-count for recycled ids either)
        _, gfa = idx.search(fresh, 10)
        for row in gfa:
            ids = [int(g) for g in row if g >= 0]
            assert len(ids) == len(set(ids)), row

    def test_kernel_pipelined_matches_search(self, rng):
        d = 32
        idx = _make(d, nlist=8, nprobe=8)
        idx.ivf_kernel = "pallas"
        idx.add_batch(_normed(rng, 1024, d))
        idx.build()
        qs = rng.standard_normal((2, 4, d)).astype(np.float32)
        sp, gp = idx.search_pipelined(qs, 5)
        for i in range(2):
            _, gi = idx.search(qs[i], 5)
            assert (gp[i] == gi).all()

    def test_kernel_int8(self, rng):
        d = 64
        db = _normed(rng, 2048, d)
        q = _normed(rng, 4, d)
        idx = _make(d, dtype="int8", nlist=8, nprobe=8)
        idx.ivf_kernel = "pallas"
        idx.add_batch(db)
        idx.build()
        _, got = idx.search(q, 10)
        exp = np.argsort(-(q @ db.T), axis=-1)[:, :10]
        recall = np.mean(
            [len(set(int(x) for x in a) & set(b.tolist())) / 10
             for a, b in zip(got, exp)]
        )
        assert recall >= 0.9, recall

    def test_residual_region_positions_recycle_immediately(self, rng):
        """Freed fresh-row positions (never block-scanned) go straight
        back to the free list; only clustered-region frees quarantine."""
        d = 32
        idx = _make(d, nlist=8, nprobe=8)
        idx.add_batch(_normed(rng, 1024, d))
        idx.build()
        fresh = _normed(rng, 16, d)
        fslots = idx.add_batch(fresh)
        t0 = idx.get_stats()["tombstones"]
        idx.remove_slots(fslots[:8])  # residual-region rows
        # tombstones counts free+quarantine; the positions are reusable
        assert len(idx._pos_quarantine) == 0
        more = idx.add_batch(_normed(rng, 8, d))
        _, got = idx.search(_normed(rng, 2, d), 10)
        ids = [int(g) for g in got.ravel() if g >= 0]
        assert len(ids) == len(set(ids))

    def test_delete_churn_triggers_rebuild(self, rng):
        d = 32
        idx = _make(d, nlist=8, nprobe=8, rebuild_fraction=0.1)
        slots = idx.add_batch(_normed(rng, 1000, d))
        idx.build()
        idx.remove_slots(slots[:200])  # 20% > rebuild_fraction
        assert idx._needs_build()
        idx.search(_normed(rng, 1, d), 3)  # triggers the rebuild
        assert len(idx._pos_quarantine) == 0
        assert idx.count() == 800

    def test_quarantine_recycles_after_rebuild(self, rng):
        d = 32
        idx = _make(d, nlist=8, nprobe=8)
        slots = idx.add_batch(_normed(rng, 1024, d))
        idx.build()
        idx.remove_slots(slots[:64])
        assert idx.get_stats()["tombstones"] == 64
        idx.build()
        assert idx.get_stats()["tombstones"] == 0
        assert idx.count() == 960

    def test_non_pow2_nprobe_lax_path(self, rng):
        """nprobe values that make the scan length u a non-power-of-two
        (e.g. tune() landing on 10) must not crash the grouped lax scan
        (u is truncated to a group multiple)."""
        d = 32
        idx = _make(d, nlist=16, nprobe=10)
        db = _normed(rng, 4096, d)
        slots = idx.add_batch(db)
        idx.build()
        _, got = idx.search(db[:1], 5)  # B=1: u = draws*m bound, odd
        assert got[0, 0] == slots[0]
        for nprobe in (3, 5, 7, 11):
            idx.nprobe = nprobe
            _, g = idx.search(db[:2], 3)
            assert (g[:, 0] == slots[:2]).all()

    def test_build_from_after_mutation_cycle(self, rng):
        """A cleared-by-deletion index must not leak recycled external
        slot ids into a later bulk load (they would alias the identity
        slots)."""
        d = 32
        idx = _make(d)
        first = idx.add_batch(_normed(rng, 50, d))
        idx.remove_slots(first)  # empty again, but _free_slots populated
        rows = _normed(rng, 600, d)
        slots = idx.build_from(lambda: iter([rows]), train_chunks=1)
        assert idx.count() == 600
        extra = _normed(rng, 3, d)
        eslots = idx.add_batch(extra)
        # fresh ids must not collide with live bulk-loaded ids
        assert not set(eslots.tolist()) & set(slots.tolist())
        _, got = idx.search(extra, 1)
        assert (got.ravel() == eslots).all()
        _, got2 = idx.search(rows[:3], 1)
        assert (got2.ravel() == slots[:3]).all()

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_differential_random_ops_sharded(self, seed):
        """Same differential fuzz against the mesh-striped class."""
        from wdbx_tpu_torch.parallel import ShardedClusteredIndex

        def make():
            idx = ShardedClusteredIndex(16, nlist=4, nprobe=4,
                                        train_threshold=64)
            idx.batch_flat_fallback = False
            idx.topk_method = "exact"
            return idx

        self._run_differential(seed, make, steps=40)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_differential_background_rebuild_sharded(self, seed):
        """Background-rebuild fuzz against the mesh-striped class: the
        COW window, journal replay and atomic swap run on the sharded
        engine (r3: non-donating sharded writes during the window)."""
        from wdbx_tpu_torch.parallel import ShardedClusteredIndex

        def make():
            idx = ShardedClusteredIndex(16, nlist=4, nprobe=4,
                                        train_threshold=64)
            idx.batch_flat_fallback = False
            idx.topk_method = "exact"
            return idx

        self._run_differential(seed, make, steps=40, background=True)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_differential_sharded_masked_remesh(self, seed):
        """Sharded clustered fuzz with random slot-mask filters at
        every check and live remesh() thrown into the op mix (VERDICT
        r2 ask #6 — the filter pushdown and re-striping paths run
        against the numpy mirror)."""
        from wdbx_tpu_torch.parallel import ShardedClusteredIndex, make_mesh

        def make():
            idx = ShardedClusteredIndex(16, nlist=4, nprobe=4,
                                        train_threshold=64)
            idx.batch_flat_fallback = False
            idx.topk_method = "exact"
            return idx

        sizes = [4, 8]
        r_mesh = np.random.default_rng(1000 + seed)

        def remesh(idx):
            idx.remesh(make_mesh(int(r_mesh.choice(sizes))))

        self._run_differential(seed, make, steps=30, masked=True,
                               extra_ops=(remesh,))

    @pytest.mark.parametrize("seed", [0, 1])
    def test_differential_sharded_flat_masked(self, seed):
        """Fuzz the striped flat storage directly (masked + remesh)."""
        from wdbx_tpu_torch.parallel import ShardedFlatIndex, make_mesh

        def make():
            idx = ShardedFlatIndex(16)
            idx.topk_method = "exact"
            return idx

        def remesh(idx):
            idx.remesh(make_mesh(4))

        self._run_differential(seed, make, steps=30, masked=True,
                               extra_ops=(remesh,))

    @pytest.mark.parametrize("seed", [0, 1])
    def test_differential_sharded_ivf_masked(self, seed):
        """Fuzz the dense-table sharded IVF (masked bucket pushdown +
        residual bookkeeping)."""
        from wdbx_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

        def make():
            # nlist rounds UP to n_devices (8) at build; nprobe=16 caps
            # at the rounded nlist so every check is a full probe (the
            # mirror comparison assumes exactness)
            idx = ShardedIVFIndex(16, nlist=8, nprobe=16,
                                  train_threshold=64)
            idx.batch_flat_fallback = False
            idx.topk_method = "exact"
            return idx

        self._run_differential(seed, make, steps=30, masked=True)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_differential_random_ops(self, seed):
        def make():
            idx = _make(16, nlist=4, nprobe=4, train_threshold=64)
            idx.topk_method = "exact"
            return idx

        self._run_differential(seed, make, steps=60)

    def test_deep_overfetch_routes_off_kernel(self, rng):
        """k' = k * fetch_factor (the store's int4 re-rank over-fetch)
        must not take the Pallas kernel — its k-pass fold scales scoped
        VMEM with k (measured blow-up at k=200 on-chip). The lax path
        serves deep k correctly."""
        d = 32
        idx = _make(d, dtype="int4", nlist=8, nprobe=8)
        idx.ivf_kernel = "pallas"
        assert idx._use_kernel(10)
        assert not idx._use_kernel(200)
        idx.ivf_kernel = "auto"
        db = _normed(rng, 2000, d)
        slots = idx.add_batch(db)
        idx.build()
        _, got = idx.search(_normed(rng, 2, d), 200)
        assert got.shape == (2, 200)
        assert (got[:, 0] >= 0).all()

    @pytest.mark.parametrize("dtype", ["float32", "int8", "int4"])
    def test_ranges_path_matches_block_paths(self, rng, dtype):
        """The exact-bucket-range latency path (r3) must agree with the
        covering-block scan across dtypes, after mutations populate the
        residual + tombstones, and under a slot mask."""
        n, d, k = 4000, 32, 8
        db = _normed(rng, n, d)
        idx = _make(d, dtype=dtype, nlist=8, nprobe=8)
        slots = idx.add_batch(db)
        idx.build()
        # mutations: residual adds, removes, updates
        extra = _normed(rng, 40, d)
        idx.add_batch(extra)
        idx.remove_slots(slots[100:140])
        idx.update_slots(slots[:20], _normed(rng, 20, d))
        q = _normed(rng, 3, d)  # pads to 4 <= small_batch_threshold
        outs = {}
        for path in ("ranges", "narrow", "wide"):
            idx.latency_path = path
            outs[path] = idx.search(q, k)
        for path in ("narrow", "wide"):
            # score parity (slot ties may reorder at equal similarity)
            np.testing.assert_allclose(
                outs["ranges"][0], outs[path][0], rtol=2e-3, atol=2e-3
            )
        # masked: results confined to the mask and scores match wide
        mask = np.zeros(int(idx._next_ext_slot) + 50, bool)
        mask[np.asarray(slots[500:2500], np.int64)] = True
        idx.latency_path = "ranges"
        _, gm = idx.search(q, k, slot_mask=mask)
        assert all(mask[g] for g in gm.ravel() if g >= 0)
        idx.latency_path = "wide"
        sw, _ = idx.search(q, k, slot_mask=mask)
        idx.latency_path = "ranges"
        sr, _ = idx.search(q, k, slot_mask=mask)
        np.testing.assert_allclose(sr, sw, rtol=2e-3, atol=2e-3)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_differential_background_rebuild_concurrent(self, seed):
        """Differential fuzz with build_background() racing the
        mutation stream on a side thread (r3): mutations during the COW
        window journal and replay through the atomic swap; searches must
        stay exact against the mirror the whole time."""
        def make():
            idx = _make(16, nlist=4, nprobe=4, train_threshold=64)
            idx.topk_method = "exact"
            return idx

        self._run_differential(seed, make, steps=40, background=True)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_differential_random_ops_dense_ivf(self, seed):
        """Same fuzz against the dense-table IVFIndex (quarantine +
        bucket-table invalidation bookkeeping)."""
        from wdbx_tpu_torch.index.ivf import IVFIndex

        def make():
            idx = IVFIndex(16, nlist=4, nprobe=4, train_threshold=64)
            idx.batch_flat_fallback = False
            idx.topk_method = "exact"
            return idx

        self._run_differential(seed, make, steps=40)

    def _run_differential(self, seed, make, steps, masked=False,
                          extra_ops=(), background=False):
        """Randomized differential test: a long random sequence of
        add/update/remove/build/save-load against a brute-force numpy
        mirror. Every few ops, full-probe search results must match the
        mirror's exact argmax — catches slot-mapping, quarantine,
        residual and persistence bookkeeping bugs that targeted tests
        miss. ``masked=True`` additionally checks a random slot-mask
        filter each round (results confined to the mask AND exact on
        the masked subset); ``extra_ops`` are callables (e.g. a live
        remesh) fired with ~10% probability per step.
        ``background=True`` fires ``build_background()`` on a SIDE
        THREAD with ~15% probability per step and keeps mutating while
        it runs — the index must stay externally consistent through the
        COW window, journal replay, and atomic swap."""
        import tempfile
        import threading

        r = np.random.default_rng(seed)
        d = 16
        idx = make()
        mirror: dict[int, np.ndarray] = {}  # slot -> vector
        bg_thread = None
        bg_err: list[BaseException] = []
        # op trace for post-mortem: the COW-window race reproduces only
        # under full-suite timing, so a failure must carry enough state
        # to be diagnosed from the CI log alone
        trace: list[str] = []

        def bg_join(timeout=120):
            nonlocal bg_thread
            if bg_thread is not None:
                bg_thread.join(timeout)
                assert not bg_thread.is_alive(), "background build hung"
                bg_thread = None
                if bg_err:
                    raise bg_err.pop()

        def rand_vec(n):
            v = r.standard_normal((n, d)).astype(np.float32)
            return v / np.linalg.norm(v, axis=-1, keepdims=True)

        def check():
            if not mirror:
                return
            slots = np.array(sorted(mirror), dtype=np.int64)
            mat = np.stack([mirror[s] for s in slots])
            q = rand_vec(3)
            _, got = idx.search(q, 1)
            exact = slots[np.argmax(q @ mat.T, axis=1)]
            sims_got = []
            for qi, g in zip(q, got[:, 0]):
                assert g in mirror, f"returned unknown slot {g}"
                sims_got.append(float(qi @ mirror[int(g)]))
            sims_exact = np.max(q @ mat.T, axis=1)
            # top-1 similarity must match the mirror's best (slot ties
            # are fine as long as the similarity is equal). On mismatch,
            # self-diagnose: storage is f32, so any gap is structural —
            # report where the expected slot's row lives (and whether a
            # settled re-query recovers) before failing, so a rare
            # timing-dependent repro is actionable from the CI log.
            if not np.allclose(sims_got, sims_exact, rtol=1e-3, atol=1e-3):
                diag = []
                for i, (qi, g) in enumerate(zip(q, got[:, 0])):
                    se = float(sims_exact[i])
                    sg = float(sims_got[i])
                    if np.isclose(sg, se, rtol=1e-3, atol=1e-3):
                        continue
                    want = int(exact[i])
                    pos = int(idx._pos_of[want]) if hasattr(
                        idx, "_pos_of") else -99
                    d_i = {
                        "query": i, "got": int(g), "want": want,
                        "sim_got": sg, "sim_want": se, "pos": pos,
                    }
                    if pos >= 0:
                        va = np.asarray(idx._valid)
                        if va.ndim == 2:
                            # sharded: striped (device, row) layout,
                            # global pos p lives at [p % nd, p // nd]
                            nd = va.shape[0]
                            d_i["valid"] = bool(va[pos % nd, pos // nd])
                        else:
                            d_i["valid"] = bool(va[pos])
                        d_i["fresh_base"] = getattr(idx, "_fresh_base", None)
                        d_i["in_residual"] = pos in set(
                            getattr(idx, "_residual", ()))
                        # get_vectors takes external SLOT ids
                        stored = idx.get_vectors(np.array([want]))[0]
                        d_i["stored_vs_mirror_maxabs"] = float(
                            np.max(np.abs(stored - mirror[want])))
                    if background:
                        in_window = bool(
                            getattr(idx, "_cow_writes", False))
                        d_i["cow_open_at_fail"] = in_window
                        d_i["journal_at_fail"] = dict(
                            getattr(idx, "_bg_journal", {}) or {})
                        bg_join()
                        _, got2 = idx.search(q[i:i + 1], 1)
                        sg2 = float(qi @ mirror[int(got2[0, 0])]) \
                            if int(got2[0, 0]) in mirror else float("nan")
                        d_i["requery_after_join"] = {
                            "slot": int(got2[0, 0]), "sim": sg2,
                            "recovered": bool(np.isclose(
                                sg2, se, rtol=1e-3, atol=1e-3)),
                        }
                        d_i["pos_after_join"] = int(idx._pos_of[want])
                        live = np.asarray(idx._slot_of) >= 0
                        d_i["slot_of_count"] = int(live.sum())
                        d_i["size"] = int(idx._size)
                        d_i["mirror_size"] = len(mirror)
                    diag.append(d_i)
                raise AssertionError(
                    f"top-1 mismatch; structural diagnosis: {diag}; "
                    f"op trace: {trace}"
                )
            if masked and len(mirror) >= 8:
                keep = r.random(len(slots)) < 0.5
                if not keep.any():
                    return
                allowed = slots[keep]
                mask = np.zeros(int(slots.max()) + 1, bool)
                mask[allowed] = True
                qm = rand_vec(2)
                _, gotm = idx.search(qm, 1, slot_mask=mask)
                amat = mat[keep]
                sims_exact_m = np.max(qm @ amat.T, axis=1)
                allowed_set = set(int(s) for s in allowed)
                for qi, g, se in zip(qm, gotm[:, 0], sims_exact_m):
                    assert int(g) in allowed_set, (
                        f"masked search returned slot {g} outside mask"
                    )
                    np.testing.assert_allclose(
                        float(qi @ mirror[int(g)]), se,
                        rtol=1e-3, atol=1e-3,
                    )

        for step in range(steps):
            if extra_ops and r.random() < 0.1:
                extra_ops[int(r.integers(0, len(extra_ops)))](idx)
            if background and mirror:
                if bg_thread is not None and not bg_thread.is_alive():
                    bg_join()
                if bg_thread is None and r.random() < 0.15:
                    target = idx
                    trace.append(f"{step}:bg_start")

                    def run_bg(t=target):
                        try:
                            t.build_background()
                        except BaseException as e:  # surfaced at join
                            bg_err.append(e)

                    bg_thread = threading.Thread(target=run_bg)
                    bg_thread.start()
            win = "W" if getattr(idx, "_cow_writes", False) else ""
            op = r.integers(0, 10)
            if op < 4 or not mirror:  # add
                n = int(r.integers(1, 20))
                vecs = rand_vec(n)
                slots = idx.add_batch(vecs)
                trace.append(f"{step}{win}:add{list(map(int, slots))}")
                for s, v in zip(slots, vecs):
                    mirror[int(s)] = v
            elif op < 6:  # remove
                pick = r.choice(sorted(mirror),
                                size=min(len(mirror), int(r.integers(1, 8))),
                                replace=False)
                idx.remove_slots(np.asarray(pick, np.int64))
                trace.append(f"{step}{win}:rm{list(map(int, pick))}")
                for s in pick:
                    del mirror[int(s)]
            elif op < 8:  # update
                pick = r.choice(sorted(mirror),
                                size=min(len(mirror), 3), replace=False)
                vecs = rand_vec(len(pick))
                idx.update_slots(np.asarray(pick, np.int64), vecs)
                trace.append(f"{step}{win}:upd{list(map(int, pick))}")
                for s, v in zip(pick, vecs):
                    mirror[int(s)] = v
            elif op == 8:  # rebuild (flat storage has no build op)
                build = getattr(idx, "build", None)
                if build is not None:
                    build()
                    trace.append(f"{step}{win}:build")
            else:  # persistence round trip
                with tempfile.TemporaryDirectory() as tmp:
                    path = os.path.join(tmp, "diff")
                    idx.save(path)
                    idx2 = make()
                    assert idx2.load(path)
                    idx = idx2
                    trace.append(f"{step}{win}:saveload")
            if step % 5 == 4:
                check()
        bg_join()
        check()
        assert idx.count() == len(mirror)

    def test_ip_metric(self, rng):
        d = 32
        db = rng.standard_normal((2000, d)).astype(np.float32) * \
            rng.uniform(0.5, 2.0, size=(2000, 1)).astype(np.float32)
        idx = _make(d, metric="ip")
        slots = idx.add_batch(db)
        idx.build()
        q = _normed(rng, 4, d)
        _, got = idx.search(q, 10)
        exp = slots[np.argsort(-(q @ db.T), axis=-1)[:, :10]]
        recall = np.mean(
            [len(set(a.tolist()) & set(b.tolist())) / 10
             for a, b in zip(got, exp)]
        )
        assert recall >= 0.95, recall


class TestAdvisoryRegressions:
    """Round-2 advisor findings: each test fails on the pre-fix code."""

    def test_dedup_blocks_skewed_probe_no_overflow(self):
        """counts * bp in _dedup_blocks must not wrap int32: with a
        bucket probed by most of a large batch, the wrapped priority
        ranked the HOTTEST blocks below masked duplicates and dropped
        them from the scan (silent recall collapse in coalesced-batch
        serving)."""
        import torch

        from wdbx_tpu_torch.index.clustered import _dedup_blocks

        B, P, m = 1024, 32, 8
        nblocks = 32
        blk_lo = torch.as_tensor([0, 8, 16, 24], dtype=torch.int32)
        blk_hi = torch.as_tensor([8, 16, 24, 32], dtype=torch.int32)
        # 960 queries hammer bucket 0 (counts ~30720 -> counts*bp ~8e9,
        # wraps int32 pre-fix); 64 queries probe bucket 1
        probe = np.zeros((B, P), np.int32)
        probe[-64:] = 1
        uniq, uniq_ok = _dedup_blocks(
            torch.as_tensor(probe), blk_lo, blk_hi, nblocks, u=16, m=m
        )
        got = set(np.asarray(uniq)[np.asarray(uniq_ok)].tolist())
        # the hot bucket's blocks [0, 8) MUST survive dedup
        assert set(range(8)) <= got, got
        assert set(range(8, 16)) <= got, got

    def test_load_adopts_flat_checkpoint_with_identity_slots(
        self, rng, tmp_path
    ):
        """A flat/IVF checkpoint (slots == positions) loads as an
        untrained clustered index with identity slot maps — previously
        it 'loaded' with all maps at -1 and every search returned -1."""
        d = 32
        flat = FlatIndex(d)
        db = _normed(rng, 500, d)
        slots = flat.add_batch(db)
        flat.save(str(tmp_path / "ckpt"))
        idx = _make(d)
        assert idx.load(str(tmp_path / "ckpt"))
        assert idx.count() == 500
        _, got = idx.search(db[:4], 4)
        assert (got[:, 0] == slots[:4]).all(), got[:, 0]

    def test_load_missing_sidecar_refuses(self, rng, tmp_path):
        """A clustered checkpoint whose sidecar was lost is corrupt —
        refuse instead of serving slot -1 for every hit."""
        idx = _make(32)
        idx.add_batch(_normed(rng, 400, 32))
        idx.build()
        path = str(tmp_path / "ck")
        idx.save(path)
        os.remove(path + ".ivfc.json")
        fresh = _make(32)
        with pytest.raises(ValueError, match="sidecar"):
            fresh.load(path)

    def test_duplicate_slots_one_batch(self, rng):
        """Duplicate ids inside one update/remove batch must not alias
        physical rows or double-decrement the size."""
        d = 32
        idx = _make(d)
        db = _normed(rng, 600, d)
        slots = idx.add_batch(db)
        idx.build()
        v2 = _normed(rng, 2, d)
        idx.update_slots(np.array([slots[0], slots[0]]), v2)
        got = idx.get_vectors(np.array([slots[0]]))
        np.testing.assert_allclose(
            np.asarray(got[0], np.float32), v2[1], atol=1e-2
        )
        n_before = idx.count()
        s_new = idx.add_batch(_normed(rng, 2, d))
        g = np.asarray(idx.get_vectors(s_new), np.float32)
        assert not np.allclose(g[0], g[1])  # no shared physical row
        idx.remove_slots(np.array([slots[1], slots[1]]))
        assert idx.count() == n_before + 2 - 1


class TestHoleRecycling:
    """Bucket-matched reuse of quarantined clustered-region positions:
    delete/update churn must not grow capacity until the next rebuild
    (round-2 known gap). A hole is reusable only by a row whose nearest
    centroid is the hole's own bucket, preserving the kernel-path
    invariant that every scanned row belongs to its covering bucket."""

    def _near(self, rng, base):
        v = 0.95 * base + 0.05 * _normed(rng, len(base), base.shape[1])
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    def test_insert_fills_bucket_matched_holes(self, rng):
        d = 32
        idx = _make(d, nlist=8, nprobe=8)
        db = _normed(rng, 1024, d)
        slots = idx.add_batch(db)
        idx.build()
        ns0 = idx._next_slot
        idx.remove_slots(slots[:100])
        assert idx._quar_len() == 100
        # near-duplicates of the deleted rows assign to the same buckets
        new_slots = idx.add_batch(self._near(rng, db[:100]))
        # the odd row may cross a centroid boundary; the bulk recycles
        assert idx._quar_len() <= 10
        assert idx._next_slot - ns0 == idx._quar_len()
        assert idx.count() == 1024
        # recycled rows live in the clustered region and the BLOCK scan
        # (not the residual scan) must find them
        pos = idx._positions_of(new_slots)
        in_cluster = pos < idx._fresh_base
        assert in_cluster.sum() == 100 - idx._quar_len()
        probe = np.asarray(
            idx.get_vectors(new_slots[in_cluster][:10]), np.float32
        )
        _, got = idx.search(probe, 1)
        assert (got[:, 0] == new_slots[in_cluster][:10]).all()

    def test_update_rewrites_in_place(self, rng):
        """A small perturbation keeps the row in its own bucket, so
        move-on-update reclaims the hole it just opened — usually its
        own position — and the residual region stays empty."""
        d = 32
        idx = _make(d, nlist=8, nprobe=8)
        db = _normed(rng, 1024, d)
        slots = idx.add_batch(db)
        idx.build()
        upd = slots[:50]
        old_pos = idx._positions_of(upd)
        idx.update_slots(upd, self._near(rng, db[:50]))
        new_pos = idx._positions_of(upd)
        # every bucket-matched update reuses the hole set it just made
        stayed = np.isin(new_pos, old_pos).sum()
        assert stayed >= 40, stayed
        assert len(idx._residual) == 50 - stayed
        _, got = idx.search(
            np.asarray(idx.get_vectors(upd[:8]), np.float32), 1
        )
        assert (got[:, 0] == upd[:8]).all()

    def test_recycle_holes_off_preserves_quarantine(self, rng):
        d = 32
        idx = _make(d, nlist=8, nprobe=8)
        db = _normed(rng, 1024, d)
        slots = idx.add_batch(db)
        idx.build()
        idx.recycle_holes = False
        idx.remove_slots(slots[:64])
        ns0 = idx._next_slot
        idx.add_batch(self._near(rng, db[:64]))
        assert idx._quar_len() == 64  # untouched
        assert idx._next_slot == ns0 + 64  # all landed in the residual
        assert idx.count() == 1024

    def test_recycling_defers_rebuild_trigger(self, rng):
        """Recycled holes leave the quarantine, so steady delete+insert
        churn stays below rebuild_fraction instead of forcing periodic
        stop-the-world rebuilds."""
        d = 32
        idx = _make(d, nlist=8, nprobe=8, rebuild_fraction=0.1)
        db = _normed(rng, 1000, d)
        slots = idx.add_batch(db)
        idx.build()
        for i in range(0, 400, 50):  # 40% churn > rebuild_fraction
            idx.remove_slots(slots[i:i + 50])
            idx.add_batch(self._near(rng, db[i:i + 50]))
        assert idx._quar_len() <= 40
        assert not idx._needs_build()

    def test_quarantine_persists_with_buckets(self, rng, tmp_path):
        d = 32
        idx = _make(d, nlist=8, nprobe=8)
        db = _normed(rng, 1024, d)
        slots = idx.add_batch(db)
        idx.build()
        idx.remove_slots(slots[:64])
        path = str(tmp_path / "ck")
        idx.save(path)
        idx2 = _make(d, nlist=8, nprobe=8)
        assert idx2.load(path)
        assert sorted(idx2._quar_flat()) == sorted(idx._quar_flat())
        assert all(b >= 0 for b in idx2._quar)  # re-keyed, recyclable
        ns0 = idx2._next_slot
        idx2.add_batch(self._near(rng, db[:64]))
        assert idx2._quar_len() <= 8
        assert idx2._next_slot - ns0 == idx2._quar_len()

    def test_factory_config_knob(self):
        from wdbx_tpu_torch.core.config import WDBXConfig
        from wdbx_tpu_torch.index.base import create_index

        cfg = WDBXConfig({"IVF_RECYCLE_HOLES": False})
        idx = create_index("ivf_clustered", 16, cfg)
        assert idx.recycle_holes is False
        idx = create_index("ivf_clustered", 16, WDBXConfig({}))
        assert idx.recycle_holes is True

    def test_quar_counter_tracks_dict(self, rng, tmp_path):
        """_quar_len() is a plain counter read by the LOCK-FREE
        _needs_build() pre-check in the search paths; it must track the
        bucket->holes dict exactly through every mutation, rebuild, and
        restore path (iterating the dict there raced concurrent
        mutators: 'dictionary changed size during iteration')."""
        d = 32
        idx = _make(d, nlist=8, nprobe=8)
        db = _normed(rng, 1024, d)

        def consistent(i):
            assert i._quar_n == sum(len(v) for v in i._quar.values())

        slots = idx.add_batch(db)
        idx.build()
        consistent(idx)
        idx.remove_slots(slots[:100])
        consistent(idx)
        assert idx._quar_len() == 100
        idx.add_batch(self._near(rng, db[:100]))  # recycles most holes
        consistent(idx)
        idx.update_slots(slots[200:250], self._near(rng, db[200:250]))
        consistent(idx)
        path = str(tmp_path / "ck")
        idx.save(path)
        idx2 = _make(d, nlist=8, nprobe=8)
        assert idx2.load(path)
        consistent(idx2)
        assert idx2._quar_len() == idx._quar_len()
        idx2.build()  # rebuild clears the quarantine
        consistent(idx2)
        assert idx2._quar_len() == 0


class TestBackgroundRebuild:
    """build_background(): searches serve from the old layout during
    the rebuild; mutations in the window journal and replay at swap."""

    def test_equivalent_to_blocking_build(self, rng):
        d = 32
        db = _normed(rng, 2000, d)
        q = _normed(rng, 8, d)
        a, b = _make(d), _make(d)
        sa, sb = a.add_batch(db), b.add_batch(db)
        a.build()
        b.build_background()
        assert b.is_trained
        _, ga = a.search(q, 10)
        _, gb = b.search(q, 10)
        agree = np.mean(
            [len(set(x.tolist()) & set(y.tolist())) / 10
             for x, y in zip(ga, gb)]
        )
        assert agree >= 0.95, agree
        assert (sa == sb).all()

    def test_mutations_during_rebuild_replay(self, rng):
        import threading

        d = 32
        db = _normed(rng, 1500, d)
        idx = _make(d)
        slots = idx.add_batch(db)
        idx.build()
        # churn so a rebuild has something to do
        idx.remove_slots(slots[:50])

        in_phase2 = threading.Event()
        resume = threading.Event()
        orig_permute = idx._permute

        def paused_permute(slab, scales, src, cap=None):
            in_phase2.set()
            assert resume.wait(30)
            return orig_permute(slab, scales, src, cap=cap)

        idx._permute = paused_permute
        t = threading.Thread(target=idx.build_background)
        t.start()
        assert in_phase2.wait(30)
        # mutate while the rebuild crunches off-lock
        upd_vec = _normed(rng, 1, d)
        idx.update_slots(slots[100:101], upd_vec)
        new_slots = idx.add_batch(_normed(rng, 7, d))
        idx.remove_slots(slots[200:205])
        # searches during the rebuild serve from the old layout
        _, got_mid = idx.search(db[300:304], 1)
        assert (got_mid.ravel() == slots[300:304]).all()
        resume.set()
        t.join(60)
        assert not t.is_alive()
        assert not idx._cow_writes
        # adds visible post-swap
        _, got_new = idx.search(
            np.asarray(idx.get_vectors(new_slots), np.float32), 1
        )
        assert (got_new.ravel() == new_slots).all()
        # update applied (nearest to the new vector is the slot)
        _, got_upd = idx.search(upd_vec, 1)
        assert int(got_upd.ravel()[0]) == slots[100]
        # removes gone
        _, got_rm = idx.search(db[200:205], 5)
        for qi in range(5):
            assert slots[200 + qi] not in got_rm[qi]
        # size bookkeeping consistent
        assert idx.count() == 1500 - 50 - 5 + 7
        assert int(np.asarray(idx._valid).sum()) == idx.count()
        # a follow-up blocking build still works
        idx.build()
        assert int(np.asarray(idx._valid).sum()) == idx.count()

    def test_search_does_not_block_during_rebuild(self, rng):
        import threading

        d = 32
        idx = _make(d)
        db = _normed(rng, 1200, d)
        slots = idx.add_batch(db)
        idx.build()
        in_phase2 = threading.Event()
        resume = threading.Event()
        orig_permute = idx._permute

        def paused(slab, scales, src, cap=None):
            in_phase2.set()
            assert resume.wait(30)
            return orig_permute(slab, scales, src, cap=cap)

        idx._permute = paused
        t = threading.Thread(target=idx.build_background)
        t.start()
        assert in_phase2.wait(30)
        # this search must complete while the rebuild is mid-flight —
        # with the blocking build it would deadlock until resume
        _, got = idx.search(db[:4], 1)
        assert (got.ravel() == slots[:4]).all()
        resume.set()
        t.join(60)
        assert not t.is_alive()


class TestInt4:
    """Packed-nibble capacity tier (kernels/quant.py int4): half the
    HBM of int8, raw ranking recovered by the store's exact re-rank."""

    def test_flat_int4_crud_and_persistence(self, rng, tmp_path):
        d = 64
        idx = FlatIndex(d, dtype="int4")
        db = _normed(rng, 300, d)
        slots = idx.add_batch(db)
        assert idx._slab.shape == (idx.capacity, d // 2)
        assert idx._slab.dtype == torch.uint8
        # self-query: int4 noise is well under the self-match margin
        _, got = idx.search(db[:8], 1)
        assert (got.ravel() == slots[:8]).all()
        # get_vectors round-trips to ~int4 precision
        back = idx.get_vectors(slots[:5])
        cos = np.mean(np.sum(back * db[:5], axis=1)
                      / np.linalg.norm(back, axis=1))
        assert cos > 0.98, cos
        idx.update_slots(slots[:2], _normed(rng, 2, d))
        idx.remove_slots(slots[2:4])
        assert idx.count() == 298
        idx.save(str(tmp_path / "i4"))
        idx2 = FlatIndex(d, dtype="int4")
        assert idx2.load(str(tmp_path / "i4"))
        _, got2 = idx2.search(db[4:8], 1)
        assert (got2.ravel() == slots[4:8]).all()

    def test_clustered_int4_recall_lax_and_kernel(self, rng):
        n, d, k = 6000, 64, 10
        db = _normed(rng, n, d)
        q = _normed(rng, 8, d)
        exact = np.argsort(-(q @ db.T), axis=-1)[:, :k]
        for kernel in ("lax", "pallas"):
            idx = _make(d, dtype="int4", nlist=16, nprobe=16)
            idx.ivf_kernel = kernel
            slots = idx.add_batch(db)
            idx.build()
            assert idx._slab.shape[1] == d // 2
            _, got = idx.search(q, k)
            recall = np.mean(
                [len(set(int(x) for x in a)
                     & set(slots[b_].tolist())) / k
                 for a, b_ in zip(got, exact)]
            )
            # raw int4 ranking on a uniform-random corpus is the
            # adversarial case (score spread ~ quantization noise):
            # assert far-above-chance only (chance = k/n ≈ 0.002); the
            # store layer's exact re-rank recovers to ≥0.95 (next test)
            assert recall >= 0.25, (kernel, recall)

    def test_flat_int4_fused_kernel_matches_exact(self, rng):
        """The fused kernel's per-tile int4 unpack (the path that keeps
        the PACKED slab in HBM — a whole-slab unpack cannot exist at
        the 20M capacity tier) must rank like the exact XLA path's
        whole-slab unpack."""
        d = 64
        db = _normed(rng, 2048, d)
        q = _normed(rng, 8, d)
        idx = FlatIndex(d, dtype="int4", capacity=2048)
        slots = idx.add_batch(db)
        idx.topk_method = "exact"
        _, want = idx.search(q, 10)
        idx.topk_method = "fused"  # interpret-mode Pallas off-TPU
        _, got = idx.search(q, 10)
        overlap = np.mean([
            len(set(a.tolist()) & set(b.tolist())) / 10
            for a, b in zip(got, want)
        ])
        assert overlap >= 0.9, overlap
        _, selfq = idx.search(db[:8], 1)
        assert (selfq.ravel() == slots[:8]).all()

    def test_int4_dim_must_be_even(self):
        with pytest.raises(ValueError, match="even"):
            FlatIndex(33, dtype="int4")

    def test_dense_ivf_rejects_int4(self):
        from wdbx_tpu_torch.index.ivf import IVFIndex

        with pytest.raises(ValueError, match="int4"):
            IVFIndex(32, dtype="int4")

    def test_store_rerank_recovers_int4_recall(self, rng, tmp_path):
        from wdbx_tpu_torch.core.config import WDBXConfig
        from wdbx_tpu_torch.store.vector_store import VectorStore

        d, n, k = 64, 4000, 10
        db = _normed(rng, n, d)
        cfg = WDBXConfig({
            "VECTOR_DIMENSION": d, "NUM_SHARDS": 1,
            "DATA_DIR": str(tmp_path / "s"),
            "INDEX_TYPE": "ivf_clustered", "INDEX_DTYPE": "int4",
            "IVF_NLIST": 16, "IVF_NPROBE": 16,
            "IVF_TRAIN_THRESHOLD": 512,
        })
        store = VectorStore(cfg)
        ids = {f"v{i}": db[i].tolist() for i in range(n)}
        store.batch_store(ids)
        store.optimize()
        assert store._rerank_enabled()
        assert store._rerank_fetch_factor() == 20
        q = _normed(rng, 16, d)
        exact = np.argsort(-(q @ db.T), axis=-1)[:, :k]
        hits = store.search_batch(q, limit=k)
        recall = np.mean([
            len({h[0] for h in row} & {f"v{j}" for j in exact[i]}) / k
            for i, row in enumerate(hits)
        ])
        assert recall >= 0.95, recall
        # and without re-rank the same config is measurably worse
        store.rerank = False
        hits0 = store.search_batch(q, limit=k)
        recall0 = np.mean([
            len({h[0] for h in row} & {f"v{j}" for j in exact[i]}) / k
            for i, row in enumerate(hits0)
        ])
        assert recall > recall0, (recall, recall0)


class TestReviewRound3Regressions:
    """Round-3 adversarial review findings — each fails pre-fix."""

    def test_int4_build_permutes_scales(self, rng):
        """_permute/_install_built gated scales on _is_int8 only: int4
        builds left scales in pre-permute order (silent mis-ranking on
        corpora with varied norms — 'ip' metric makes norms matter)."""
        d = 32
        db = rng.standard_normal((1500, d)).astype(np.float32)
        db *= rng.uniform(0.2, 5.0, size=(1500, 1)).astype(np.float32)
        idx = _make(d, dtype="int4", metric="ip")
        slots = idx.add_batch(db)
        idx.build()  # permutes the slab — scales must follow
        _, got = idx.search(db[:16], 10)
        exp = slots[np.argsort(-(db[:16] @ db.T), axis=-1)[:, :10]]
        recall = np.mean(
            [len(set(int(x) for x in a) & set(b.tolist())) / 10
             for a, b in zip(got, exp)]
        )
        assert recall >= 0.7, recall
        # and the reconstructed rows still roughly match magnitudes
        back = idx.get_vectors(slots[:8])
        rel = np.linalg.norm(back - db[:8], axis=1) / np.linalg.norm(
            db[:8], axis=1
        )
        assert rel.max() < 0.15, rel

    def test_background_rebuild_no_removed_slot_resurrection(self, rng):
        """Slots removed during the rebuild window must stay unknown
        after the swap (the snapshot slot map previously resurrected
        them: double-decrement on re-remove, updates into dead rows)."""
        import threading

        d = 32
        idx = _make(d)
        db = _normed(rng, 1200, d)
        slots = idx.add_batch(db)
        idx.build()
        in2, resume = threading.Event(), threading.Event()
        orig = idx._permute

        def paused(slab, scales, src, cap=None):
            in2.set()
            assert resume.wait(30)
            return orig(slab, scales, src, cap=cap)

        idx._permute = paused
        t = threading.Thread(target=idx.build_background)
        t.start()
        assert in2.wait(30)
        victim = slots[10:13]
        idx.remove_slots(victim)
        n_mid = idx.count()
        resume.set()
        t.join(60)
        # removed slots are unknown: re-remove is a no-op
        idx.remove_slots(victim)
        assert idx.count() == n_mid
        # update of a removed slot is a no-op, not a resurrection
        ghost = _normed(rng, 3, d)
        idx.update_slots(victim, ghost)
        _, got = idx.search(ghost, 1)
        assert not set(int(g) for g in got.ravel()) & set(
            int(s) for s in victim
        )
        assert int(np.asarray(idx._valid).sum()) == idx.count()

    def test_load_during_background_rebuild_wins(self, rng, tmp_path):
        """load() replaces storage wholesale: an in-flight background
        rebuild must abandon its snapshot, not swap stale data over the
        freshly loaded checkpoint."""
        import threading

        d = 32
        donor = _make(d)
        donor_db = _normed(rng, 600, d)
        donor_slots = donor.add_batch(donor_db)
        donor.build()
        donor.save(str(tmp_path / "donor"))

        idx = _make(d)
        idx.add_batch(_normed(rng, 800, d))
        idx.build()
        in2, resume = threading.Event(), threading.Event()
        orig = idx._permute

        def paused(slab, scales, src, cap=None):
            in2.set()
            assert resume.wait(30)
            return orig(slab, scales, src, cap=cap)

        idx._permute = paused
        t = threading.Thread(target=idx.build_background)
        t.start()
        assert in2.wait(30)
        assert idx.load(str(tmp_path / "donor"))
        resume.set()
        t.join(60)
        assert idx.count() == 600
        _, got = idx.search(donor_db[:5], 1)
        assert (got.ravel() == donor_slots[:5]).all()

    def test_v2_kernel_pads_small_batches(self, rng):
        """B < 32 int8 batches pad to the sublane tile inside v2."""
        import torch

        from wdbx_tpu_torch.kernels.clustered_scan import clustered_block_topk_v2

        d, c = 64, 256
        cap = 16 * c
        slab = rng.standard_normal((cap, d)).astype(np.float32)
        slab /= np.linalg.norm(slab, axis=1, keepdims=True)
        scales_row = (np.abs(slab).max(axis=1) / 127.0).astype(np.float32)
        s8 = np.clip(
            np.round(slab / scales_row[:, None]), -127, 127
        ).astype(np.int8)
        q = _normed(rng, 1, d)  # B=1 — the latency path
        uniq = np.arange(16, dtype=np.int32)
        ok = np.ones(16, np.int32)
        v, p = clustered_block_topk_v2(
            torch.as_tensor(s8), torch.ones((1, cap), dtype=torch.int8),
            torch.as_tensor(scales_row.reshape(1, -1)),
            torch.as_tensor(uniq), torch.as_tensor(ok), torch.as_tensor(q),
            k=5, c=c, interpret=True, n_ways=4,
        )
        assert v.shape == (1, 5)
        exact = np.argsort(-(q @ slab.T), axis=-1)[:, :5]
        assert set(np.asarray(p)[0].tolist()) >= set(exact[0][:3].tolist())

    def test_filter_selectivity_counts_live_rows_only(self, rng,
                                                      monkeypatch):
        """A mask whose True bits mostly cover DELETED slots must route
        to the exact scan (raw popcount inflated selectivity and
        under-boosted nprobe)."""
        from wdbx_tpu_torch.index.ivf import IVFIndex

        d = 32
        idx = IVFIndex(d, nlist=8, nprobe=8, train_threshold=256)
        idx.batch_flat_fallback = False
        slots = idx.add_batch(_normed(rng, 2000, d))
        idx.build()
        idx.remove_slots(slots[40:2000])  # 1960 deleted, 40 live
        mask = np.zeros(idx.capacity, bool)
        mask[slots[20:2000]] = True  # covers 20 live + 1960 dead
        assert idx._mask_selectivity(mask) < 0.6  # 20/40 live
        called = []
        orig = FlatIndex._enqueue

        def spy(self_, q, k, plan):
            called.append(1)
            return orig(self_, q, k, plan)

        monkeypatch.setattr(FlatIndex, "_enqueue", spy)
        sparse = np.zeros(idx.capacity, bool)
        sparse[slots[2:3]] = True
        sparse[slots[100:1500]] = True  # dead bits only inflate popcount
        _, got = idx.search(_normed(rng, 2, d), 1, slot_mask=sparse)
        # 1 live bit / 40 live rows = 2.5%... keep below threshold:
        # 1/40 = 2.5% > 2% — use a single live bit over 60 live rows
        live = [int(g) for g in got.ravel() if g >= 0]
        assert all(g == int(slots[2]) for g in live)


class TestBackgroundRebuildWindow:
    """Deterministic ops-during-COW-window coverage: phase 2 of
    ``build_background`` is held open on an Event while the main thread
    runs a scripted mutation sequence, so every journal/replay path is
    exercised on every run (the randomized fuzz only reaches them when
    thread timing happens to leave the window open across ops)."""

    @staticmethod
    def _makers():
        from wdbx_tpu_torch.parallel import ShardedClusteredIndex

        def single(d):
            idx = _make(d, nlist=4, nprobe=4, train_threshold=64)
            idx.batch_flat_fallback = False
            idx.topk_method = "exact"
            return idx

        def sharded(d):
            idx = ShardedClusteredIndex(d, nlist=4, nprobe=4,
                                        train_threshold=64)
            idx.batch_flat_fallback = False
            idx.topk_method = "exact"
            return idx

        return {"single": single, "sharded": sharded}

    def _held_window(self, idx):
        """Patch the cluster-planning step so the NEXT background build
        blocks mid-phase-2 until ``release`` is set. Returns (entered,
        release, restore)."""
        import threading

        attr = (
            "_plan_clusters" if hasattr(type(idx), "_plan_clusters")
            else "_cluster_plan"
        )
        entered = threading.Event()
        release = threading.Event()
        orig = getattr(idx, attr)

        def held(*a, **kw):
            out = orig(*a, **kw)
            # one-shot: only the FIRST call (the background build we
            # started) pauses — a later blocking build issued by the
            # main thread (e.g. via clear()/remesh()) must pass through
            # or the main thread deadlocks against its own release
            if not entered.is_set():
                entered.set()
                assert release.wait(60), "window release never fired"
            return out

        setattr(idx, attr, held)
        return entered, release, (lambda: idx.__dict__.pop(attr, None))

    def _check_exact(self, idx, mirror, rng, nq=8):
        slots = np.array(sorted(mirror), dtype=np.int64)
        mat = np.stack([mirror[s] for s in slots])
        q = rng.standard_normal((nq, mat.shape[1])).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        _, got = idx.search(q, 1)
        sims_exact = np.max(q @ mat.T, axis=1)
        for qi, g, se in zip(q, got[:, 0], sims_exact):
            assert int(g) in mirror, f"unknown slot {g}"
            np.testing.assert_allclose(
                float(qi @ mirror[int(g)]), se, rtol=1e-3, atol=1e-3
            )
        assert idx.count() == len(mirror)

    @pytest.mark.parametrize("engine", ["single", "sharded"])
    def test_scripted_mutations_inside_open_window(self, rng, engine):
        """Adds, updates, removes, slot recycling, hole recycling, a
        no-op blocking build() and a save() — all INSIDE one held-open
        COW window — must replay exactly through the atomic swap (both
        the single-device and the mesh-striped engines)."""
        import os
        import tempfile
        import threading

        d = 16
        maker = self._makers()[engine]
        idx = maker(d)
        mirror = {}

        def vecs(n):
            v = rng.standard_normal((n, d)).astype(np.float32)
            return v / np.linalg.norm(v, axis=1, keepdims=True)

        v0 = vecs(120)
        for s, v in zip(idx.add_batch(v0), v0):
            mirror[int(s)] = v
        idx.build()
        # pre-seed a quarantined hole in the clustered region so an
        # in-window add can recycle it
        pre_hole = sorted(mirror)[3]
        idx.remove_slots(np.array([pre_hole], np.int64))
        del mirror[pre_hole]

        entered, release, restore = self._held_window(idx)
        try:
            t = threading.Thread(target=idx.build_background)
            t.start()
            assert entered.wait(60), "background build never reached phase 2"
            # --- scripted ops inside the open window ---
            # 1. plain adds (some may recycle the pre-seeded hole)
            va = vecs(10)
            for s, v in zip(idx.add_batch(va), va):
                mirror[int(s)] = v
            # 2. update pre-snapshot slots
            upd = np.array(sorted(mirror)[:5], np.int64)
            vu = vecs(len(upd))
            idx.update_slots(upd, vu)
            for s, v in zip(upd, vu):
                mirror[int(s)] = v
            # 3. remove pre-snapshot slots (incl. one just updated)
            rem = np.array([sorted(mirror)[1], sorted(mirror)[10]], np.int64)
            idx.remove_slots(rem)
            for s in rem:
                del mirror[int(s)]
            # 4. remove-then-readd: the freed ext slot id recycles while
            #    the window is still open (journal flips removed->dirty)
            target = sorted(mirror)[7]
            idx.remove_slots(np.array([target], np.int64))
            del mirror[target]
            vr = vecs(1)
            s_new = idx.add_batch(vr)
            for s, v in zip(s_new, vr):
                mirror[int(s)] = v
            # 5. update-then-remove: journal flips dirty->removed
            t2 = sorted(mirror)[12]
            idx.update_slots(np.array([t2], np.int64), vecs(1))
            idx.remove_slots(np.array([t2], np.int64))
            del mirror[t2]
            # 6. blocking build() must be a no-op (not clobber the
            #    in-flight snapshot)
            idx.build()
            # 7. save() under the open window must produce a loadable,
            #    consistent checkpoint (read lock vs phase 2 off-lock)
            with tempfile.TemporaryDirectory() as tmp:
                p = os.path.join(tmp, "w")
                idx.save(p)
                idx2 = maker(d)
                assert idx2.load(p)
                self._check_exact(idx2, mirror, rng)
            # searches against the pre-swap state see every mutation
            self._check_exact(idx, mirror, rng)
        finally:
            release.set()
            t.join(120)
            restore()
        assert not t.is_alive(), "background build hung"
        # post-swap: the journal replay must have preserved every slot
        self._check_exact(idx, mirror, rng)
        # and the index must still take mutations + another build cleanly
        vb = vecs(5)
        for s, v in zip(idx.add_batch(vb), vb):
            mirror[int(s)] = v
        idx.build()
        self._check_exact(idx, mirror, rng)

    @pytest.mark.parametrize("engine", ["single", "sharded"])
    def test_capacity_growth_inside_window_falls_back(self, rng, engine):
        """An over-capacity ingest during the window invalidates the
        permuted arrays; the swap must detect the capacity change and
        redo a blocking build rather than install stale geometry."""
        import threading

        d = 16
        idx = self._makers()[engine](d)
        mirror = {}

        def vecs(n):
            v = rng.standard_normal((n, d)).astype(np.float32)
            return v / np.linalg.norm(v, axis=1, keepdims=True)

        v0 = vecs(100)
        for s, v in zip(idx.add_batch(v0), v0):
            mirror[int(s)] = v
        idx.build()
        cap0 = idx._cap

        entered, release, restore = self._held_window(idx)
        try:
            t = threading.Thread(target=idx.build_background)
            t.start()
            assert entered.wait(60)
            # ingest enough rows to force _grow during the window
            n_big = int(cap0)  # guarantees _next_slot + n > cap
            vb = vecs(n_big)
            for s, v in zip(idx.add_batch(vb), vb):
                mirror[int(s)] = v
            assert idx._cap > cap0, "test did not force growth"
        finally:
            release.set()
            t.join(120)
            restore()
        assert not t.is_alive()
        self._check_exact(idx, mirror, rng)

    def test_remesh_inside_open_window_still_rebuilds(self, rng):
        """remesh() during an open COW window must kill the in-flight
        build AND release the window so its own follow-up build()
        actually runs — before the fix the build() hit _build_locked's
        in-flight early-return, the background build abandoned at swap
        time, and the index was left untrained with bucket -1 holes."""
        import threading

        from wdbx_tpu_torch.parallel import make_mesh

        d = 16
        idx = self._makers()["sharded"](d)
        mirror = {}

        def vecs(n):
            v = rng.standard_normal((n, d)).astype(np.float32)
            return v / np.linalg.norm(v, axis=1, keepdims=True)

        v0 = vecs(120)
        for s, v in zip(idx.add_batch(v0), v0):
            mirror[int(s)] = v
        idx.build()
        # churn so the post-remesh rebuild has holes to clear
        rm = np.array(sorted(mirror)[:5], np.int64)
        idx.remove_slots(rm)
        for s in rm:
            del mirror[int(s)]

        entered, release, restore = self._held_window(idx)
        try:
            t = threading.Thread(target=idx.build_background)
            t.start()
            assert entered.wait(60)
            idx.remesh(make_mesh(4))
            # the remesh's promised rebuild must have actually run
            assert idx.is_trained, "remesh left the index untrained"
            assert not idx._cow_writes, "remesh left the COW window open"
            self._check_exact(idx, mirror, rng)
        finally:
            release.set()
            t.join(120)
            restore()
        assert not t.is_alive()
        # the abandoned build must not have clobbered the new state
        assert idx.is_trained
        assert not idx._cow_writes
        self._check_exact(idx, mirror, rng)
        # and a fresh background rebuild cycle still works end-to-end
        va = vecs(6)
        for s, v in zip(idx.add_batch(va), va):
            mirror[int(s)] = v
        idx.build_background()
        self._check_exact(idx, mirror, rng)

    @pytest.mark.parametrize("engine", ["single", "sharded"])
    def test_clear_inside_open_window_allows_blocking_build(
            self, rng, engine):
        """clear() during an open COW window releases the window, so a
        re-ingest + build() right after actually trains instead of
        being silently skipped by the in-flight guard."""
        import threading

        d = 16
        idx = self._makers()[engine](d)

        def vecs(n):
            v = rng.standard_normal((n, d)).astype(np.float32)
            return v / np.linalg.norm(v, axis=1, keepdims=True)

        idx.add_batch(vecs(120))
        idx.build()

        entered, release, restore = self._held_window(idx)
        try:
            t = threading.Thread(target=idx.build_background)
            t.start()
            assert entered.wait(60)
            idx.clear()
            mirror = {}
            v1 = vecs(100)
            for s, v in zip(idx.add_batch(v1), v1):
                mirror[int(s)] = v
            idx.build()
            assert idx.is_trained, "build() after clear() was skipped"
            self._check_exact(idx, mirror, rng)
        finally:
            release.set()
            t.join(120)
            restore()
        assert not t.is_alive()
        assert idx.is_trained
        assert not idx._cow_writes
        self._check_exact(idx, mirror, rng)


class TestFilteredTuning:
    """tune_filtered: the recall-closed loop on the filtered probe boost
    (VERDICT r3 ask #4 — the fixed ~2/selectivity heuristic measured
    0.947 recall@10 at 10% selectivity, under the 0.95 bar)."""

    def _corpus(self, idx, rng, n=16384, d=32):
        db = _normed(rng, n, d)
        slots = np.asarray(idx.add_batch(db))
        idx.build()
        return db, slots

    def _pct_mask(self, rng, slots, frac):
        mask = np.zeros(int(slots.max()) + 1, bool)
        mask[slots[rng.random(len(slots)) < frac]] = True
        return mask

    @pytest.mark.parametrize("frac", [0.10, 0.30])
    def test_tune_filtered_meets_bar_clustered(self, rng, frac):
        idx = _make(32, nlist=64, nprobe=2, train_threshold=64)
        idx.topk_method = "exact"
        idx.batch_flat_fallback = False
        db, slots = self._corpus(idx, rng)
        mask = self._pct_mask(rng, slots, frac)
        q = _normed(rng, 16, 32)
        achieved = idx.tune_filtered(q, mask, k=10, target_recall=0.95)
        assert achieved >= 0.95, achieved
        assert idx._filter_boosts, "calibration did not stick"
        # the calibrated boost serves future searches in the same bin:
        # fresh queries still meet the bar against the exact masked scan
        q2 = _normed(rng, 16, 32)
        _, exact = idx._oracle_search_masked(q2, 10, mask)
        _, got = idx.search(q2, 10, slot_mask=mask)
        hits = np.mean([
            len(set(map(int, g[g >= 0])) & set(map(int, e[e >= 0]))) / 10
            for g, e in zip(got, exact)
        ])
        assert hits >= 0.9, hits
        assert all(mask[int(g)] for g in got.ravel() if g >= 0)

    def test_tune_filtered_dense_ivf(self, rng):
        from wdbx_tpu_torch.index.ivf import IVFIndex

        idx = IVFIndex(32, nlist=64, nprobe=2, train_threshold=64)
        idx.topk_method = "exact"
        idx.batch_flat_fallback = False
        db, slots = self._corpus(idx, rng)
        mask = self._pct_mask(rng, slots, 0.10)
        achieved = idx.tune_filtered(
            _normed(rng, 16, 32), mask, k=10, target_recall=0.95
        )
        assert achieved >= 0.95, achieved

    def test_tune_filtered_deescalates_overprobing_default(self, rng):
        """When the default boost already over-shoots the target,
        tune_filtered must pin a SMALLER factor (trimming probe DMA the
        recall does not need) that still meets the target — the r5 fix
        for the 10%-selectivity leg paying 3x the unfiltered cost for
        +0.016 recall over the bar."""
        from wdbx_tpu_torch.index.ivf import _DEFAULT_BOOSTS, _boost_bin

        # nprobe high enough that the default boost saturates recall:
        # a mid-selectivity mask is then trivially recalled and the
        # tuner should walk the ladder DOWN
        idx = _make(32, nlist=32, nprobe=8, train_threshold=64)
        idx.topk_method = "exact"
        idx.batch_flat_fallback = False
        db, slots = self._corpus(idx, rng, n=8192)
        mask = self._pct_mask(rng, slots, 0.5)
        q = _normed(rng, 16, 32)
        achieved = idx.tune_filtered(q, mask, k=10, target_recall=0.9)
        assert achieved >= 0.9, achieved
        bin_ = _boost_bin(idx._mask_selectivity(mask))
        pinned = idx._filter_boosts[bin_]
        # nprobe=8 of nlist=32 at 50% selectivity: boost 1-2 suffices,
        # so anything >= the default means de-escalation never ran
        assert pinned < _DEFAULT_BOOSTS[bin_], (
            f"pinned {pinned}, default {_DEFAULT_BOOSTS[bin_]}"
        )

    def test_tune_filtered_sparse_mask_routes_exact(self, rng):
        """Below FILTER_EXACT_THRESHOLD the filtered path is already the
        exact masked scan; tuning is a no-op reporting recall 1.0."""
        idx = _make(32, nlist=16, nprobe=4, train_threshold=64)
        db, slots = self._corpus(idx, rng, n=4096)
        mask = np.zeros(int(slots.max()) + 1, bool)
        mask[slots[:40]] = True  # ~1% < 2% threshold
        r = idx.tune_filtered(_normed(rng, 4, 32), mask)
        assert r == 1.0
        assert not idx._filter_boosts

    def test_calibrated_boost_overrides_default(self):
        from wdbx_tpu_torch.index.ivf import _DEFAULT_BOOSTS, _filter_boost

        assert _filter_boost(0.10) == _DEFAULT_BOOSTS[3] == 16
        assert _filter_boost(0.10, {3: 32}) == 32
        assert _filter_boost(0.30, {3: 32}) == _DEFAULT_BOOSTS[1]
        assert _filter_boost(0.60, {}) == 2


class TestStaleLabelAliasing:
    """update-move must clear the moved-from label (r4 racing
    differential failure): a stale ``_slot_of`` label at a dead
    position survived save(), and load()'s last-assignment-wins
    ``_pos_of`` rebuild could point the slot at its dead row — a later
    remove then double-freed that position, two inserts recycled it
    twice, and one slot became a ghost the next rebuild dropped."""

    def _live_invariant(self, idx, live_slots):
        """Every live slot maps to a unique valid position whose label
        round-trips, and count() agrees."""
        live_slots = np.asarray(sorted(live_slots), np.int64)
        pos = idx._positions_of(live_slots)
        assert (pos >= 0).all(), "live slot lost its position"
        assert len(np.unique(pos)) == len(pos), "two slots share a row"
        valid = np.asarray(idx._valid)
        assert valid[pos].all(), "live slot points at a dead row"
        assert (idx._slot_of[pos] == live_slots).all(), "label mismatch"
        assert idx.count() == len(live_slots)
        # and no DEAD position keeps a label anywhere below the HWM
        hwm = idx._next_slot
        labels = idx._slot_of[:hwm]
        assert (labels[~np.asarray(valid[:hwm])] == -1).all(), (
            "stale label on a dead row"
        )

    def test_update_clears_moved_from_label(self, rng):
        d = 32
        idx = _make(d)
        db = _normed(rng, 1200, d)
        slots = idx.add_batch(db)
        idx.build()
        idx.update_slots(slots[5:9], _normed(rng, 4, d))
        self._live_invariant(idx, slots.tolist())

    def test_update_save_load_churn_no_ghost(self, rng, tmp_path):
        """The full failure chain: update-moves, persistence round
        trip, recycling churn, then a rebuild — no slot may vanish."""
        d = 32
        idx = _make(d)
        db = _normed(rng, 1500, d)
        slots = idx.add_batch(db)
        idx.build()
        live = set(slots.tolist())
        # moves: updates land in bucket holes or the residual region
        for lo in (0, 40, 40, 80):  # re-update 40.. twice (re-move)
            idx.update_slots(
                slots[lo:lo + 40], _normed(rng, 40, d)
            )
        path = os.path.join(str(tmp_path), "stale")
        idx.save(path)
        idx2 = _make(d)
        assert idx2.load(path)
        self._live_invariant(idx2, live)
        # churn the recycled holes: remove the updated slots, insert
        # replacements (double-freed positions would alias here)
        idx2.remove_slots(slots[:120])
        live -= set(slots[:120].tolist())
        fresh = idx2.add_batch(_normed(rng, 240, d))
        assert not (set(fresh.tolist()) & live), "recycled live slot id"
        live |= set(fresh.tolist())
        self._live_invariant(idx2, live)
        idx2.build()
        self._live_invariant(idx2, live)

    def test_load_drops_stale_labels_from_old_checkpoints(
        self, rng, tmp_path
    ):
        """Pre-r4 checkpoints can carry the stale moved-from label;
        load() must drop labels on dead rows instead of letting the
        last assignment win."""
        d = 32
        idx = _make(d)
        db = _normed(rng, 1200, d)
        slots = idx.add_batch(db)
        idx.build()
        idx.remove_slots(slots[100:101])  # a dead clustered row
        dead_pos = -1
        valid = np.asarray(idx._valid[: idx._next_slot])
        for p in range(len(valid) - 1, 0, -1):
            if not valid[p] and valid[p - 1] and idx._slot_of[p - 1] >= 0:
                dead_pos = p
                break
        assert dead_pos > 0, "no dead row with a live lower neighbor"
        victim = int(idx._slot_of[dead_pos - 1])
        path = os.path.join(str(tmp_path), "oldckpt")
        idx.save(path)
        # plant the stale label the way pre-r4 update_slots left it:
        # the dead row still carries the victim's (moved-from) label,
        # AFTER the victim's real row in assignment order
        data = dict(np.load(path + ".ivfc.npz"))
        data["slot_of"] = np.asarray(data["slot_of"], np.int32).copy()
        data["slot_of"][dead_pos] = victim
        np.savez(path + ".ivfc.npz", **data)
        idx2 = _make(d)
        assert idx2.load(path)
        assert int(idx2._pos_of[victim]) == dead_pos - 1, (
            "stale label at the dead row won the _pos_of rebuild"
        )
        self._live_invariant(
            idx2, [s for s in slots.tolist() if s != int(slots[100])]
        )
