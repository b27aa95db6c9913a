"""The copy-on-write window of the background rebuild, held open.

``tests/test_clustered.py::TestBackgroundRebuildWindow`` on the port,
for both makers: the single-device ``ClusteredIVFIndex`` and the
``ShardedClusteredIndex`` on 8 logical CPU shards
(``WDBX_TORCH_MESH_SIZE=8``). The cluster-planning step of the next
background build is patched to block until released, and the main
thread runs a scripted sequence of mutations, a blocking build, a save,
a growth past the capacity, a remesh or a clear inside the window; the
swap must replay every acknowledged write and drop every delete.
"""

import numpy as np
import pytest
import torch

from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex
from wdbx_tpu_torch.parallel.mesh import MESH_SIZE_ENV

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def eight_shards(monkeypatch):
    monkeypatch.setenv(MESH_SIZE_ENV, "8")


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
            idx = ClusteredIVFIndex(d, nlist=4, nprobe=4, train_threshold=64,
                                    device="cpu")
            idx.batch_flat_fallback = False
            idx.topk_method = "exact"
            return idx

        def sharded(d):
            idx = ShardedClusteredIndex(d, nlist=4, nprobe=4,
                                        train_threshold=64, device="cpu")
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
            idx.remesh(make_mesh(4, device="cpu"))
            # the remesh's promised rebuild must have actually run
            assert idx.is_trained, "remesh left the index untrained"
            assert not idx._cow_writes, "remesh left the COW window open"
            self._check_exact(idx, mirror, rng)
        finally:
            release.set()
            t.join(120)
            restore()
        assert not t.is_alive()
        # the abandoned background build must not have clobbered the new state
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
