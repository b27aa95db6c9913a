"""Parity of the port's ClusteredIVFIndex with wdbx_tpu's, on the CPU:
mutation, persistence and the builds.

After a layout is carried across (``clustered_index_from_arrays``, or a
save in one package and a load in the other), the same mutation script
runs on both: adds into the residual region, update-moves, deletes into
the per-bucket quarantine, and bucket-matched hole reuse. The slot maps,
residual list and quarantine must then agree exactly, and searches on
both the portable and the kernel path must name the same slots. The
port's own builds (blocking, streaming, background) are held against
each other at full probe.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from test_torch_clustered import (
    D,
    assert_same_search,
    carry,
    jax_index,
    mixture,
    set_both,
)
from test_torch_ops import TOL
from wdbx_tpu.index.clustered import ClusteredIVFIndex as JIndex
from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex as TIndex
from wdbx_tpu_torch.index.flat import FlatIndex as TFlat

torch.set_num_threads(2)


def mutate(idx, x, fresh, moved):
    """The mutation script: deletes (quarantine), re-adds of deleted rows
    (bucket-matched hole reuse), fresh adds (residual), update-moves."""
    idx.remove_slots(np.arange(40, 80))
    reused = idx.add_batch(x[40:60])
    added = idx.add_batch(fresh)
    idx.update_slots(np.array([3, 5, 7, int(added[0])]), moved)
    idx.remove_slots(np.array([int(added[1]), 9]))
    return reused, added


def assert_same_state(j, t):
    np.testing.assert_array_equal(t._slot_of, j._slot_of)
    np.testing.assert_array_equal(t._pos_of, j._pos_of)
    assert t._residual == j._residual
    assert {b: sorted(h) for b, h in t._quar.items()} == \
        {b: sorted(h) for b, h in j._quar.items()}
    assert t._size == j._size and t._free == j._free
    np.testing.assert_array_equal(np.asarray(t._valid), np.asarray(j._valid))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_mutation_script_matches(rng, dtype):
    x = mixture(rng, 3000)
    j = jax_index(rng, dtype, x=x)
    t = carry(j)
    fresh, moved = mixture(rng, 30), mixture(rng, 4)
    rj, aj = mutate(j, x, fresh, moved)
    rt, at = mutate(t, x, fresh, moved)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(at, aj)
    assert_same_state(j, t)
    assert t._quar_len() < 40  # holes were reused by their own rows
    assert len(t._residual) > 0
    q = np.concatenate([mixture(rng, 4), fresh[:2], moved[:2]])
    for kernel in ("lax", "pallas"):
        set_both(j, t, ivf_kernel=kernel)
        _, it = assert_same_search(j, t, q, 10, TOL[dtype])
        for row in it:  # no block / residual double count
            live = row[row >= 0]
            assert len(live) == len(set(live.tolist()))
    assert t.get_stats()["tombstones"] == j.get_stats()["tombstones"]


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int4"])
def test_save_load_across_packages(tmp_path, rng, direction, dtype):
    x = mixture(rng, 3000)
    j = jax_index(rng, dtype, x=x)
    fresh, moved = mixture(rng, 30), mixture(rng, 4)
    path = str(tmp_path / "ck")
    if direction == "jax_to_torch":
        mutate(j, x, fresh, moved)
        j.save(path)
        t = TIndex(D, dtype=dtype, device="cpu")
        assert t.load(path)
    else:
        t = carry(j)
        mutate(t, x, fresh, moved)
        t.save(path)
        mutate(j, x, fresh, moved)  # the reference state to compare
        j2 = JIndex(D, dtype=dtype)
        assert j2.load(path)
        assert_same_state(j, j2)
        j = j2
    assert t._c == j._c == 256
    assert_same_state(j, t)
    set_both(j, t, batch_flat_fallback=False, ivf_kernel="pallas")
    assert_same_search(j, t, mixture(rng, 8), 10, TOL[dtype])
    # the next mutation lands the same way after the reload
    for idx in (j, t):
        idx.add_batch(x[100:104])
        idx.remove_slots(np.arange(200, 210))
    assert_same_state(j, t)


def _full_probe(idx):
    idx.nprobe = idx.nlist
    idx.batch_flat_fallback = False
    return idx


def _hit_sets(idx, q, k=10):
    return [set(r.tolist()) for r in idx.search(q, k)[1]]


def test_builds_agree_at_full_probe(rng):
    """The blocking build, the streaming build_from and the background
    build of the port serve the same hits at full probe (the exact
    answer), with stable slot ids; compact() is the identity."""
    x = mixture(rng, 3000)
    q = mixture(rng, 8)
    kw = dict(nlist=16, nprobe=2, train_threshold=256, capacity=4096,
              device="cpu")
    blocking = _full_probe(TIndex(D, **kw))
    slots = blocking.add_batch(x)
    blocking.build()
    flat = TFlat(D, capacity=4096, device="cpu")
    flat.add_batch(x)
    truth = _hit_sets(flat, q)
    assert _hit_sets(blocking, q) == truth

    streaming = _full_probe(TIndex(D, **kw))
    chunks = lambda: (x[i:i + 700] for i in range(0, len(x), 700))  # noqa: E731
    got = streaming.build_from(chunks, train_chunks=2)
    # slots are the rows' clustered positions, a permutation of the rows
    np.testing.assert_array_equal(np.sort(got), slots)
    assert streaming.is_trained and streaming._c == blocking._c
    row_of = np.argsort(got)
    assert [{int(row_of[s]) for s in h} for h in _hit_sets(streaming, q)] \
        == truth

    background = _full_probe(TIndex(D, **kw))
    background.add_batch(x)
    background.build_background()
    assert background.is_trained and not background._cow_writes
    assert _hit_sets(background, q) == truth
    np.testing.assert_array_equal(background._slot_of, blocking._slot_of)

    old, new = blocking.compact()
    np.testing.assert_array_equal(old, new)
    assert _hit_sets(blocking, q) == truth


def test_background_build_replays_window_mutations(rng):
    """Writes made while the background build runs off the lock land in
    the new layout under their own slots."""
    x = mixture(rng, 2000)
    t = _full_probe(TIndex(D, nlist=8, train_threshold=256, capacity=4096,
                           device="cpu"))
    t.add_batch(x)
    t.build()
    plan = t._cluster_plan
    extra = mixture(rng, 3)
    box = {}

    def racing_plan(*a, **kw):  # mutations inside the copy-on-write window
        out = plan(*a, **kw)
        del t._cluster_plan  # once
        box["slots"] = t.add_batch(extra)
        t.remove_slots(np.arange(5))
        return out

    t._cluster_plan = racing_plan
    t.build_background()
    assert t.count() == 2000 + 3 - 5
    _, got = t.search(extra, 1)
    np.testing.assert_array_equal(got[:, 0], box["slots"])
    _, hits = t.search(x[:5], 3)
    assert not set(hits.ravel().tolist()) & set(range(5))


def test_background_build_leaves_search_precision_alone(rng, monkeypatch):
    """A search on a float32 slab that runs while the background build
    assigns rows (off the lock, on its own thread) sees the process-wide
    TF32 switch as the caller left it, and serves the exact hits."""
    x = mixture(rng, 2000)
    q = mixture(rng, 8)
    t = _full_probe(TIndex(D, nlist=8, train_threshold=256, capacity=4096,
                           device="cpu"))
    t.add_batch(x)
    t.build()
    want = _hit_sets(t, q)
    flag = torch.backends.cuda.matmul.allow_tf32
    argmax = torch.argmax
    assigning, searched = threading.Event(), threading.Event()

    def spy(*a, **kw):  # the build pauses inside its assignment
        if sys._getframe(1).f_code.co_name == "_assign_blocked" \
                and not assigning.is_set():
            assigning.set()
            searched.wait(60)
        return argmax(*a, **kw)

    monkeypatch.setattr(torch, "argmax", spy)
    bg_build = threading.Thread(target=t.build_background)
    bg_build.start()
    try:
        assert assigning.wait(60), "the build never assigned"
        seen = torch.backends.cuda.matmul.allow_tf32
        got = _hit_sets(t, q)
    finally:
        searched.set()
        bg_build.join(60)
    assert not bg_build.is_alive()
    assert seen == flag
    assert got == want
    assert _hit_sets(t, q) == want


def test_flat_checkpoint_is_adopted_and_missing_sidecar_refused(tmp_path,
                                                                 rng):
    x = mixture(rng, 500)
    flat = TFlat(D, device="cpu")
    slots = flat.add_batch(x)
    flat.save(str(tmp_path / "flat"))
    t = TIndex(D, train_threshold=1 << 20, device="cpu")
    assert t.load(str(tmp_path / "flat"))
    assert t.count() == 500 and not t.is_trained
    _, got = t.search(x[:4], 3)
    np.testing.assert_array_equal(got[:, 0], slots[:4])

    j = jax_index(rng, "float32")
    j.save(str(tmp_path / "ck"))
    (tmp_path / "ck.ivfc.json").unlink()
    with pytest.raises(ValueError, match="sidecar"):
        TIndex(D, device="cpu").load(str(tmp_path / "ck"))
