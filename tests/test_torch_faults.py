"""Cases where the port once disagreed with wdbx_tpu, on the CPU.

Each runs the same seeded inputs through both packages and holds the
port to the number the JAX package gives:
  * a filter's selectivity counts only live rows: slots the dense
    IVFIndex quarantined since its last build are dead;
  * ``load()`` during a background rebuild wins: the rebuild abandons its
    snapshot instead of swapping it over the loaded checkpoint (and the
    dense IVFIndex's load also moves the layout generation);
  * ``IVFIndex`` is exported at the package root.
"""

import threading

import numpy as np
import pytest

from wdbx_tpu.index.clustered import ClusteredIVFIndex as JClustered
from wdbx_tpu.index.ivf import IVFIndex as JIVF
from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex as TClustered
from wdbx_tpu_torch.index.ivf import IVFIndex as TIVF

D = 32


def _normed(rng, n, d=D):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _dense(cls, **kw):
    idx = cls(D, nlist=8, nprobe=8, train_threshold=256, **kw)
    idx.batch_flat_fallback = False
    return idx


def _selectivity(idx, x):
    """The JAX test's script: 2,000 rows, all but 40 deleted after the
    build, a mask on 20 live and 1,960 dead rows."""
    slots = idx.add_batch(x)
    idx.build()
    idx.remove_slots(slots[40:2000])
    mask = np.zeros(idx.capacity, bool)
    mask[slots[20:2000]] = True
    return slots, idx._mask_selectivity(mask)


def test_filter_selectivity_counts_live_rows_only(rng):
    x = _normed(rng, 2000)
    _, want = _selectivity(_dense(JIVF), x)
    t = _dense(TIVF, device="cpu")
    slots, got = _selectivity(t, x)
    assert want == 0.5
    assert got == want
    assert len(t._quarantine) == 1960
    # a sparse filter (1 live bit under 1,400 dead ones) routes like JAX:
    # every hit is the one live row it passes
    sparse = np.zeros(t.capacity, bool)
    sparse[slots[2:3]] = True
    sparse[slots[100:1500]] = True
    q = _normed(rng, 2)
    _, got_slots = t.search(q, 1, slot_mask=sparse)
    live = [int(g) for g in np.asarray(got_slots).ravel() if g >= 0]
    assert live and all(g == int(slots[2]) for g in live)


def _clustered(cls, **kw):
    idx = cls(D, nlist=16, nprobe=16, train_threshold=256, **kw)
    idx.batch_flat_fallback = False
    return idx


def _load_during_rebuild(make, rng, path):
    """The JAX test's script: a donor of 600 rows saved; a second index
    of 800 rows starts a background rebuild, is paused inside it, loads
    the donor, then lets the rebuild finish. Returns the count and the
    slots of the donor's first five rows."""
    donor = make()
    donor_db = _normed(rng, 600)
    donor_slots = donor.add_batch(donor_db)
    donor.build()
    donor.save(path)

    idx = make()
    idx.add_batch(_normed(rng, 800))
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
    assert idx.load(path)
    resume.set()
    t.join(60)
    assert not t.is_alive()
    _, got = idx.search(donor_db[:5], 1)
    return idx.count(), np.asarray(donor_slots[:5]).tolist(), \
        np.asarray(got).ravel().tolist()


def test_load_during_background_rebuild_wins(tmp_path):
    want = _load_during_rebuild(lambda: _clustered(JClustered),
                                np.random.default_rng(0),
                                str(tmp_path / "jax"))
    got = _load_during_rebuild(lambda: _clustered(TClustered, device="cpu"),
                               np.random.default_rng(0),
                               str(tmp_path / "torch"))
    assert want == (600, [0, 1, 2, 3, 4], [0, 1, 2, 3, 4])
    assert got == want


@pytest.mark.parametrize("cls", [JIVF, TIVF], ids=["jax", "torch"])
def test_dense_load_moves_the_layout_generation(cls, rng, tmp_path):
    kw = {"device": "cpu"} if cls is TIVF else {}
    donor = _dense(cls, **kw)
    donor.add_batch(_normed(rng, 600))
    donor.build()
    donor.save(str(tmp_path / "donor"))
    idx = _dense(cls, **kw)
    before = getattr(idx, "_layout_gen", 0)
    assert idx.load(str(tmp_path / "donor"))
    assert getattr(idx, "_layout_gen", 0) > before
    assert idx.count() == 600
