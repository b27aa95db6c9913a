"""The cases of ``tests/test_crash_atomic.py`` on the port, on the CPU.

A translated copy of that file: the same classes, functions,
parametrisations and asserts, run on ``wdbx_tpu_torch``. Each
``wdbx_tpu`` import names its ``wdbx_tpu_torch`` counterpart; the
autouse fixture asks for the CPU through
``test_torch_ops.port_on_cpu`` (the default device and mesh of one
test), so the package keeps the card as its own default.

Translated, every case (12 cases):
test_crash_window_serves_last_complete_generation;
test_sigkill_mid_save_serves_previous_generation;
test_damaged_current_falls_back_to_complete_generation;
test_manifest_detects_missing_file; test_recover_uses_latest_generation;
test_old_layout_migrates_and_cleans_up;
test_generations_are_garbage_collected;
test_failed_slab_restore_poisons_shard_not_checkpoint;
test_rawstore_dense_fastpath_rejects_duplicates.

Changed beyond the imports and the fixture: the SIGKILL case's child
process, which the fixture does not reach, builds its ``VectorStore``
with ``device="cpu"`` and imports no JAX (the JAX import, its platform
line and the ``JAX_PLATFORMS`` of the child's environment are gone). It
still dies by SIGKILL before the rename, and the reload serves
generation 1. Left out: nothing.

The reference file's description:

Crash-atomic checkpoint tests (VERDICT r4 ask #5).

A save interrupted in ANY window — mid-file, pre-rename, between the
directory rename and the CURRENT pointer flip, or killed by SIGKILL —
must leave the store serving the last COMPLETE generation on reload,
never a torn checkpoint and never a silently-fresh index (the
reference's failure mode, reference wdbx/core/indexing.py:309-315).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from wdbx_tpu_torch.core.config import WDBXConfig
from wdbx_tpu_torch.store import atomic
from wdbx_tpu_torch.store.vector_store import VectorStore
from test_torch_ops import port_on_cpu


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    port_on_cpu(monkeypatch)


def _make(tmp_path, **over):
    cfg = {
        "VECTOR_DIMENSION": 8,
        "DATA_DIR": str(tmp_path),
        "VECTOR_STORE_AUTOSAVE_INTERVAL": 0,
        "INDEX_TYPE": "flat",
    }
    cfg.update(over)
    return VectorStore(WDBXConfig(cfg))


def _fill(store, ids, seed=0):
    r = np.random.default_rng(seed)
    out = {}
    for vid in ids:
        v = r.standard_normal(8).astype(np.float32)
        v /= np.linalg.norm(v)
        store.store(vid, v, {"name": vid})
        out[vid] = v
    return out


class _Crash(Exception):
    pass


@pytest.fixture(autouse=True)
def _clear_hook():
    yield
    atomic.CRASH_HOOK = None


@pytest.mark.parametrize(
    "window,expect_new",
    [
        ("pre_manifest", False),   # staging torn: old generation serves
        ("pre_rename", False),     # staged but never renamed
        ("post_rename", False),    # complete but CURRENT not flipped
        ("post_current", True),    # committed: new generation serves
    ],
)
def test_crash_window_serves_last_complete_generation(
    tmp_path, window, expect_new
):
    store = _make(tmp_path)
    _fill(store, [f"a{i}" for i in range(5)])
    store.save()  # generation 1, complete

    _fill(store, [f"b{i}" for i in range(3)], seed=1)

    def hook(label):
        if label == window:
            raise _Crash(window)

    atomic.CRASH_HOOK = hook
    with pytest.raises(_Crash):
        store.save()  # generation 2, killed mid-protocol
    atomic.CRASH_HOOK = None

    re = _make(tmp_path)
    assert re.get("a0") is not None, "last complete generation lost"
    has_new = re.get("b0") is not None
    assert has_new == expect_new, (
        f"crash at {window}: expected new-gen rows "
        f"{'present' if expect_new else 'absent'}"
    )
    expected_count = 8 if expect_new else 5
    assert re.count() == expected_count
    # the damaged state must also be SAVABLE again: the next save wins
    _fill(re, ["c0"], seed=2)
    re.save()
    re2 = _make(tmp_path)
    assert re2.get("c0") is not None
    assert re2.count() == expected_count + 1


def test_sigkill_mid_save_serves_previous_generation(tmp_path):
    """Gold-standard crash: a real subprocess SIGKILLs itself while
    save() is writing generation 2; reload must serve generation 1."""
    script = f"""
import os, sys
sys.path.insert(0, {str(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))!r})
import numpy as np
from wdbx_tpu_torch.core.config import WDBXConfig
from wdbx_tpu_torch.store import atomic
from wdbx_tpu_torch.store.vector_store import VectorStore

store = VectorStore(WDBXConfig({{
    "VECTOR_DIMENSION": 8, "DATA_DIR": {str(tmp_path)!r},
    "VECTOR_STORE_AUTOSAVE_INTERVAL": 0, "INDEX_TYPE": "flat",
}}), device="cpu")
r = np.random.default_rng(0)
for i in range(5):
    v = r.standard_normal(8).astype(np.float32)
    store.store(f"a{{i}}", v / np.linalg.norm(v), {{"name": f"a{{i}}"}})
store.save()
for i in range(3):
    v = r.standard_normal(8).astype(np.float32)
    store.store(f"b{{i}}", v / np.linalg.norm(v), {{"name": f"b{{i}}"}})
atomic.CRASH_HOOK = lambda label: os.kill(os.getpid(), 9) \
    if label == "pre_rename" else None
store.save()
"""
    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable, "-c", script], env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == -9, (
        f"subprocess should die by SIGKILL, got {proc.returncode}: "
        f"{proc.stderr[-2000:]}"
    )
    re = _make(tmp_path)
    assert re.count() == 5
    for i in range(5):
        assert re.get(f"a{i}") is not None
    assert re.get("b0") is None


def test_damaged_current_falls_back_to_complete_generation(tmp_path):
    store = _make(tmp_path)
    _fill(store, ["x1", "x2"])
    store.save()
    cur = os.path.join(str(tmp_path), "checkpoint", "CURRENT.json")
    # (a) CURRENT deleted out-of-band
    os.remove(cur)
    re = _make(tmp_path)
    assert re.count() == 2
    # (b) CURRENT pointing at a generation that does not exist
    with open(cur, "w") as f:
        json.dump({"generation": 999}, f)
    re = _make(tmp_path)
    assert re.count() == 2
    # (c) CURRENT unparseable
    with open(cur, "w") as f:
        f.write("not json{")
    re = _make(tmp_path)
    assert re.count() == 2


def test_manifest_detects_missing_file(tmp_path):
    """A generation missing a manifest-listed file is torn; with no
    other complete generation the store starts fresh (and says so)."""
    store = _make(tmp_path)
    _fill(store, ["x1", "x2"])
    store.save()
    gen_dir = store._ckpt_dir
    # delete one checkpoint file out-of-band
    victim = os.path.join(gen_dir, "indices", "shard_0.npz")
    os.remove(victim)
    re = _make(tmp_path)
    assert re.count() == 0  # torn generation refused, no silent partial


def test_recover_uses_latest_generation(tmp_path):
    store = _make(tmp_path)
    _fill(store, ["x1", "x2"])
    store.save()
    _fill(store, ["x3"], seed=1)
    store.save()
    # wreck in-memory state, then recover from the latest generation
    assert store.recover(0, clear_on_failure=True)
    assert store.count() == 3
    assert store.get("x3") is not None


def test_old_layout_migrates_and_cleans_up(tmp_path):
    """An r4-era data_dir (in-place indices/ + metadata/ files) loads,
    and the first save migrates it to a generation checkpoint and
    removes the superseded old-layout files."""
    # Write the old layout exactly as the r4 save() did: component
    # saves directly into data_dir/indices and data_dir/metadata.
    store = _make(tmp_path)
    vecs = _fill(store, ["m1", "m2", "m3"])
    idx_dir = os.path.join(str(tmp_path), "indices")
    meta_dir = os.path.join(str(tmp_path), "metadata")
    for shard, index in enumerate(store.indices):
        path = os.path.join(idx_dir, f"shard_{shard}")
        index.save(path)
        with open(path + ".ids.json", "w") as f:
            json.dump(dict(store.registries[shard].items()), f)
    store.meta.save(meta_dir)

    re = _make(tmp_path)
    assert re.count() == 3
    got = re.get("m2")
    assert got is not None and got[1] == {"name": "m2"}
    np.testing.assert_allclose(got[0], vecs["m2"], atol=1e-3)

    re.save()  # migrates to checkpoint/g000001
    assert os.path.isdir(os.path.join(str(tmp_path), "checkpoint"))
    assert not os.path.exists(
        os.path.join(idx_dir, "shard_0.meta.json")
    ), "old-layout index files must be cleaned up after migration"
    assert not os.path.exists(
        os.path.join(meta_dir, "columns_shard0.npz")
    )
    re2 = _make(tmp_path)
    assert re2.count() == 3 and re2.get("m1") is not None


def test_generations_are_garbage_collected(tmp_path):
    store = _make(tmp_path)
    _fill(store, ["x1"])
    for _ in range(4):
        store.save()
    root = os.path.join(str(tmp_path), "checkpoint")
    gens = [n for n in os.listdir(root) if n.startswith("g")]
    assert len(gens) == 1, f"stale generations not GC'd: {gens}"


def test_failed_slab_restore_poisons_shard_not_checkpoint(tmp_path):
    """A recover() whose slab restore fails (raw store lost rows under
    a slab-external checkpoint) must not leave a checkpoint/registry
    hybrid serving garbage, and save() must refuse to overwrite — and
    GC — the last complete generation with the resulting empty state."""
    store = _make(
        tmp_path,
        INDEX_DTYPE="int8",
        RAW_STORE="memmap",
        RAW_STORE_DTYPE="int8",
    )
    _fill(store, [f"p{i}" for i in range(32)])
    store.save()
    root = os.path.join(str(tmp_path), "checkpoint")
    gens_before = sorted(n for n in os.listdir(root) if n.startswith("g"))

    # damage the raw store: truncate the row file so restore_slab
    # cannot refill the slab-external checkpoint
    raw_bin = os.path.join(str(tmp_path), "vectors", "raw_shard0.bin")
    assert os.path.exists(raw_bin)
    with open(raw_bin, "r+b") as f:
        f.truncate(8)
    store.raws._rfds.clear()
    store.raws._rows[0] = None  # drop the mapped view of the old size
    store.raws._caps[0] = 0

    assert store.recover(0) is False
    # no garbage serving: the shard is empty, not a hybrid
    assert store.count() == 0
    with pytest.raises(RuntimeError, match="failed-recovery"):
        store.save()
    gens_after = sorted(n for n in os.listdir(root) if n.startswith("g"))
    assert gens_after == gens_before, "good generation must survive"
    # explicit clear() lifts the poison (declares empty intentional)
    store.clear()
    store.save()


def test_rawstore_dense_fastpath_rejects_duplicates(tmp_path):
    from wdbx_tpu_torch.store.rawstore import RawStore

    rs = RawStore(str(tmp_path), num_shards=1, dim=4,
                  dtype="int8", backend="mmap")
    rows = np.arange(32, dtype=np.float32).reshape(8, 4) + 1
    rs.write(0, np.arange(8), rows)
    q, s, have = rs.read_native(0, np.asarray([5, 5, 7]))
    assert have.all()
    got = q.astype(np.float32) * s[:, None]
    np.testing.assert_allclose(got[0], got[1], atol=1e-6)
    np.testing.assert_allclose(
        got[2] / np.abs(got[2]).max(), rows[7] / np.abs(rows[7]).max(),
        atol=0.02,
    )
