"""The cases of ``tests/test_filter_truth_table.py`` on the port, on the CPU.

A translated copy of that file: the same classes, functions,
parametrisations and asserts, run on ``wdbx_tpu_torch``. Each
``wdbx_tpu`` import names its ``wdbx_tpu_torch`` counterpart; the
autouse fixture asks for the CPU through
``test_torch_ops.port_on_cpu`` (the default device and mesh of one
test), so the package keeps the card as its own default.

Translated, every case (42 cases):
test_matches_filter_truth_table; test_columnar_mask_truth_table;
test_columnar_mask_typed_int_column; test_columnar_mask_unseen_column;
test_store_end_to_end_truth_table.

Changed beyond the imports and the fixture: nothing. Left out: nothing.

The reference file's description:

Filter-operator truth table (VERDICT r4 ask #2).

Expected verdicts below are LITERALS derived by hand from the
reference's code (reference wdbx/core/vector_store.py:429-461), NOT
computed by calling ``matches_filter`` — so this table can catch a bug
shared between the implementation and a derived model. Reference
semantics per clause:

  * ``$gt/$gte/$lt/$lte``: ``key not in metadata`` -> fail; else
    compare (reference :437-447). Mixed-type comparison RAISES in the
    reference (uncaught TypeError at :439); we define it as a
    clause-fail — the one documented divergence in this table.
  * ``$in``: missing -> fail; else Python ``in`` (cross-type ``==`` is
    False, never raises) — reference :447-449.
  * ``$nin``: ``if key in metadata and metadata[key] in op_value:
    fail`` — so a MISSING key PASSES — reference :450-452.
  * ``$exists``: pass iff presence == bool(operand) — reference
    :453-457.
  * equality: missing -> fail; else ``==`` — reference :459-461.

Each case is checked through every filter engine in the repo:
``matches_filter`` (host post-filter), ``ColumnarMetadata.mask``
(vectorized pre-filter, typed and object columns), and the full store
in FILTER_MODE=pre and FILTER_MODE=post.
"""

import numpy as np
import pytest

from wdbx_tpu_torch.core.config import WDBXConfig
from wdbx_tpu_torch.store.filters import matches_filter
from wdbx_tpu_torch.store.metastore import ColumnarMetadata
from wdbx_tpu_torch.store.vector_store import VectorStore
from test_torch_ops import port_on_cpu


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    port_on_cpu(monkeypatch)

# Row shapes: key "k" missing / int 3 / int 5 / str "a" / str "b".
ROWS = [
    {},            # missing
    {"k": 3},      # numeric, will match most "match" cases
    {"k": 5},      # numeric non-match
    {"k": "a"},    # mixed type vs numeric operands
    {"k": "b"},    # string that appears in $in/$nin lists
]

# (filter, [verdict per row above]) — verdicts are hand-derived
# literals, in ROWS order: [missing, k=3, k=5, k="a", k="b"].
TRUTH = [
    ({"k": {"$gt": 4}},            [False, False, True, False, False]),
    ({"k": {"$gte": 5}},           [False, False, True, False, False]),
    ({"k": {"$lt": 4}},            [False, True, False, False, False]),
    ({"k": {"$lte": 3}},           [False, True, False, False, False]),
    ({"k": {"$in": [3, "b"]}},     [False, True, False, False, True]),
    # missing key PASSES $nin (reference :450-452)
    ({"k": {"$nin": [3, "b"]}},    [True, False, True, True, False]),
    ({"k": {"$nin": []}},          [True, True, True, True, True]),
    ({"k": {"$exists": True}},     [False, True, True, True, True]),
    ({"k": {"$exists": False}},    [True, False, False, False, False]),
    ({"k": 3},                     [False, True, False, False, False]),
    ({"k": "a"},                   [False, False, False, True, False]),
    # multi-operator clause: AND of the two operator verdicts
    ({"k": {"$gt": 1, "$lt": 4}},  [False, True, False, False, False]),
    # $nin AND $gt in one clause: missing passes $nin but fails $gt
    ({"k": {"$nin": [5], "$gt": 1}}, [False, True, False, False, False]),
]

IDS = [f"case{i}" for i in range(len(TRUTH))]


@pytest.mark.parametrize("flt,want", TRUTH, ids=IDS)
def test_matches_filter_truth_table(flt, want):
    got = [matches_filter(row, flt) for row in ROWS]
    assert got == want, f"filter={flt}: got {got}, want {want}"


def _columnar(rows):
    meta = ColumnarMetadata(1)
    for slot, row in enumerate(rows):
        meta.set(0, slot, row)
    return meta


@pytest.mark.parametrize("flt,want", TRUTH, ids=IDS)
def test_columnar_mask_truth_table(flt, want):
    # mixed rows force the "k" column to promote to an object column
    meta = _columnar(ROWS)
    got = meta.mask(0, flt, len(ROWS)).tolist()
    assert got == want, f"obj column, filter={flt}: got {got}, want {want}"


@pytest.mark.parametrize("flt,want", TRUTH, ids=IDS)
def test_columnar_mask_typed_int_column(flt, want):
    """Same table against a TYPED int column (no promotion): rows with
    string values are replaced by missing rows, so expected verdicts
    are the missing-key verdicts for those rows."""
    rows = [r if not isinstance(r.get("k"), str) else {} for r in ROWS]
    want = [
        w if not isinstance(r.get("k"), str) else want[0]
        for r, w in zip(ROWS, want)
    ]
    meta = _columnar(rows)
    got = meta.mask(0, flt, len(rows)).tolist()
    assert got == want, f"int column, filter={flt}: got {got}, want {want}"


def test_columnar_mask_unseen_column():
    """A key no row ever carried: whole-shard missing-key verdicts."""
    meta = _columnar([{"other": 1}, {"other": 2}])
    assert meta.mask(0, {"k": {"$nin": [1]}}, 2).tolist() == [True, True]
    assert meta.mask(0, {"k": {"$in": [1]}}, 2).tolist() == [False, False]
    assert meta.mask(0, {"k": {"$exists": False}}, 2).tolist() == [True, True]
    assert meta.mask(0, {"k": {"$gt": 0}}, 2).tolist() == [False, False]


@pytest.mark.parametrize("mode", ["pre", "post"])
def test_store_end_to_end_truth_table(tmp_path, mode):
    """The full store path returns exactly the passing rows in both
    filter modes (limit >= corpus so post-filter truncation is moot)."""
    dim = 8
    store = VectorStore(WDBXConfig({
        "VECTOR_DIMENSION": dim,
        "DATA_DIR": str(tmp_path),
        "VECTOR_STORE_AUTOSAVE_INTERVAL": 0,
        "INDEX_TYPE": "flat",
        "FILTER_MODE": mode,
    }))
    r = np.random.default_rng(0)
    ids = []
    for i, row in enumerate(ROWS):
        vid = f"r{i}"
        v = r.standard_normal(dim).astype(np.float32)
        store.store(vid, v / np.linalg.norm(v), row)
        ids.append(vid)
    q = r.standard_normal((1, dim)).astype(np.float32)
    q /= np.linalg.norm(q)
    for flt, want in TRUTH:
        hits = store.search_batch(q, limit=len(ROWS), filter_metadata=flt)[0]
        got_ids = sorted(h[0] for h in hits)
        want_ids = sorted(vid for vid, w in zip(ids, want) if w)
        assert got_ids == want_ids, (
            f"mode={mode} filter={flt}: got {got_ids}, want {want_ids}"
        )
