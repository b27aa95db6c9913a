"""The cases of ``tests/test_store_fuzz.py`` on the port, on the CPU.

A translated copy of that file: the same classes, functions,
parametrisations and asserts, run on ``wdbx_tpu_torch``. Each
``wdbx_tpu`` import names its ``wdbx_tpu_torch`` counterpart; the
autouse fixture asks for the CPU through
``test_torch_ops.port_on_cpu`` (the default device and mesh of one
test), so the package keeps the card as its own default.

Translated, every case (6 cases):
test_store_differential_random_ops; test_store_differential_sharded;
test_store_differential_pipelined_and_generations.

Changed beyond the imports and the fixture: nothing. Left out: nothing.

The reference file's description:

Store-level differential fuzz (VERDICT r4 ask #9).

The index-layer fuzz (tests/test_clustered.py) checks slot bookkeeping;
this one checks the STORE around it — id registry, columnar metadata,
memmap raw store, exact re-rank, filter masks, persistence — against a
naive Python model (dict of id -> (vector, metadata)), the semantics of
the reference store (reference wdbx/core/vector_store.py:136-463).

Exactness contract: the index slab is int8 (so the re-rank path is
live), the raw store keeps f32, and the re-rank fetch factor covers the
whole corpus — so every search's candidate set is the full corpus and
the exact f32 re-rank must return the model's true top-k (scores within
float tolerance; ids checked through score equality so ties stay legal).
"""

import numpy as np
import pytest

from wdbx_tpu_torch.core.config import WDBXConfig
from wdbx_tpu_torch.store.vector_store import VectorStore
from test_torch_ops import port_on_cpu


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    port_on_cpu(monkeypatch)

_MISSING = object()


def _ref_matches(meta: dict, flt: dict | None) -> bool:
    """Independent model of the reference's filter semantics
    (reference wdbx/core/vector_store.py:429-461), implemented directly
    from its code — NOT wdbx_tpu.store.filters.matches_filter, so a bug
    shared with the implementation stays visible (VERDICT r4 ask #2).
    Divergence from the reference kept deliberately: mixed-type ordered
    comparison fails the clause instead of raising."""
    if not flt:
        return True
    for key, cond in flt.items():
        v = meta.get(key, _MISSING)
        if isinstance(cond, dict) and any(k.startswith("$") for k in cond):
            for op, e in cond.items():
                if op == "$exists":
                    if (v is not _MISSING) != bool(e):
                        return False
                elif op == "$nin":
                    if v is not _MISSING and v in e:
                        return False
                elif op == "$in":
                    if v is _MISSING or v not in e:
                        return False
                else:
                    if v is _MISSING:
                        return False
                    try:
                        ok = {"$gt": v > e, "$gte": v >= e,
                              "$lt": v < e, "$lte": v <= e}[op]
                    except TypeError:
                        ok = False
                    if not ok:
                        return False
        elif v is _MISSING or v != cond:
            return False
    return True


def _make(tmp_path, **over):
    cfg = {
        "VECTOR_DIMENSION": 8,
        "DATA_DIR": str(tmp_path),
        "VECTOR_STORE_AUTOSAVE_INTERVAL": 0,
        "INDEX_TYPE": "flat",
        "INDEX_DTYPE": "int8",       # quantized slab -> re-rank engages
        "RAW_STORE": "memmap",
        "RAW_STORE_DTYPE": "float32",  # exact re-rank source
        "RERANK_FETCH_FACTOR": 96,   # limit*96 >= corpus: full coverage
    }
    cfg.update(over)
    return VectorStore(WDBXConfig(cfg))


# a pool of filters exercising typed + mixed + operator clauses
FILTERS = [
    None,
    {"cat": "a"},
    {"num": {"$gt": 5}},
    {"num": {"$in": [1, 3, 5, 7]}},
    {"cat": {"$in": ["a", 2]}},          # mixed-type $in (r4 fix)
    {"num": {"$nin": [0, 2, 4]}},
    {"flag": {"$nin": [True]}},          # missing key PASSES $nin (r5 fix)
    {"flag": {"$exists": True}},
    {"flag": {"$exists": False}},
    {"cat": "a", "num": {"$lte": 7}},
]


def _rand_meta(r) -> dict:
    meta = {
        "cat": ("a", "b", 2)[int(r.integers(0, 3))],
        "num": int(r.integers(0, 10)),
    }
    if r.random() < 0.3:
        meta["flag"] = bool(r.integers(0, 2))
    return meta


@pytest.mark.parametrize("seed", [11, 23, 47])
def test_store_differential_random_ops(tmp_path, seed):
    r = np.random.default_rng(seed)
    dim = 8
    store = _make(tmp_path)
    model: dict[str, tuple[np.ndarray, dict]] = {}
    next_id = 0
    trace: list[str] = []

    def rand_vec(n):
        v = r.standard_normal((n, dim)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    def check():
        q = rand_vec(2)
        flt = FILTERS[int(r.integers(0, len(FILTERS)))]
        limit = int(r.integers(1, 5))
        got = store.search_batch(q, limit=limit, filter_metadata=flt)
        for qi, hits in zip(q, got):
            passing = {
                vid: (vec, meta) for vid, (vec, meta) in model.items()
                if flt is None or _ref_matches(meta, flt)
            }
            want_n = min(limit, len(passing))
            assert len(hits) == want_n, (
                f"{len(hits)} hits, want {want_n}; filter={flt}; "
                f"trace={trace[-12:]}"
            )
            if not passing:
                continue
            exact = np.sort(
                [float(qi @ v / max(np.linalg.norm(v), 1e-12))
                 for v, _ in passing.values()]
            )[::-1][:want_n]
            for rank, hit in enumerate(hits):
                vid, score, meta = hit[0], hit[1], hit[2]
                # (a) id is live and passes the filter
                assert vid in passing, (
                    f"ghost/filtered id {vid!r}; filter={flt}; "
                    f"trace={trace[-12:]}"
                )
                mvec, mmeta = model[vid]
                # (b) metadata pairing is this id's own metadata
                assert meta == mmeta, (
                    f"metadata mispair for {vid!r}: {meta} != {mmeta}; "
                    f"trace={trace[-12:]}"
                )
                # (c) the reported score is this id's exact score
                true_s = float(
                    qi @ mvec / max(np.linalg.norm(mvec), 1e-12)
                )
                assert abs(score - true_s) < 5e-3, (
                    f"score mismatch for {vid!r}: {score} vs {true_s}; "
                    f"trace={trace[-12:]}"
                )
                # (d) rank-r score equals the model's rank-r score
                assert abs(score - exact[rank]) < 5e-3, (
                    f"rank-{rank} score {score} != exact {exact[rank]}; "
                    f"filter={flt}; trace={trace[-12:]}"
                )

    for step in range(50):
        op = r.random()
        if op < 0.30 or not model:  # insert (sometimes overwrite)
            if model and r.random() < 0.25:
                vid = list(model)[int(r.integers(0, len(model)))]
            else:
                vid = f"v{next_id}"
                next_id += 1
            vec, meta = rand_vec(1)[0], _rand_meta(r)
            store.store(vid, vec, meta)
            model[vid] = (vec, meta)
            trace.append(f"store {vid}")
        elif op < 0.45:  # bulk_load fresh ids
            m = int(r.integers(2, 20))
            ids = [f"v{next_id + i}" for i in range(m)]
            next_id += m
            vecs = rand_vec(m)
            metas = [_rand_meta(r) for _ in range(m)]
            store.bulk_load(ids, vecs, metadata_columns={
                k: [mt.get(k) for mt in metas]
                for k in ("cat", "num")
            })
            for i, vid in enumerate(ids):
                # bulk columns carry cat+num only; mirror that
                model[vid] = (
                    vecs[i],
                    {k: metas[i][k] for k in ("cat", "num")},
                )
            trace.append(f"bulk {m}")
        elif op < 0.60:  # batch_store: mix of updates + inserts
            m = int(r.integers(1, 6))
            batch, metas = {}, {}
            for _ in range(m):
                if model and r.random() < 0.5:
                    vid = list(model)[int(r.integers(0, len(model)))]
                else:
                    vid = f"v{next_id}"
                    next_id += 1
                vec, meta = rand_vec(1)[0], _rand_meta(r)
                batch[vid] = vec
                metas[vid] = meta
            store.batch_store(batch, metas)
            for vid, vec in batch.items():
                model[vid] = (np.asarray(vec), metas[vid])
            trace.append(f"batch {sorted(batch)}")
        elif op < 0.75 and model:  # delete
            vid = list(model)[int(r.integers(0, len(model)))]
            assert store.delete(vid)
            del model[vid]
            trace.append(f"del {vid}")
        elif op < 0.85 and model:  # update_metadata
            vid = list(model)[int(r.integers(0, len(model)))]
            meta = _rand_meta(r)
            assert store.update_metadata(vid, meta)
            model[vid] = (model[vid][0], meta)
            trace.append(f"meta {vid}")
        else:  # save + reload (fresh store object, same dir)
            store.save()
            store = _make(tmp_path)
            trace.append("save/reload")
        if step % 3 == 0:
            check()
    check()
    # final integrity: every model id resolves with its exact row+meta
    assert store.count() == len(model)
    for vid, (vec, meta) in model.items():
        got = store.get(vid)
        assert got is not None, f"{vid} lost; trace={trace[-12:]}"
        np.testing.assert_allclose(got[0], vec, atol=2e-2)
        assert got[1] == meta


@pytest.mark.parametrize("seed", [5])
def test_store_differential_sharded(tmp_path, seed):
    """Same contract across 3 hash shards (registry fan-out, per-shard
    masks, cross-shard merge ordering)."""
    r = np.random.default_rng(seed)
    store = _make(tmp_path, NUM_SHARDS=3)
    model: dict[str, tuple[np.ndarray, dict]] = {}
    vecs = r.standard_normal((120, 8)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
    metas = [_rand_meta(r) for _ in range(120)]
    store.bulk_load(
        [f"s{i}" for i in range(120)], vecs,
        metadata_columns={
            k: [mt.get(k) for mt in metas] for k in ("cat", "num")
        },
    )
    for i in range(120):
        model[f"s{i}"] = (vecs[i], {k: metas[i][k] for k in ("cat", "num")})
    for i in range(0, 120, 7):  # churn a third
        if i % 2:
            store.delete(f"s{i}")
            del model[f"s{i}"]
        else:
            nv = r.standard_normal(8).astype(np.float32)
            nv /= np.linalg.norm(nv)
            nm = _rand_meta(r)
            store.store(f"s{i}", nv, nm)
            model[f"s{i}"] = (nv, nm)
    store.save()
    store = _make(tmp_path, NUM_SHARDS=3)
    q = r.standard_normal((4, 8)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    for flt in FILTERS:
        got = store.search_batch(q, limit=5, filter_metadata=flt)
        for qi, hits in zip(q, got):
            passing = {
                vid: v for vid, (v, mt) in model.items()
                if flt is None or _ref_matches(mt, flt)
            }
            assert len(hits) == min(5, len(passing)), (flt, len(hits))
            if not passing:
                continue
            exact = np.sort([float(qi @ v) for v in passing.values()]
                            )[::-1][:len(hits)]
            for rank, hit in enumerate(hits):
                assert hit[0] in passing, (flt, hit[0])
                assert abs(hit[1] - exact[rank]) < 5e-3, (
                    flt, rank, hit[1], exact[rank])


@pytest.mark.parametrize("seed", [7, 19])
def test_store_differential_pipelined_and_generations(tmp_path, seed):
    """r5 surfaces under random ops: submit/resolve handles racing
    mutations (resolve must re-run, never mispair), generation saves
    interleaved with churn, and a clustered engine rebuilding under the
    mutations (serve-through). Model = independent _ref_matches."""
    r = np.random.default_rng(seed)
    dim = 8
    store = _make(
        tmp_path, INDEX_TYPE="ivf_clustered", IVF_NLIST=8,
        IVF_TRAIN_THRESHOLD=64, IVF_NPROBE=8,
    )
    model: dict[str, tuple[np.ndarray, dict]] = {}
    next_id = 0
    pending: list[tuple] = []  # (handle, queries, limit)

    def rand_vec(n):
        v = r.standard_normal((n, dim)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    def check_resolved(handle, q, limit, label):
        got = store.search_batch_resolve(handle)
        for qi, hits in zip(q, got):
            # every hit must be a LIVE id whose metadata is its own
            for vid, score, meta in hits:
                assert vid in model, f"{label}: ghost id {vid!r}"
                mvec, mmeta = model[vid]
                assert meta == mmeta, f"{label}: metadata mispair {vid!r}"
                true_s = float(qi @ mvec / max(np.linalg.norm(mvec), 1e-12))
                assert abs(score - true_s) < 5e-3, (
                    f"{label}: stale score for {vid!r}"
                )
            assert len(hits) == min(limit, len(model))

    for step in range(60):
        op = r.random()
        if op < 0.35 or not model:
            m = int(r.integers(1, 8))
            batch, metas = {}, {}
            for _ in range(m):
                if model and r.random() < 0.3:
                    vid = list(model)[int(r.integers(0, len(model)))]
                else:
                    vid = f"p{next_id}"
                    next_id += 1
                vec, meta = rand_vec(1)[0], _rand_meta(r)
                batch[vid], metas[vid] = vec, meta
            store.batch_store(batch, metas)
            for vid, vec in batch.items():
                model[vid] = (np.asarray(vec), metas[vid])
        elif op < 0.50 and model:
            vid = list(model)[int(r.integers(0, len(model)))]
            assert store.delete(vid)
            del model[vid]
        elif op < 0.65:
            # submit now, mutate before resolving (below): the epoch
            # retry must keep results consistent with the LIVE state
            q = rand_vec(2)
            limit = int(r.integers(1, 5))
            pending.append((store.search_batch_submit(q, limit=limit),
                            q, limit))
        elif op < 0.80:
            store.save()  # a new generation mid-churn
        elif op < 0.90:
            store.optimize()  # clustered rebuild under the ops
        else:
            store.save()
            store = _make(
                tmp_path, INDEX_TYPE="ivf_clustered", IVF_NLIST=8,
                IVF_TRAIN_THRESHOLD=64, IVF_NPROBE=8,
            )
            pending.clear()  # handles die with their store
        # resolve one aged handle against the CURRENT model
        if pending and r.random() < 0.6:
            handle, q, limit = pending.pop(0)
            check_resolved(handle, q, limit, f"step{step}")
    for handle, q, limit in pending:
        check_resolved(handle, q, limit, "drain")
    # final: registry and model agree after all generations
    assert store.count() == len(model)
    for vid, (vec, meta) in model.items():
        got = store.get(vid)
        assert got is not None and got[1] == meta
        np.testing.assert_allclose(got[0], vec, atol=2e-2)
