"""The clustered engine behind the port's facade, on the CPU: INDEX_TYPE
routing, and WDBX(INDEX_TYPE="ivf") parity with wdbx_tpu.

Every alias that serves through the clustered engine in the JAX package
(``ivf`` with IVF_ASSIGNMENTS <= 1, ``hnsw``, faiss ``IVF...`` and
``ivf_clustered``) builds the port's ClusteredIVFIndex with the same
nlist, nprobe and kernel knobs; ``ivf_dense`` and ``ivf`` with
IVF_ASSIGNMENTS >= 2 build the port's dense IVFIndex.
At full probe (IVF_NPROBE = IVF_NLIST) the block scan is exact, so the
two facades must name the same ids whatever their k-means picked.
"""

import numpy as np
import pytest
import torch

from test_torch_store import _same_hits
from wdbx_tpu.core.wdbx import WDBX as JWDBX
from wdbx_tpu.index import create_index as j_create
from wdbx_tpu_torch.core.wdbx import WDBX as TWDBX
from wdbx_tpu_torch.index import create_index as t_create
from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex
from wdbx_tpu_torch.index.ivf import IVFIndex

torch.set_num_threads(2)

DIM = 16
KNOBS = {"IVF_KERNEL_VERSION": "v1", "IVF_KERNEL_QPREC": "int8",
         "IVF_RECYCLE_HOLES": False, "KERNEL_K_MAX": 64,
         "IVF_BACKGROUND_REBUILD": True, "IVF_NLIST": 32, "IVF_NPROBE": 6,
         "IVF_TRAIN_THRESHOLD": 500, "IVF_REBUILD_FRACTION": 0.3}


@pytest.mark.parametrize("kind,extra", [
    ("ivf", {}),
    ("ivf_clustered", {}),
    ("hnsw", {"HNSW_EF_SEARCH": 120}),
    ("faiss", {"FAISS_INDEX_TYPE": "IVF64,Flat"}),
])
def test_clustered_aliases_route_like_jax(kind, extra):
    cfg = dict(KNOBS, **extra)
    j = j_create(kind, DIM, cfg)
    t = t_create(kind, DIM, cfg, device="cpu")
    assert isinstance(t, ClusteredIVFIndex) and t.kind == j.kind
    for attr in ("nlist", "nprobe", "train_threshold", "rebuild_fraction",
                 "background_rebuild", "kernel_version", "kernel_qprec",
                 "recycle_holes", "KERNEL_K_MAX"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.device == torch.device("cpu")


@pytest.mark.parametrize("kind,extra", [("ivf_dense", {}),
                                        ("ivf", {"IVF_ASSIGNMENTS": 2})])
def test_dense_ivf_raises_naming_slice_4(kind, extra):
    """(Named for the slice that ported it.) The dense-table aliases
    build the port's IVFIndex with JAX's attributes."""
    cfg = dict(KNOBS, **extra)
    j = j_create(kind, DIM, cfg)
    t = t_create(kind, DIM, cfg, device="cpu")
    assert isinstance(t, IVFIndex) and not isinstance(t, ClusteredIVFIndex)
    for attr in ("kind", "assignments", "nlist", "nprobe", "train_threshold",
                 "rebuild_fraction"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.device == torch.device("cpu")


def _open(pkg, path, dtype, nlist=8):
    cfg = {"INDEX_TYPE": "ivf", "IVF_NLIST": nlist, "IVF_NPROBE": nlist,
           "IVF_TRAIN_THRESHOLD": 256, "INDEX_DTYPE": dtype,
           "VECTOR_STORE_AUTOSAVE_INTERVAL": 0}
    if dtype == "int8":
        cfg["RAW_STORE"] = "ram"  # exact rerank of the int8 hits
    kw = {"device": "cpu"} if pkg is TWDBX else {}
    return pkg(vector_dimension=DIM, num_shards=2, data_dir=str(path),
               config=cfg, enable_plugins=False, **kw)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("int8", 1e-5)])
def test_ivf_facade_matches_at_full_probe(tmp_path, rng, dtype, tol):
    n = 1200
    ids = [f"v{i}" for i in range(n)]
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    cols = {"tag": np.arange(n) % 4, "n": np.arange(n)}
    dbs = [_open(JWDBX, tmp_path / "j", dtype),
           _open(TWDBX, tmp_path / "t", dtype)]
    for db in dbs:
        for index in db.store.indices:
            # 256-row blocks and no flat fallback: the block scan serves
            index.block_bytes_target = 1
            index.batch_flat_fallback = False
        assert db.store.bulk_load(ids, x, cols) == n
        db.optimize()
    j, t = dbs
    for index in t.store.indices:
        assert isinstance(index, ClusteredIVFIndex) and index.is_trained
        assert index.device == torch.device("cpu") and index._c == 256
        index.ivf_kernel = "pallas"  # the kernel path, in its plain version
    q = rng.standard_normal((8, DIM)).astype(np.float32)
    # unfiltered, pushdown (25%) and the exact masked route (< 2%)
    for flt in (None, {"tag": 1}, {"n": {"$lt": 15}}):
        _same_hits(j.vector_search_batch(q, limit=10, filter_metadata=flt),
                   t.vector_search_batch(q, limit=10, filter_metadata=flt),
                   tol)
    _same_hits([j.vector_search(x[3].tolist(), limit=5)],
               [t.vector_search(x[3].tolist(), limit=5)], tol)
    # mutations reach the residual / quarantine paths of both
    for db in dbs:
        for vid in ids[:20]:
            assert db.delete_vector(vid)
        db.batch_store({"new0": x[0] * 2, "new1": -x[1]})
    _same_hits(j.vector_search_batch(x[:4], limit=10),
               t.vector_search_batch(x[:4], limit=10), tol)
    rj, rt = j.tune(0.9), t.tune(0.9)
    assert rt["achieved"] >= 0.9 and rj["achieved"] >= 0.9
