"""The one query path of the port's engines (``VectorIndex`` in
``wdbx_tpu_torch/index/base.py``), on the CPU.

``search`` and ``search_pipelined`` plan, enqueue and collect through the
same hooks. For each of the six engines, trained and untrained (the IVF
engines below ``train_threshold``): one batch of a pipelined stack gives
what ``search`` gives for it where their plans agree (no mask, and a
corpus large enough that the batch flat fallback is not taken), a
pending result collected later equals the materialized one, and a stack
of three batches equals three calls of ``search``. The per-engine
pipelined cases, held against the JAX package, stay in their own files.
"""

import numpy as np
import pytest
import torch

from test_torch_clustered import mixture
from wdbx_tpu_torch.index.base import Pending
from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex
from wdbx_tpu_torch.index.flat import FlatIndex
from wdbx_tpu_torch.index.ivf import IVFIndex
from wdbx_tpu_torch.parallel import (
    ShardedClusteredIndex,
    ShardedFlatIndex,
    ShardedIVFIndex,
    make_mesh,
)

torch.set_num_threads(2)

D, N, B, K = 32, 32768, 4, 10


def _ivf_kw(trained):
    return dict(nlist=64, nprobe=2,
                train_threshold=256 if trained else 1 << 30)


def _make(engine, trained):
    mesh = make_mesh(2, device="cpu")
    if engine == "flat":
        return FlatIndex(D, device="cpu")
    if engine == "sharded_flat":
        return ShardedFlatIndex(D, mesh=mesh, device="cpu")
    if engine == "ivf":
        return IVFIndex(D, device="cpu", **_ivf_kw(trained))
    if engine == "sharded_ivf":
        return ShardedIVFIndex(D, mesh=mesh, device="cpu",
                               **_ivf_kw(trained))
    cls = ClusteredIVFIndex if engine == "clustered" else \
        ShardedClusteredIndex
    extra = {} if engine == "clustered" else {"mesh": mesh}
    idx = cls(D, device="cpu", **extra, **_ivf_kw(trained))
    idx.block_bytes_target = 1  # the smallest blocks: c = 256 rows
    return idx


CASES = [("flat", False), ("sharded_flat", False)] + [
    (engine, trained)
    for engine in ("ivf", "clustered", "sharded_ivf", "sharded_clustered")
    for trained in (True, False)
]
IDS = [f"{e}-{'trained' if t else 'untrained'}" for e, t in CASES]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def served(request):
    """A filled index and a (3, B, D) query stack of its corpus."""
    engine, trained = request.param
    rng = np.random.default_rng(7)
    idx = _make(engine, trained)
    x = mixture(rng, N)
    idx.add_batch(x)
    if trained:
        idx.build()
        assert idx.is_trained
        # the batch takes the engine's scan in both entry points
        assert not idx._plan(B, None).exact
    else:
        assert not getattr(idx, "is_trained", False)
        assert idx._plan(B, None).exact
    qstack = (x[rng.integers(0, N, 3 * B)]
              + 0.05 * rng.standard_normal((3 * B, D)).astype(np.float32))
    return idx, qstack.reshape(3, B, D)


def test_one_batch_of_a_stack_is_a_search(served):
    idx, qstack = served
    s1, i1 = idx.search_pipelined(qstack[:1], K)
    s, i = idx.search(qstack[0], K)
    assert s1.shape == (1, B, K) and i1.dtype == np.int64
    np.testing.assert_array_equal(i1[0], i)
    np.testing.assert_allclose(s1[0], s, rtol=0, atol=1e-6)


def test_pending_resolves_to_the_materialized_result(served):
    idx, qstack = served
    want = idx.search_pipelined(qstack, K)
    pending = idx.search_pipelined(qstack, K, materialize=False)
    assert isinstance(pending, Pending)
    assert isinstance(pending.scores, torch.Tensor)
    got = idx.resolve_pipelined(pending)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_a_stack_is_three_searches(served):
    idx, qstack = served
    s3, i3 = idx.search_pipelined(qstack, K)
    assert s3.shape == (3, B, K)
    for nb in range(3):
        s, i = idx.search(qstack[nb], K)
        np.testing.assert_array_equal(i3[nb], i)
        np.testing.assert_allclose(s3[nb], s, rtol=0, atol=1e-6)


def test_the_stack_refuses_a_flat_batch(served):
    idx, qstack = served
    with pytest.raises(ValueError, match=r"is not \(NB, B, 32\)"):
        idx.search_pipelined(qstack[0], K)
