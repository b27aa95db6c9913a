"""The generator makes the same inputs from the same seed, and other
inputs from another seed; every seed brings the same amount of work."""

import numpy as np
import torch

from portbench import loops
from portbench.reference.mixture import Mixture, sub_seed


def _mix(seed):
    return Mixture(seed, 16, 768, 0.67, 1000, "cpu")


def test_same_seed_same_corpus_and_queries(seed):
    a, b = _mix(seed), _mix(seed)
    for (lo_a, xa), (lo_b, xb) in zip(a.chunks(2500), b.chunks(2500)):
        assert lo_a == lo_b
        assert torch.equal(xa, xb)
    assert torch.equal(a.queries(64), b.queries(64))
    # a chunk regenerated alone is the chunk of the whole pass
    assert torch.equal(a.chunk(2, 2500), list(b.chunks(2500))[2][1])


def test_other_seed_other_corpus(seed):
    a, b = _mix(seed), _mix(seed + 1)
    assert not torch.equal(a.chunk(0, 2500), b.chunk(0, 2500))
    assert not torch.equal(a.queries(8), b.queries(8))


def test_rows_are_unit_and_chunks_cover_the_corpus(seed):
    m = _mix(seed)
    got = list(m.chunks(2500))
    assert [lo for lo, _ in got] == [0, 1000, 2000]
    assert sum(x.shape[0] for _, x in got) == 2500
    norms = torch.cat([x for _, x in got]).norm(dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)


def test_sub_seed_takes_seeds_wider_than_64_bits():
    assert sub_seed(2**64 + 3, 1) == sub_seed(3, 1)
    assert sub_seed(2**33, 1) != sub_seed(2**33 + 1, 1)
    assert 0 <= sub_seed(2**40, 2, 5) < 2**63


def test_batches_cover_the_pool_in_a_seeded_order(seed):
    traffic = {"batch": 32}
    b1 = loops.batches(traffic, seed, 256)
    assert len(b1) == 8 and all(len(b) == 32 for b in b1)
    assert sorted(np.concatenate(b1).tolist()) == list(range(256))
    b2 = loops.batches(traffic, seed + 1, 256)
    assert not all(np.array_equal(x, y) for x, y in zip(b1, b2))
