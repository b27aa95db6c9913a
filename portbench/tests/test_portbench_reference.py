"""The plain reference agrees with a numpy brute force, and the check
reads its numbers from it as ``check.py`` says."""

import numpy as np
import pytest
import torch

from portbench import check, loops
from portbench.reference.exact import Reference
from portbench.reference.mixture import Mixture


def _brute(x, q, k):
    x = x / np.linalg.norm(x, axis=1, keepdims=True)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    s = q.astype(np.float64) @ x.astype(np.float64).T
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, idx, 1), idx, s


@pytest.fixture
def small(seed):
    mix = Mixture(seed, 8, 768, 0.67, 700, "cpu")
    x = torch.cat([c for _, c in mix.chunks(3000)]).numpy()
    return mix, x, mix.queries(40)


def test_exact_top10_matches_numpy(small):
    mix, x, q = small
    rows = np.array([5, 17, 2999, 1234]), np.array([0, 3, 39, 7])
    ref = Reference(q, 10, block=512).run(mix.chunks(3000), rows[1], rows[0])
    want_v, want_i, s = _brute(x, q.numpy(), 10)
    assert np.array_equal(ref["top_i"], want_i)
    assert np.allclose(ref["top_v"], want_v, atol=2e-6)
    assert np.allclose(ref["pair_score"], s[rows[1], rows[0]], atol=2e-6)


def test_check_numbers_on_a_hand_made_answer():
    top_v = np.array([[0.9, 0.8, 0.7]])
    top_i = np.array([[3, 1, 2]])
    ids = np.array([[3, 2, 5]])
    exact = np.array([[0.9, 0.7, 0.6]])
    scores = np.array([[0.9001, 0.7, 0.61]])
    got = check.numbers(np.array([0]), ids, scores, exact, top_v, top_i)
    assert got["score_err"] == pytest.approx(0.01)
    assert got["rank_gap"] == pytest.approx(0.1)
    assert got["rank_gap_mean"] == pytest.approx((0.0 + 0.1 + 0.1) / 3)
    assert got["recall"] == pytest.approx(2 / 3)


def test_answers_flag_malformed_rows():
    good = [("4", 0.9, {}), ("2", 0.8, {}), ("1", 0.7, {})]
    hits = [good, good[:2], [("4", 0.9, {}), ("4", 0.8, {}), ("1", 0.7, {})],
            [("x", 0.9, {})] + good[1:], list(reversed(good)), [None]]
    answers = check.Answers([0] * 6, [loops.compact(h) for h in hits], 3, 10)
    assert answers.ok.tolist() == [True] + [False] * 5
    q, r = answers.pairs()
    assert q.tolist() == [0, 0, 0] and r.tolist() == [1, 2, 4]
