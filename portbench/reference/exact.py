"""The plain reference: exact cosine top-k in float32, in blocks.

Plain PyTorch with TF32 off. It regenerates the corpus from the seed
(``mixture.Mixture``) block by block and keeps only a running top-k, so
a 10M x 768 corpus never has to be held whole. One pass gives:

* the exact float32 top-k of every query (scores and rows);
* the exact float32 score of every ``(query, row)`` pair asked for (the
  rows that the program answered with).

Nothing here imports the program or takes anything the program made.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

@contextlib.contextmanager
def no_tf32():
    """float32 products in true float32 for the enclosed block."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(prec)


def unit(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _merge(best_v, best_i, v, i, k):
    v = torch.cat([best_v, v], dim=1)
    i = torch.cat([best_i, i], dim=1)
    top, pos = torch.topk(v, k, dim=1)
    return top, torch.gather(i, 1, pos)


class Reference:
    """Exact search of ``queries`` over the chunks of a corpus."""

    def __init__(self, queries: torch.Tensor, k: int, block: int = 131_072,
                 pair_block: int = 65_536):
        self.q = unit(queries)
        self.k, self.block, self.pair_block = k, block, pair_block

    def run(self, chunks, pairs_q=None, pairs_row=None):
        """One pass over ``chunks`` (``(lo, rows)`` pairs, rows float32 on
        the queries' device). ``pairs_q`` / ``pairs_row`` (int64 numpy)
        name the pairs whose exact score is wanted. Returns numpy arrays:
        ``top_v``, ``top_i`` and ``pair_score``."""
        q, k, dev = self.q, self.k, self.q.device
        nq = q.shape[0]
        neg = torch.full((nq, k), float("-inf"), device=dev)
        none = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
        top_v, top_i = neg.clone(), none.clone()
        if pairs_q is None:
            pairs_q = pairs_row = np.zeros(0, np.int64)
        order = np.argsort(pairs_row, kind="stable")
        prow, pq = pairs_row[order], pairs_q[order]
        pair_score = np.full(len(prow), np.nan, np.float32)
        with no_tf32():
            for lo, rows in chunks:
                for a in range(0, rows.shape[0], self.block):
                    x = unit(rows[a:a + self.block])
                    base = lo + a
                    s = q @ x.T
                    v, i = torch.topk(s, min(k, x.shape[0]), dim=1)
                    top_v, top_i = _merge(top_v, top_i, v, i + base, k)
                    del s
                    self._pairs(x, base, prow, pq, pair_score)
        out = {"top_v": top_v.cpu().numpy(), "top_i": top_i.cpu().numpy(),
               "pair_score": np.empty_like(pair_score)}
        out["pair_score"][order] = pair_score
        return out

    def _pairs(self, x, base, prow, pq, out):
        """Exact scores of the pairs whose row lies in this block."""
        a, b = np.searchsorted(prow, [base, base + x.shape[0]])
        for s in range(a, b, self.pair_block):
            e = min(b, s + self.pair_block)
            r = torch.as_tensor(prow[s:e] - base, device=x.device)
            qi = torch.as_tensor(pq[s:e], device=x.device)
            out[s:e] = (self.q[qi] * x[r]).sum(dim=1).cpu().numpy()
