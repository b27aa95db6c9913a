"""The plain reference of the clustered IVF search over int8 codes.

The semantics the clustered engine serves, written out in plain PyTorch
(float32, TF32 off), over the engine's trained state as its data, the
way a model's reference takes the model's weights:

* the query is normalised (cosine) and the probe is the ``nprobe``
  centroids of highest float32 score;
* the candidates are every live row of a probed bucket (bucket ``p``
  holds the positions ``bucket_start[p]`` to ``bucket_start[p + 1]``)
  and every live residual row (added after the build);
* a candidate's score is (its int8 codes times its row scale) . the
  query rounded to bf16, the query type the configuration states;
* the answer is the top k.

``state_of`` reads the state out of a built index; nothing else here
touches the program, and nothing calls its search, probe, dedup or scan.
``compare`` holds answers to the reference: the engine scans whole
blocks, so it may also score rows of other buckets that share a block
with a probed one, and its answer may be better than the reference's,
never worse.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.exact import no_tf32, unit

#: the comparison's tolerance on a score, absolute (scores are cosines).
#: The engine's score and the reference's are the same float32 sum of
#: 768 exact products (bf16 query times int8 code) in another order,
#: then times the row scale: they differ by float32 rounding (2e-7 in
#: the CPU tests). A query rounded to int8 instead of bf16 moves a
#: score by up to ~1e-3, and a row scale changed by a part in a
#: thousand moves its scores by ~7e-4: both lie far outside 1e-5.
TOL = 1e-5


@dataclass
class IVFState:
    """A built clustered index's trained state, by slab position."""
    centroids: torch.Tensor     # (nlist, d) float32
    bucket_start: torch.Tensor  # (nlist + 1,) int64
    codes: torch.Tensor         # (cap, d) int8, shared with the index
    scales: torch.Tensor        # (cap,) float32, a copy
    live: torch.Tensor          # (cap,) bool, a copy
    residual: torch.Tensor      # (R,) int64 positions past the build
    label: torch.Tensor         # (cap,) int64 label of a position, -1 none

    def position_of(self, labels: torch.Tensor) -> torch.Tensor:
        """Positions of live labels (-1 for a label that names none)."""
        have = self.live & (self.label >= 0)
        n = int(self.label.max()) + 1 if have.any() else 0
        table = torch.full((max(n, 1),), -1, dtype=torch.int64,
                           device=self.label.device)
        pos = torch.nonzero(have).reshape(-1)
        table[self.label[pos]] = pos
        lab = labels.to(torch.int64)
        ok = (lab >= 0) & (lab < n)
        return torch.where(ok, table[lab.clamp(0, max(n - 1, 0))],
                           torch.full_like(lab, -1))


def state_of(index, label_of_slot=None) -> IVFState:
    """The trained state of a built clustered index over an int8 slab,
    read from its tensors: centroids (``_centroids``), bucket extents
    (``_bucket_start``), codes (``_slab``, not copied), row scales
    (``_scales``) and live flags (``_valid``) copied, residual positions
    (``_residual``) and the position -> slot map (``_slot_of``).
    ``label_of_slot`` (an int64 array by slot) relabels the slots, for
    instance with the corpus row of each slot's id; by default a
    position's label is its slot."""
    dev = index._slab.device
    if index._slab.dtype != torch.int8 or index._bucket_start is None:
        raise ValueError("state_of reads a built index over int8 codes")
    slot = np.asarray(index._slot_of, np.int64)
    if label_of_slot is None:
        label = slot
    else:
        table = np.asarray(label_of_slot, np.int64)
        ok = (slot >= 0) & (slot < len(table))
        label = np.where(ok, table[np.clip(slot, 0, len(table) - 1)], -1)
    return IVFState(
        centroids=index._centroids.to(torch.float32).clone(),
        bucket_start=torch.as_tensor(np.asarray(index._bucket_start),
                                     dtype=torch.int64, device=dev),
        codes=index._slab,
        scales=index._scales.to(torch.float32).clone(),
        live=index._valid.clone(),
        residual=torch.as_tensor(np.asarray(index._residual, np.int64),
                                 device=dev),
        label=torch.as_tensor(label, device=dev),
    )


def _query(state: IVFState, queries) -> tuple[torch.Tensor, torch.Tensor]:
    """The unit queries in float32 (for the probe) and rounded to bf16
    (for the scores), on the state's device."""
    q = unit(torch.as_tensor(queries, device=state.codes.device))
    return q, q.to(torch.bfloat16).to(torch.float32)


def flips(q: torch.Tensor) -> torch.Tensor:
    """Where the bf16 rounding of the unit query is not fixed by the
    semantics: a float32 component within ``WINDOW`` float32 ulps of the
    midpoint between its two bf16 neighbours may round either way in a
    normalisation that differs from ``unit`` in its last bits (the
    engine multiplies by a reciprocal square root on the device). Gives
    the other rounding less the one taken there, 0 elsewhere."""
    qb = q.to(torch.bfloat16).to(torch.float32)
    bits = q.view(torch.int32) & -65536  # toward zero onto the bf16 grid
    down = bits.view(torch.float32)
    up = (bits + 65536).view(torch.float32)  # one bf16 step away from 0
    mid = (down.double() + up.double()) / 2
    near = (q.double() - mid).abs() <= WINDOW * 2.0**-23 * q.double().abs()
    other = torch.where(qb == down, up, down)
    return torch.where(near, other - qb, torch.zeros_like(q))


#: float32 ulps within which two normalisations of a query may differ
WINDOW = 8


def score(state: IVFState, qb: torch.Tensor, pos: torch.Tensor
          ) -> torch.Tensor:
    """Scores of one query ``qb`` (d,) at ``pos``: (codes times scale) .
    the bf16-rounded query, in float32."""
    return (state.codes[pos].to(torch.float32) @ qb) * state.scales[pos]


def slack(state: IVFState, flip: torch.Tensor, pos: torch.Tensor
          ) -> torch.Tensor:
    """How far the other rounding of a query's ambiguous components
    (``flips``) could move its scores at ``pos``."""
    if not flip.any():
        return torch.zeros(pos.shape, device=pos.device)
    codes = state.codes[pos].to(torch.float32).abs()
    return (codes @ flip.abs()) * state.scales[pos]


def candidates(state: IVFState, q: torch.Tensor, nprobe: int
               ) -> torch.Tensor:
    """Live positions one query ``q`` (d,) scores: its probed buckets'
    rows and the residual rows."""
    probe = torch.topk(state.centroids @ q,
                       min(nprobe, state.centroids.shape[0])).indices
    lo = state.bucket_start[probe]
    cnt = state.bucket_start[probe + 1] - lo
    first = torch.repeat_interleave(lo - (torch.cumsum(cnt, 0) - cnt), cnt)
    pos = torch.cat([first + torch.arange(int(cnt.sum()), device=q.device),
                     state.residual])
    return pos[state.live[pos]]


def _search(state: IVFState, q, qb, k: int, nprobe: int):
    """``(B, k)`` scores and positions, best first, -inf / -1 past the
    candidate count."""
    b, dev = q.shape[0], q.device
    top_v = torch.full((b, k), float("-inf"), device=dev)
    top_p = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    with no_tf32():
        for i in range(b):
            pos = candidates(state, q[i], nprobe)
            s = score(state, qb[i], pos)
            v, j = torch.topk(s, min(k, s.shape[0]))
            top_v[i, :len(v)] = v
            top_p[i, :len(v)] = pos[j]
    return top_v, top_p


def search(state: IVFState, queries, k: int, nprobe: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's answers: ``(B, k)`` float32 scores and labels,
    best first, -inf / -1 past the candidate count. One query at a
    time."""
    q, qb = _query(state, queries)
    top_v, top_p = _search(state, q, qb, k, nprobe)
    label = torch.where(top_p >= 0, state.label[top_p.clamp_min(0)], -1)
    return top_v, label


def compare(state: IVFState, queries, labels, scores, k: int, nprobe: int,
            tol: float = TOL) -> dict:
    """Hold answers (``labels`` / ``scores`` (B, k), best first, as the
    program returned them) to the reference. Counts the queries that
    fail each rule:

    * ``dead``: a hit that names no live row;
    * ``a``: a reported score that differs from the reference's score of
      that row by more than ``tol`` (plus the row's ``slack``, where the
      query's bf16 rounding is ambiguous);
    * ``b``: at some rank r, a score below the reference's r-th score
      less ``tol`` (plus the largest slack of the reference's first r
      rows): a row of a probed bucket or the residual was missed.

    Also returns the widest score difference (``worst_a``), the widest
    shortfall at a rank (``worst_b``), each less its slack, the queries
    with an ambiguous rounding (``flipped``), the counts of the rules
    without the slack (``a_plain``, ``b_plain``, and of the queries
    they fail, those without an ambiguous component,
    ``plain_unflipped``) and the count of queries."""
    q, qb = _query(state, queries)
    ref_v, ref_p = _search(state, q, qb, k, nprobe)
    dev = qb.device
    lab = torch.as_tensor(np.asarray(labels, np.int64), device=dev)
    got = torch.as_tensor(np.asarray(scores, np.float32), device=dev)
    pos = state.position_of(lab)
    dead = (pos < 0).any(dim=1)
    flip = flips(q)
    with no_tf32():
        true = torch.stack([score(state, qb[i], pos[i].clamp_min(0))
                            for i in range(qb.shape[0])])
        room = torch.stack([slack(state, flip[i], pos[i].clamp_min(0))
                            for i in range(qb.shape[0])])
        ref_room = torch.stack([slack(state, flip[i], ref_p[i].clamp_min(0))
                                for i in range(qb.shape[0])])
    ref_room = torch.cummax(torch.where(ref_p >= 0, ref_room, 0.0), 1).values
    diff = torch.where(pos >= 0, (got - true).abs() - room,
                       torch.zeros_like(got))
    short = torch.nan_to_num(ref_v - got, nan=0.0, posinf=float("inf"),
                             neginf=0.0) - ref_room
    return {
        "queries": int(qb.shape[0]),
        "dead": int(dead.sum()),
        "a": int((diff > tol).any(dim=1).sum()),
        "b": int((short > tol).any(dim=1).sum()),
        # the same rules without the slack, and how many of the queries
        # they fail have no ambiguous component
        "a_plain": int(((diff + room) > tol).any(dim=1).sum()),
        "b_plain": int(((short + ref_room) > tol).any(dim=1).sum()),
        "plain_unflipped": int((((diff + room) > tol).any(dim=1)
                                | ((short + ref_room) > tol).any(dim=1))
                               [~flip.ne(0).any(dim=1)].sum()),
        "worst_a": float(diff.max().clamp_min(0)) if diff.numel() else 0.0,
        "worst_b": float(short.max().clamp_min(0)) if short.numel() else 0.0,
        "flipped": int(flip.ne(0).any(dim=1).sum()),
    }
