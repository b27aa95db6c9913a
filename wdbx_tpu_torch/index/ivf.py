"""IVF base: training bookkeeping, the residual merge, filtered-probe
boosts and the recall tuners shared by the IVF engines.

Torch port of the parts of ``wdbx_tpu/index/ivf.py`` that the clustered
engine (``index/clustered.py``) inherits:

  * the constructor and attributes, ``is_trained``, and the residual
    (fresh-buffer) and quarantine bookkeeping of the mutators;
  * ``_residual_merge``: merge block-scan candidates with a brute-force
    scan of the fresh rows;
  * the filtered-search routing: ``FILTER_EXACT_THRESHOLD`` and the
    selectivity-binned probe boosts;
  * build-if-stale ``search``, ``optimize``, ``clear``, ``tune``,
    ``tune_filtered`` and the exact oracles.

The dense bucket-table engine itself (``INDEX_TYPE=ivf_dense``, or
``ivf`` with ``IVF_ASSIGNMENTS>=2``) waits for slice 4 of the port:
building, searching, saving or loading a trained dense ``IVFIndex``
raises ``NotImplementedError``. Below its training threshold it serves
as a flat index, as in the JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from wdbx_tpu_torch.index.flat import FlatIndex
from wdbx_tpu_torch.kernels.quant import unpack_int4
from wdbx_tpu_torch.ops.exact_search import f32_scores


def _dense_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"the dense-table IVFIndex {what} is not ported to wdbx_tpu_torch "
        "yet (slice 4, ROADMAP.md queue 1); INDEX_TYPE=ivf with "
        "IVF_ASSIGNMENTS<=1 serves through ivf_clustered"
    )


def _scores_of(rows: torch.Tensor, q: torch.Tensor, precision: str,
               quant: bool) -> torch.Tensor:
    """``(B, R)`` float32 products of ``q`` against ``rows`` as the
    JAX scans take them: bf16 queries against int8 / int4 codes, the
    slab's type otherwise; float32 accumulation of exact products
    (true float32 for ``precision="highest"``)."""
    if quant:
        qf = q.to(torch.bfloat16).to(torch.float32)
    else:
        qf = q.to(rows.dtype).to(torch.float32)
    rf = rows.to(torch.float32)
    if precision == "highest":
        return f32_scores(qf, rf)
    return qf @ rf.T


def _residual_merge(
    slab: torch.Tensor,
    valid: torch.Tensor,
    residual_pos: torch.Tensor,
    scales: torch.Tensor | None,
    vals: torch.Tensor,
    labels: torch.Tensor,
    q: torch.Tensor,
    k: int,
    precision: str,
    int8: bool = False,
    int4: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge ``(B, C)`` scan candidates (scores, int64 positions) with a
    brute-force scan of the fresh rows at ``residual_pos`` (the live
    positions only: unlike the JAX version there are no pad entries one
    past the slab). Scores ``<= -3e38`` (JAX's ``NEG`` sentinel) count
    as -inf. Returns sorted ``(B, k)`` scores and positions, -inf / -1
    past the candidate count."""
    b = q.shape[0]
    scores = torch.where(vals <= -3.0e38, float("-inf"), vals)
    flat_labels = labels.to(torch.int64)
    if residual_pos.numel():
        rows = slab[residual_pos]
        if int4:
            rows = unpack_int4(rows)
        r_scores = _scores_of(rows, q, precision, int8 or int4)
        if int8 or int4:
            r_scores = r_scores * scales[residual_pos][None, :]
        r_scores = torch.where(valid[residual_pos][None, :], r_scores,
                               float("-inf"))
        scores = torch.cat([scores, r_scores], dim=-1)
        flat_labels = torch.cat(
            [flat_labels, residual_pos[None, :].expand(b, -1)], dim=-1
        )
    k_eff = min(k, scores.shape[-1])
    top, pos = torch.topk(scores, k_eff, dim=-1)
    top_labels = torch.gather(flat_labels, -1, pos)
    if k_eff < k:
        top = torch.nn.functional.pad(top, (0, k - k_eff),
                                      value=float("-inf"))
        top_labels = torch.nn.functional.pad(top_labels, (0, k - k_eff),
                                             value=-1)
    return top, top_labels


#: selectivity below which filtered ANN searches route to the exact
#: masked flat scan: probing nprobe buckets for a filter matching <2%
#: of rows rarely surfaces k matches, while the exact scan is recall 1.0
FILTER_EXACT_THRESHOLD = 0.02

#: selectivity bin edges for the filtered probe boost; each bin maps to
#: one boost factor
_BOOST_BINS = (0.5, 0.25, 0.125)
#: default boost per bin, about 2/selectivity at the bin's lower edge;
#: tune_filtered() replaces these with measured values
_DEFAULT_BOOSTS = (2, 4, 8, 16)
#: candidate factors tune_filtered may pin (~1.5x steps)
_BOOST_LADDER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)


def _boost_bin(selectivity: float) -> int:
    for i, edge in enumerate(_BOOST_BINS):
        if selectivity >= edge:
            return i
    return len(_BOOST_BINS)


def _filter_boost(selectivity: float, table=None) -> int:
    """Probe multiplier for a filter passing a fraction ``s`` of rows
    (about 2/s); ``table`` (bin -> factor, from ``tune_filtered``)
    overrides the defaults."""
    b = _boost_bin(selectivity)
    if table:
        got = table.get(b)
        if got:
            return int(got)
    return _DEFAULT_BOOSTS[b]


class IVFIndex(FlatIndex):
    kind = "ivf"
    # dense bucket tables duplicate rows outside the flat slab; the
    # slab-external scheme cannot reconstruct them from raw rows
    supports_slab_external = False

    def __init__(
        self,
        dim: int,
        metric: str = "cosine",
        dtype: str = "float32",
        capacity: int = 1024,
        nlist: int = 100,
        nprobe: int = 8,
        train_threshold: int = 4096,
        rebuild_fraction: float = 0.2,
        kmeans_iters: int = 15,
        train_sample: int = 262_144,
        assignments: int = 1,
        device: Any = None,
    ):
        super().__init__(dim, metric=metric, dtype=dtype, capacity=capacity,
                         device=device)
        if dtype == "int4" and self.kind == "ivf":
            raise ValueError(
                "int4 is supported by 'flat', 'sharded_flat', "
                "'ivf_clustered' and 'sharded_clustered' "
                "(the dense-table IVF stays int8)"
            )
        self.nlist = nlist
        self.nprobe = nprobe
        #: clusters each vector joins (2 = SOAR-style spilled assignment,
        #: dense engine only)
        self.assignments = max(1, int(assignments))
        self.train_threshold = train_threshold
        self.rebuild_fraction = rebuild_fraction
        self.kmeans_iters = kmeans_iters
        self.train_sample = train_sample
        #: fall back to a flat scan when batched probes cover the corpus
        self.batch_flat_fallback = True
        # ANN context: the flat fallbacks select with exact_search (the
        # JAX package's approximate selector is exact here)
        self.topk_method = "approx"
        #: bucket-scan implementation ("lax" portable scan or "pallas",
        #: the kernel path)
        self.ivf_kernel = "lax"
        #: calibrated filtered-probe boosts (selectivity bin -> factor),
        #: populated by tune_filtered(); empty -> _DEFAULT_BOOSTS
        self._filter_boosts: dict[int, int] = {}
        self._reset_overlay()

    def _reset_overlay(self) -> None:
        self._centroids = None
        self._residual: list[int] = []  # slots added since last build
        self._residual_base = 0  # spill-seeded entries (don't re-trigger)
        self._quarantine: list[int] = []  # freed slots held until rebuild
        self._built_size = 0

    @property
    def is_trained(self) -> bool:
        return self._centroids is not None

    # -- mutation: fresh buffer bookkeeping ---------------------------------
    def add_batch(self, vectors) -> np.ndarray:
        with self._mu.write():
            slots = super().add_batch(vectors)
            if self.is_trained:
                self._residual.extend(int(s) for s in slots)
            return slots

    def update_slots(self, slots: np.ndarray, vectors) -> None:
        with self._mu.write():
            super().update_slots(slots, vectors)
            if not self.is_trained:
                return
            slot_list = [int(s) for s in np.asarray(slots, np.int64)]
            present = set(self._residual)
            self._residual.extend(s for s in slot_list if s not in present)

    def remove_slots(self, slots: np.ndarray) -> None:
        """Tombstone, but quarantine the slots until the next build
        instead of recycling them (a reused slot would surface from its
        old bucket entry too)."""
        with self._mu.write():
            super().remove_slots(slots)
            if self.is_trained:
                freed = set(int(s) for s in np.asarray(slots, np.int64))
                self._free = [s for s in self._free if s not in freed]
                self._quarantine.extend(freed)

    def clear(self) -> None:
        with self._mu.write():
            super().clear()
            self._reset_overlay()

    def optimize(self) -> None:
        if self._size > 0:
            self.build()

    def compact(self):
        with self._mu.write():
            old, new = super().compact()
            self._reset_overlay()
            if self._size >= self.train_threshold:
                self.build()
            return old, new

    # -- build ---------------------------------------------------------------
    def build(self) -> None:
        with self._mu.write():
            self._build_locked()

    def _build_locked(self) -> None:
        raise _dense_not_ported("build")

    def _needs_build(self) -> bool:
        if not self.is_trained:
            return self._size >= self.train_threshold
        fresh = len(self._residual) - getattr(self, "_residual_base", 0)
        return bool(self._built_size) and (
            fresh > self.rebuild_fraction * self._built_size
        )

    def _maybe_build(self) -> None:
        if self._needs_build():
            self.build()

    # -- query ---------------------------------------------------------------
    def search(
        self,
        queries,
        k: int,
        slot_mask: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        # build-if-stale needs the write lock (it swaps the overlay); the
        # search itself runs under read so concurrent queries overlap
        if self._needs_build():
            with self._mu.write():
                self._maybe_build()
        with self._mu.read():
            return self._search_read_locked(queries, k, slot_mask)

    def _search_read_locked(self, queries, k, slot_mask):
        if not self.is_trained:
            return super().search(queries, k, slot_mask)
        raise _dense_not_ported("search")

    def search_pipelined(self, qstack, k: int, materialize: bool = True):
        if self._needs_build():
            with self._mu.write():
                self._maybe_build()
        with self._mu.read():
            if not self.is_trained:
                return super().search_pipelined(qstack, k, materialize)
            raise _dense_not_ported("search_pipelined")

    def tune(
        self,
        queries: np.ndarray,
        k: int = 10,
        target_recall: float = 0.95,
        max_scan_fraction: float = 1.0,
        exclude_slots: np.ndarray | None = None,
    ) -> float:
        """Pick the smallest ``nprobe`` hitting ``target_recall`` on a
        sample query set, measured against this index's own exact scan.
        Returns the achieved recall. ``exclude_slots`` (one slot per
        query) holds each query's own row out of both sides."""
        with self._mu.write():
            self._maybe_build()
        if not self.is_trained:
            return 1.0
        queries = self._prep(queries)
        fetch_k = k + 1 if exclude_slots is not None else k

        def row_sets(slot_rows) -> list[set]:
            out = []
            for qi, row in enumerate(slot_rows):
                kept = [int(s) for s in row if s >= 0]
                if exclude_slots is not None:
                    own = int(exclude_slots[qi])
                    kept = [s for s in kept if s != own]
                out.append(set(kept[:k]))
            return out

        _, exact = self._oracle_search(queries, fetch_k)
        exact_sets = [s or {-1} for s in row_sets(exact)]
        nlist = int(self._centroids.shape[0])
        max_probe = max(1, int(nlist * max_scan_fraction))

        def recall_at(nprobe: int) -> float:
            self.nprobe = nprobe
            fallback = self.batch_flat_fallback
            self.batch_flat_fallback = False  # measure the real scan path
            try:
                _, got = self.search(queries, fetch_k)
            finally:
                self.batch_flat_fallback = fallback
            return float(np.mean([
                len(e & g) / len(e)
                for e, g in zip(exact_sets, row_sets(got))
            ]))

        prior = self.nprobe
        try:
            # geometric climb to bracket the target
            lo, hi = 0, 1
            recall = recall_at(hi)
            while recall < target_recall and hi < max_probe:
                lo = hi
                hi = min(max_probe, hi * 2)
                recall = recall_at(hi)
            if recall < target_recall:
                self.nprobe = prior = hi
                return recall
            # binary search down to the smallest passing nprobe
            best_probe, best_recall = hi, recall
            while lo + 1 < hi:
                mid = (lo + hi) // 2
                r = recall_at(mid)
                if r >= target_recall:
                    hi, best_probe, best_recall = mid, mid, r
                else:
                    lo = mid
            self.nprobe = best_probe
            prior = best_probe
            return best_recall
        finally:
            if self.nprobe != prior:
                self.nprobe = prior

    def tune_filtered(
        self,
        queries: np.ndarray,
        slot_mask: np.ndarray,
        k: int = 10,
        target_recall: float = 0.95,
        max_boost: int = 64,
    ) -> float:
        """Calibrate the filtered probe boost of ``slot_mask``'s
        selectivity bin on a bounded factor ladder, both ways: escalate
        until filtered recall@k meets ``target_recall`` (against the
        exact masked scan), or de-escalate to the smallest rung that
        still holds it. Returns the recall at the pinned factor."""
        with self._mu.write():
            self._maybe_build()
        if not self.is_trained:
            return 1.0
        queries = self._prep(queries)
        slot_mask = np.asarray(slot_mask, bool)
        sel = self._mask_selectivity(slot_mask)
        if sel < FILTER_EXACT_THRESHOLD:
            return 1.0  # this bin already routes to the exact masked scan
        bin_ = _boost_bin(sel)
        _, exact = self._oracle_search_masked(queries, k, slot_mask)
        exact_sets = [
            set(int(s) for s in row if s >= 0) or {-1} for row in exact
        ]
        nlist = int(self._centroids.shape[0])
        fallback = self.batch_flat_fallback
        self.batch_flat_fallback = False  # measure the real scan path

        def recall_at(factor: int) -> float:
            self._filter_boosts[bin_] = factor
            _, got = self.search(queries, k, slot_mask=slot_mask)
            return float(np.mean([
                len(e & set(int(s) for s in g)) / len(e)
                for e, g in zip(exact_sets, got)
            ]))

        ladder = [f for f in _BOOST_LADDER if f <= max_boost]
        try:
            at_least = [
                i for i, f in enumerate(ladder)
                if f >= _DEFAULT_BOOSTS[bin_]
            ]
            start = at_least[0] if at_least else len(ladder) - 1
            rec = recall_at(ladder[start])
            if rec >= target_recall:
                lo, hi = 0, start  # hi passes
                best = (start, rec)
                while lo < hi:
                    mid = (lo + hi) // 2
                    r = recall_at(ladder[mid])
                    if r >= target_recall:
                        hi, best = mid, (mid, r)
                    else:
                        lo = mid + 1
                self._filter_boosts[bin_] = ladder[best[0]]
                return best[1]
            for i in range(start + 1, len(ladder)):
                rec = recall_at(ladder[i])
                saturated = ladder[i] * self.nprobe >= nlist
                if rec >= target_recall or saturated:
                    return rec
            return rec
        finally:
            self.batch_flat_fallback = fallback

    def _oracle_search(self, queries, k):
        """Exact scan used as tune()'s recall oracle."""
        return FlatIndex.search(self, queries, k)

    def _oracle_search_masked(self, queries, k, slot_mask):
        """Exact masked scan used as tune_filtered()'s oracle."""
        return FlatIndex.search(self, queries, k, slot_mask)

    # -- persistence ---------------------------------------------------------
    def save(self, path: str, skip_slab: bool = False) -> None:
        if self.is_trained:
            raise _dense_not_ported("save")
        super().save(path, skip_slab=skip_slab)

    def load(self, path: str) -> bool:
        raise _dense_not_ported("load")

    def get_stats(self) -> dict:
        stats = super().get_stats()
        stats.update(
            nlist=self.nlist,
            nprobe=self.nprobe,
            trained=self.is_trained,
            residual=len(self._residual),
        )
        return stats
