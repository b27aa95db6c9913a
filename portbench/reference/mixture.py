"""The corpus and query generator: a Gaussian mixture on the unit sphere.

A frozen copy of ``chip_smoke.py``'s ``_mixture`` (``n_comp`` unit
centres, noise ``noise / sqrt(d)``: at 0.67 the cosine between a row and
its centre is about 0.83), with the seeding made explicit so that any
``--seed`` up to 2**64 names one corpus. Rows are made on ``device`` in
a few large calls; ``rows(lo, hi)`` gives the same float32 rows for the
same seed on every call, so the reference regenerates the corpus instead
of keeping a copy of it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one named stream of ``seed``."""
    ss = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), *stream])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


#: stream ids of ``sub_seed``
CENTERS, CHUNK, QUERIES = 1, 2, 3


class Mixture:
    """``n_comp`` centres in ``d`` dimensions, drawn from ``seed``."""

    def __init__(self, seed: int, n_comp: int, d: int, noise: float,
                 chunk_rows: int, device: str | torch.device = "cuda"):
        self.seed, self.n_comp, self.d = int(seed), n_comp, d
        self.noise = noise / math.sqrt(d)
        self.chunk_rows = chunk_rows
        self.device = torch.device(device)
        g = self._gen(CENTERS)
        centers = torch.randn((n_comp, d), generator=g, device=self.device)
        self.centers = centers / centers.norm(dim=1, keepdim=True)

    def _gen(self, *stream: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(sub_seed(self.seed, *stream))
        return g

    def _draw(self, g: torch.Generator, m: int) -> torch.Tensor:
        ids = torch.randint(0, self.n_comp, (m,), generator=g,
                            device=self.device)
        x = self.centers[ids] + self.noise * torch.randn(
            (m, self.d), generator=g, device=self.device)
        return x / x.norm(dim=1, keepdim=True)

    def chunk(self, i: int, n_rows: int) -> torch.Tensor:
        """Rows ``[i * chunk_rows, min((i + 1) * chunk_rows, n_rows))``."""
        lo = i * self.chunk_rows
        m = min(self.chunk_rows, n_rows - lo)
        return self._draw(self._gen(CHUNK, i), m)

    def chunks(self, n_rows: int):
        """``(lo, rows)`` for every chunk of an ``n_rows`` corpus."""
        for i in range(-(-n_rows // self.chunk_rows)):
            yield i * self.chunk_rows, self.chunk(i, n_rows)

    def queries(self, m: int) -> torch.Tensor:
        """The query pool: ``m`` rows of the same mixture, another stream."""
        return self._draw(self._gen(QUERIES), m)
