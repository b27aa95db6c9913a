"""Spherical k-means on the device: trains the clustered index's
partitions.

Torch port of ``wdbx_tpu/ops/kmeans.py``. Vectors are assumed
L2-normalized; centroids are re-normalized every iteration, so this is
spherical k-means (the objective when search similarity is the inner
product of unit vectors). Seeding is k-means++ up to 256 clusters and a
batched k-means||-style Gumbel-top-k seeding above (the sequential
k-means++ passes cost minutes at 4,096 clusters). Lloyd sums each
cluster's rows with ``index_add_`` at every size (the JAX package's
one-hot product below 256 MB was a TPU matrix-unit route, and needs an
(N, C) float32 one-hot).

Randomness comes from a ``torch.Generator`` seeded with ``seed``. Its
streams differ from ``jax.random``'s, so the centroids differ from the
JAX package's for the same seed; the tests hold the objective and the
assignment instead. Products run in true float32 (TF32 off on the CUDA
device, for these products only).
"""

from __future__ import annotations

import torch

from wdbx_tpu_torch.ops.exact_search import true_f32


def kmeans(
    data: torch.Tensor,
    num_clusters: int,
    iters: int = 15,
    seed: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cluster ``(N, d)`` unit vectors into ``num_clusters`` partitions.

    Returns ``(centroids, assignments)``: ``(num_clusters, d)`` float32
    unit centroids and ``(N,)`` int32 cluster ids."""
    data = data.to(torch.float32)
    gen = torch.Generator(device=data.device).manual_seed(seed)
    with true_f32():
        if num_clusters > 256:
            cents = _batched_seed_init(gen, data, num_clusters)
        else:
            cents = _kmeanspp_init(gen, data, num_clusters)
        for _ in range(iters):
            cents = lloyd_step(data, cents)
        return cents, assign_nearest(data, cents)


def assign_nearest(data: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """``(N,)`` int32 index of each row's largest inner product (ties
    to the lowest index, as ``jnp.argmax``)."""
    with true_f32():
        return torch.argmax(data @ cents.T, dim=-1).to(torch.int32)


def lloyd_step(data: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """One Lloyd iteration: assign, average, re-normalize. Empty
    clusters keep their previous centroid (no collapse to zero)."""
    c = cents.shape[0]
    with true_f32():
        assign = torch.argmax(data @ cents.T, dim=-1)
    sums = torch.zeros((c, data.shape[1]), dtype=torch.float32,
                       device=data.device).index_add_(0, assign, data)
    counts = torch.zeros((c,), dtype=torch.float32,
                         device=data.device).index_add_(
        0, assign, torch.ones_like(assign, dtype=torch.float32)
    )[:, None]
    new = torch.where(counts > 0, sums / torch.clamp_min(counts, 1.0), cents)
    return _renorm(new)


def _kmeanspp_init(gen: torch.Generator, data: torch.Tensor,
                   c: int) -> torch.Tensor:
    """k-means++ seeding: each next centroid is drawn with probability
    proportional to its squared cosine distance from the closest centroid
    chosen so far."""
    n, d = data.shape
    first = int(torch.randint(0, n, (1,), generator=gen, device=data.device))
    cents = torch.zeros((c, d), dtype=torch.float32, device=data.device)
    cents[0] = data[first]
    min_d2 = 2.0 - 2.0 * (data @ data[first])
    for i in range(1, c):
        idx = torch.multinomial(torch.clamp_min(min_d2, 1e-12), 1,
                                generator=gen)
        chosen = data[idx[0]]
        cents[i] = chosen
        min_d2 = torch.minimum(min_d2, 2.0 - 2.0 * (data @ chosen))
    return _renorm(cents)


def _batched_seed_init(gen: torch.Generator, data: torch.Tensor, c: int,
                       rounds: int = 8) -> torch.Tensor:
    """k-means||-flavoured seeding: ``rounds`` passes, each scoring the
    data against the centers chosen last round and drawing the next
    batch of centers ~ d^2 by Gumbel top-k (sampling without
    replacement)."""
    n, d = data.shape
    per = -(-c // rounds)
    first = torch.randperm(n, generator=gen, device=data.device)[:per]
    cents = torch.zeros((rounds * per, d), dtype=torch.float32,
                        device=data.device)
    cents[:per] = data[first]
    min_d2 = torch.full((n,), 4.0, dtype=torch.float32, device=data.device)
    tiny = torch.finfo(torch.float32).tiny
    for r in range(1, rounds):
        new = cents[(r - 1) * per: r * per]
        d2 = 2.0 - 2.0 * torch.amax(data @ new.T, dim=-1)
        min_d2 = torch.minimum(min_d2, d2)
        u = torch.rand((n,), generator=gen, device=data.device)
        gumbel = -torch.log(-torch.log(torch.clamp(u, tiny, 1.0 - 1e-7)))
        g = gumbel + torch.log(torch.clamp_min(min_d2, 1e-12))
        picks = torch.topk(g, per).indices
        cents[r * per: (r + 1) * per] = data[picks]
    return _renorm(cents[:c])


def _renorm(x: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp_min(sq, 1e-24))
