"""Collectives of the cross-process data plane, on the default
``torch.distributed`` group.

A global mesh (``parallel/mesh.py``) spans the ranks of a group, and
every rank issues the same calls with the same arguments: each writes,
scans and saves only the positions it owns. What crosses ranks goes
through this module: the ``(B, k)`` partials of a search and the
answered batch slices of a replicated mesh (``all_gather``), the
centroids of a build (``broadcast``), the rows a build moves between
ranks (``all_to_all`` of variable-length row blocks), the tables a
checkpoint writes on rank 0 (``gather``), and the order of a
checkpoint's writes (``barrier``).

The group is gloo, as ``ShardEngine.initialize`` creates it: NCCL takes
one card a rank, and ranks may share a card. Device tensors are staged
explicitly through host tensors around each call; the kernels and the
index state stay on the device, and only the traffic between ranks
passes through the host. Tensors cross as raw bytes (``uint8`` views),
so every dtype crosses unchanged.

With no group, or a group of one, every call returns its input and
moves nothing. One lock serializes a process's collectives: gloo needs
every rank to issue the same collectives in the same order, and two
threads of one rank must not interleave theirs. ``stats()`` counts, by
kind, the calls, the bytes this rank sent to other ranks and the
milliseconds spent, host staging included.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Sequence

import torch

_LOCK = threading.RLock()
_STATS: dict[str, dict[str, float]] = {}

#: what a mesh spanning ranks does not port yet: its ROADMAP.md item
NOT_PORTED = {
    "replicas": "replica groups spanning ranks",
    "re-meshing": "build_background, remesh and heal across ranks",
}


def not_ported(what: str) -> NotImplementedError:
    """The error of an operation a mesh spanning ranks does not port."""
    return NotImplementedError(
        f"{what} on a mesh spanning ranks is not ported (ROADMAP.md queue "
        f"1: {NOT_PORTED[what]})")


def rank_world() -> tuple[int, int]:
    """This process's rank and the group's size (0, 1 without a group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _count(kind: str, sent: int, t0: float) -> None:
    s = _STATS.setdefault(kind, {"calls": 0, "bytes": 0, "ms": 0.0})
    s["calls"] += 1
    s["bytes"] += int(sent)
    s["ms"] += (time.perf_counter() - t0) * 1e3


def stats() -> dict[str, dict[str, float]]:
    """Calls, bytes sent to other ranks and ms, by collective kind."""
    return {kind: dict(s) for kind, s in _STATS.items()}


def reset_stats() -> None:
    _STATS.clear()


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` as flat raw bytes."""
    if not t.numel():  # an empty view's strides may not allow the cast
        return torch.empty(0, dtype=torch.uint8)
    return t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8)


def _typed(buf: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    """Raw host bytes back to ``like``'s dtype, ``shape`` and device."""
    return buf.view(like.dtype).reshape(shape).to(like.device)


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """``(world, *t.shape)``: every rank's ``t`` in rank order, on
    ``t``'s device. Every rank passes the same shape and dtype."""
    _, world = rank_world()
    if world == 1:
        return t[None]
    import torch.distributed as dist

    with _LOCK:
        t0 = time.perf_counter()
        mine = _bytes(t)
        parts = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(parts, mine)
        out = _typed(torch.stack(parts), t, (world,) + tuple(t.shape))
        _count("all_gather", mine.numel() * (world - 1), t0)
    return out


def gather(t: torch.Tensor, dst: int = 0) -> torch.Tensor | None:
    """``(world, *t.shape)`` on rank ``dst`` (every rank's ``t`` in rank
    order, on ``t``'s device), None on the others. Every rank passes the
    same shape and dtype."""
    rank, world = rank_world()
    if world == 1:
        return t[None]
    import torch.distributed as dist

    with _LOCK:
        t0 = time.perf_counter()
        mine = _bytes(t)
        parts = ([torch.empty_like(mine) for _ in range(world)]
                 if rank == dst else None)
        dist.gather(mine, parts, dst)
        out = (_typed(torch.stack(parts), t, (world,) + tuple(t.shape))
               if rank == dst else None)
        _count("gather", 0 if rank == dst else mine.numel(), t0)
    return out


def all_gather_object(obj: Any) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    _, world = rank_world()
    if world == 1:
        return [obj]
    import torch.distributed as dist

    with _LOCK:
        t0 = time.perf_counter()
        out = [None] * world
        dist.all_gather_object(out, obj)
        _count("all_gather_object", 0, t0)
    return out


def all_sum(x: int) -> int:
    """The sum of an integer over the ranks."""
    _, world = rank_world()
    if world == 1:
        return int(x)
    return int(all_gather(torch.tensor([int(x)], dtype=torch.int64)).sum())


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (on each rank's ``t`` device;
    the other ranks pass a tensor of the same shape and dtype)."""
    rank, world = rank_world()
    if world == 1:
        return t
    import torch.distributed as dist

    with _LOCK:
        t0 = time.perf_counter()
        buf = _bytes(t) if rank == src else torch.empty(
            t.numel() * t.element_size(), dtype=torch.uint8)
        dist.broadcast(buf, src)
        out = _typed(buf, t, t.shape)
        _count("broadcast", buf.numel() * (world - 1) if rank == src else 0,
               t0)
    return out


def all_to_all(blocks: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Variable-length row blocks between the ranks: ``blocks[r]``
    (``(n_r, *row)``) goes to rank ``r``; returns the block each rank
    sent here, in rank order, on ``blocks[0]``'s device. Every block of
    every rank has the same row shape and dtype."""
    rank, world = rank_world()
    if len(blocks) != world:
        raise ValueError(f"{len(blocks)} blocks for {world} ranks")
    if world == 1:
        return [blocks[0]]
    import torch.distributed as dist

    like = blocks[0]
    row = tuple(like.shape[1:])
    with _LOCK:
        t0 = time.perf_counter()
        sends = [_bytes(b) for b in blocks]
        sizes = torch.tensor([s.numel() for s in sends], dtype=torch.int64)
        table = [torch.empty_like(sizes) for _ in range(world)]
        dist.all_gather(table, sizes)
        recv = [int(table[r][rank]) for r in range(world)]
        out = torch.empty(sum(recv), dtype=torch.uint8)
        dist.all_to_all_single(out, torch.cat(sends),
                               output_split_sizes=recv,
                               input_split_sizes=sizes.tolist())
        got = []
        for part in torch.split(out, recv):
            n = part.numel() // (like.element_size() * math.prod(row))
            got.append(_typed(part, like, (n,) + row))
        sent = sum(s.numel() for r, s in enumerate(sends) if r != rank)
        _count("all_to_all", sent + sizes.numel() * 8 * (world - 1), t0)
    return got


def barrier() -> None:
    _, world = rank_world()
    if world == 1:
        return
    import torch.distributed as dist

    with _LOCK:
        t0 = time.perf_counter()
        dist.barrier()
        _count("barrier", 0, t0)
