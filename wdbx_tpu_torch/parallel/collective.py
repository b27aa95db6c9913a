"""Collectives of the cross-process data plane, on the groups of
``torch.distributed``.

A global mesh (``parallel/mesh.py``) spans the ranks of a group, and
every rank issues the same calls with the same arguments: each writes,
scans and saves only the positions it owns, and a rank that owns no
position (or none of the part being computed) still joins every call
with an empty block. What crosses ranks goes through this module: the
``(B, k')`` partials of a search, one block a rank holding the slices
of every replica group it serves (``all_gather``), the centroids of a
build (``broadcast``), the rows a build or a remesh moves between ranks
(``all_to_all`` of variable-length row blocks), the tables a checkpoint
writes on rank 0 (``gather``), and the order of a checkpoint's writes
(``barrier``).

Two groups span the same ranks. The default group carries the
foreground: searches, writes, checkpoints, blocking builds. The
background group (``open_background_group``, which ``ShardEngine.join``
calls on every rank right after the join) carries the collectives of a
background rebuild (``ShardedClusteredIndex.build_background``), which
run in another thread while the foreground goes on. Every function takes
a ``group``; ``None`` means the calling thread's group, which is the
default group unless the thread runs inside ``using(group)``.

The groups are gloo, as ``ShardEngine.initialize`` creates them: NCCL
takes one card a rank, and ranks may share a card. Device tensors are
staged explicitly through host tensors around each call; the kernels and
the index state stay on the device, and only the traffic between ranks
passes through the host. Tensors cross as raw bytes (``uint8`` views),
so every dtype crosses unchanged.

With no group, or a group of one, every call returns its input and
moves nothing. One lock a group serializes a process's collectives on
that group: gloo needs every rank to issue the same collectives on a
group in the same order, and two threads of one rank must not interleave
theirs. One lock for every group would deadlock two ranks: rank 0's
background thread holding it inside the background group's all-to-all,
rank 1's foreground thread holding rank 1's inside a search's
all-gather, which waits for rank 0's foreground thread, which waits for
the lock. ``stats()`` counts, by kind, the calls, the bytes this rank
sent to other ranks and the milliseconds spent, host staging included;
``stats(by_group=True)`` splits the same counts by group.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import threading
import time
from typing import Any, Iterator, Sequence

import torch

#: one lock a group (key: the group's name)
_LOCKS: dict[str, threading.RLock] = {}
_LOCKS_MU = threading.Lock()
_STATS: dict[str, dict[str, dict[str, float]]] = {}
#: the background group, once ``open_background_group`` made it
_BACKGROUND: Any = None
#: the calling thread's group (``using``)
_THREAD = threading.local()

def open_background_group(timeout_s: float) -> None:
    """Create the background group over every rank of the default group
    (once; every rank must call this at the same point, as
    ``ShardEngine.join`` does)."""
    global _BACKGROUND
    import torch.distributed as dist

    if _BACKGROUND is not None or not (dist.is_available()
                                       and dist.is_initialized()):
        return
    if dist.get_world_size() == 1:
        return
    _BACKGROUND = dist.new_group(
        backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))


def background_group() -> Any:
    """The background group (None without one: a group of one rank, or
    none yet)."""
    return _BACKGROUND


def forget_groups() -> None:
    """Drop the background group (after ``destroy_process_group``)."""
    global _BACKGROUND
    _BACKGROUND = None


@contextlib.contextmanager
def using(group: Any) -> Iterator[None]:
    """Run the calling thread's collectives on ``group``."""
    prev = getattr(_THREAD, "group", None)
    _THREAD.group = group
    try:
        yield
    finally:
        _THREAD.group = prev


def _resolve(group: Any) -> Any:
    return group if group is not None else getattr(_THREAD, "group", None)


def _name(group: Any) -> str:
    return "background" if group is not None and group is _BACKGROUND \
        else "default"


def _lock(group: Any) -> threading.RLock:
    name = _name(group)
    with _LOCKS_MU:
        return _LOCKS.setdefault(name, threading.RLock())


def rank_world(group: Any = None) -> tuple[int, int]:
    """This process's rank in ``group`` and the group's size (0, 1
    without a group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        group = _resolve(group)
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def _count(kind: str, sent: int, t0: float, group: Any) -> None:
    s = _STATS.setdefault(_name(group), {}).setdefault(
        kind, {"calls": 0, "bytes": 0, "ms": 0.0})
    s["calls"] += 1
    s["bytes"] += int(sent)
    s["ms"] += (time.perf_counter() - t0) * 1e3


def stats(by_group: bool = False) -> dict:
    """Calls, bytes sent to other ranks and ms, by collective kind (over
    both groups), or by group and kind with ``by_group``."""
    if by_group:
        return {name: {kind: dict(s) for kind, s in kinds.items()}
                for name, kinds in _STATS.items()}
    out: dict[str, dict[str, float]] = {}
    for kinds in _STATS.values():
        for kind, s in kinds.items():
            t = out.setdefault(kind, {"calls": 0, "bytes": 0, "ms": 0.0})
            for key in t:
                t[key] += s[key]
    return out


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


def all_gather(t: torch.Tensor, group: Any = None) -> torch.Tensor:
    """``(world, *t.shape)``: every rank's ``t`` in rank order, on
    ``t``'s device. Every rank passes the same shape and dtype."""
    group = _resolve(group)
    _, world = rank_world(group)
    if world == 1:
        return t[None]
    import torch.distributed as dist

    with _lock(group):
        t0 = time.perf_counter()
        mine = _bytes(t)
        parts = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(parts, mine, group=group)
        out = _typed(torch.stack(parts), t, (world,) + tuple(t.shape))
        _count("all_gather", mine.numel() * (world - 1), t0, group)
    return out


def gather(t: torch.Tensor, dst: int = 0,
           group: Any = None) -> torch.Tensor | None:
    """``(world, *t.shape)`` on rank ``dst`` (every rank's ``t`` in rank
    order, on ``t``'s device), None on the others. Every rank passes the
    same shape and dtype."""
    group = _resolve(group)
    rank, world = rank_world(group)
    if world == 1:
        return t[None]
    import torch.distributed as dist

    with _lock(group):
        t0 = time.perf_counter()
        mine = _bytes(t)
        parts = ([torch.empty_like(mine) for _ in range(world)]
                 if rank == dst else None)
        dist.gather(mine, parts, dst, group=group)
        out = (_typed(torch.stack(parts), t, (world,) + tuple(t.shape))
               if rank == dst else None)
        _count("gather", 0 if rank == dst else mine.numel(), t0, group)
    return out


def all_gather_object(obj: Any, group: Any = None) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    group = _resolve(group)
    _, world = rank_world(group)
    if world == 1:
        return [obj]
    import torch.distributed as dist

    with _lock(group):
        t0 = time.perf_counter()
        out = [None] * world
        dist.all_gather_object(out, obj, group=group)
        _count("all_gather_object", 0, t0, group)
    return out


def all_sum(x: int, group: Any = None) -> int:
    """The sum of an integer over the ranks."""
    group = _resolve(group)
    if rank_world(group)[1] == 1:
        return int(x)
    return int(all_gather(torch.tensor([int(x)], dtype=torch.int64),
                          group).sum())


def broadcast(t: torch.Tensor, src: int = 0,
              group: Any = None) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (on each rank's ``t`` device;
    the other ranks pass a tensor of the same shape and dtype)."""
    group = _resolve(group)
    rank, world = rank_world(group)
    if world == 1:
        return t
    import torch.distributed as dist

    with _lock(group):
        t0 = time.perf_counter()
        buf = _bytes(t) if rank == src else torch.empty(
            t.numel() * t.element_size(), dtype=torch.uint8)
        dist.broadcast(buf, src, group=group)
        out = _typed(buf, t, t.shape)
        _count("broadcast", buf.numel() * (world - 1) if rank == src else 0,
               t0, group)
    return out


def all_to_all(blocks: Sequence[torch.Tensor],
               group: Any = None) -> list[torch.Tensor]:
    """Variable-length row blocks between the ranks: ``blocks[r]``
    (``(n_r, *row)``) goes to rank ``r``; returns the block each rank
    sent here, in rank order, on ``blocks[0]``'s device. Every block of
    every rank has the same row shape and dtype."""
    group = _resolve(group)
    rank, world = rank_world(group)
    if len(blocks) != world:
        raise ValueError(f"{len(blocks)} blocks for {world} ranks")
    if world == 1:
        return [blocks[0]]
    import torch.distributed as dist

    like = blocks[0]
    row = tuple(like.shape[1:])
    with _lock(group):
        t0 = time.perf_counter()
        sends = [_bytes(b) for b in blocks]
        sizes = torch.tensor([s.numel() for s in sends], dtype=torch.int64)
        table = [torch.empty_like(sizes) for _ in range(world)]
        dist.all_gather(table, sizes, group=group)
        recv = [int(table[r][rank]) for r in range(world)]
        out = torch.empty(sum(recv), dtype=torch.uint8)
        dist.all_to_all_single(out, torch.cat(sends),
                               output_split_sizes=recv,
                               input_split_sizes=sizes.tolist(),
                               group=group)
        got = []
        for part in torch.split(out, recv):
            n = part.numel() // (like.element_size() * math.prod(row))
            got.append(_typed(part, like, (n,) + row))
        sent = sum(s.numel() for r, s in enumerate(sends) if r != rank)
        _count("all_to_all", sent + sizes.numel() * 8 * (world - 1), t0,
               group)
    return got


def barrier(group: Any = None) -> None:
    group = _resolve(group)
    if rank_world(group)[1] == 1:
        return
    import torch.distributed as dist

    with _lock(group):
        t0 = time.perf_counter()
        dist.barrier(group=group)
        _count("barrier", 0, t0, group)
