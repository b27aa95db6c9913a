"""Mesh construction: one process's ordered list of torch devices.

Torch port of ``wdbx_tpu/parallel/mesh.py``. A JAX mesh is an array of
devices with named axes; here a ``Mesh`` is an ordered tuple of torch
devices laid row-major over named axes. Position ``i`` holds shard
``i % shards`` of replica group ``i // shards``, and a device may repeat:
8 logical shards can live on one card, or on the CPU, where each
position runs its own stage 1 on its own tensors.

Every position has a unique, stable name, ``"<device>#<position>"``
(``"cuda:0#3"``). The control plane (``ShardEngine``'s allocation,
health and recovery maps, the facade's ``heal``) keys on these names:
``str(device)`` would be the same for every position of one card. A
mesh derived from another (``ShardEngine.degraded_mesh``) keeps the
survivors' names.

Mesh size: ``make_mesh()`` with no count takes one position per visible
device (every CUDA device, or ``device`` when one is given), unless the
environment variable ``WDBX_TORCH_MESH_SIZE`` sets a number of logical
positions, laid round-robin over those devices. It is the port's
counterpart of ``--xla_force_host_platform_device_count``. An explicit
count always gets that many positions, round-robin.

Global mesh: when a ``torch.distributed`` group of more than one rank
is up (``ShardEngine.initialize`` joins one), ``make_mesh()`` spans the
ranks, as ``jax.devices()`` spans the processes of
``jax.distributed``. Each rank lays its own L positions (the count
above, over its own devices), the ranks exchange their lists once, and
rank r owns positions ``[r*L, (r+1)*L)``; every rank must hold the same
L. ``make_mesh(n)`` takes n positions in all, split into contiguous
blocks as evenly as it goes (7 on 2 ranks: 4 + 3, the lower ranks one
more; 3 on 4 ranks: one each for ranks 0-2, none for rank 3, as
``jax.devices()[:3]`` leaves the last process without a device).
``make_mesh2(r, s)`` lays r replica groups of s shards row-major over
the first ``r * s`` positions of the global list, as JAX's lays
``jax.devices()[:r*s]``: group g is positions ``[g*s, (g+1)*s)``,
whoever owns them. A group may span ranks, a rank may hold positions of
two groups, and the last ranks may hold none. Names stay
``"<device>#<global position>"``, unique across ranks. A mesh derived
from a global one (``ShardEngine.degraded_mesh``) keeps its survivors'
names and owners, so its ranks own unequal blocks (the degraded mesh of
7 on 2 ranks is 4 + 3), or none. The owners of a global mesh are
contiguous, ordered blocks. A rank holds tensors only for its own
positions (``Mesh.local_positions``, ``Mesh.local_groups``), possibly
none; every rank of the group still takes part in every collective of
the mesh (``Mesh.world``), a rank without a position with empty blocks.
The data plane between ranks is ``parallel/collective.py``. A ``Mesh``
built directly is this process's own, whatever the group.
"""

from __future__ import annotations

import math
import os
from typing import Any, Sequence

import torch

from wdbx_tpu_torch.parallel import collective

#: environment variable: logical mesh positions of ``make_mesh()``
MESH_SIZE_ENV = "WDBX_TORCH_MESH_SIZE"


def _canon(device: Any) -> torch.device:
    """A torch device with its index: ``"cuda"`` becomes the current
    card, so names of one card agree however the device was spelled."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is absent")
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Ordered devices over named axes (row-major), one name each."""

    def __init__(
        self,
        devices: Sequence[Any],
        axis_names: Sequence[str] = ("shard",),
        shape: Sequence[int] | None = None,
        names: Sequence[str] | None = None,
        owners: Sequence[int] | None = None,
    ):
        self.devices = tuple(_canon(d) for d in devices)
        self.axis_names = tuple(axis_names)
        sizes = tuple(shape) if shape is not None else (len(self.devices),)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"shape {sizes} does not match axes "
                             f"{self.axis_names}")
        if math.prod(sizes) != len(self.devices) or not self.devices:
            raise ValueError(f"shape {sizes} does not hold "
                             f"{len(self.devices)} devices")
        #: axis name -> size, as ``jax.sharding.Mesh.shape``
        self.shape = dict(zip(self.axis_names, sizes))
        self.names = tuple(names) if names is not None else tuple(
            f"{d}#{i}" for i, d in enumerate(self.devices))
        if len(self.names) != len(self.devices) or \
                len(set(self.names)) != len(self.names):
            raise ValueError(f"position names must be unique, one a "
                             f"device: {self.names}")
        #: this process's rank, and the rank owning each position (all
        #: this process's unless ``owners`` says otherwise)
        self.rank, group = collective.rank_world()
        self.owners = (tuple(int(o) for o in owners) if owners is not None
                       else (self.rank,) * len(self.devices))
        if len(self.owners) != len(self.devices):
            raise ValueError(f"{len(self.owners)} owners for "
                             f"{len(self.devices)} positions")
        if owners is not None:
            _check_blocks(self.owners)
        #: the positions whose tensors live in this process (maybe none)
        self.local_positions = tuple(
            i for i, o in enumerate(self.owners) if o == self.rank)
        #: the ranks taking part in this mesh's collectives: every rank
        #: of the group on a global mesh, whether it owns a position or
        #: not; 1 on a mesh of this process's own
        self.world = group if owners is not None and group > 1 else 1

    @property
    def is_global(self) -> bool:
        """Whether the mesh spans the ranks of a group (the same answer
        on every rank, whatever it holds)."""
        return self.world > 1

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_groups(self) -> tuple[int, ...]:
        """The replica groups (rows over the last axis) with a position
        in this process, in order."""
        shards = self.shape[self.axis_names[-1]]
        return tuple(sorted({p // shards for p in self.local_positions}))


def _check_blocks(owners: tuple[int, ...]) -> None:
    """The owners of a global mesh: contiguous, ordered blocks (a rank
    may own none)."""
    if list(owners) != sorted(owners):
        raise ValueError(f"a global mesh's ranks own contiguous, ordered "
                         f"blocks: {owners}")


def _base_devices(device: Any) -> list[torch.device]:
    if device is not None:
        return [_canon(device)]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to build the "
            "mesh on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _pool_size(base: list[torch.device]) -> int:
    env = os.environ.get(MESH_SIZE_ENV, "").strip()
    if env:
        n = int(env)
        if n < 1:
            raise ValueError(f"{MESH_SIZE_ENV}={env} must be at least 1")
        return n
    return len(base)


def _round_robin(base: list[torch.device], n: int) -> list[torch.device]:
    return [base[i % len(base)] for i in range(n)]


def make_mesh(
    n_devices: int | None = None, axis: str = "shard", device: Any = None
) -> Mesh:
    """A 1-D mesh of ``n_devices`` positions (default: one per visible
    device, or ``WDBX_TORCH_MESH_SIZE``) over the CUDA devices, or over
    ``device`` when one is given. In a group of several ranks: the
    global mesh, the default count a rank, ``n_devices`` in all."""
    base = _base_devices(device)
    n = _pool_size(base) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one position, got {n}")
    _, world = collective.rank_world()
    if world > 1:
        devices, owners = _global_positions(base, n, n_devices is not None)
        return Mesh(devices, (axis,), owners=owners)
    return Mesh(_round_robin(base, n), (axis,))


def _global_positions(base: list[torch.device], n: int, total: bool):
    """The devices and owning ranks of a mesh over every rank of the
    group: ``n`` positions a rank (``n`` in all when ``total``, the
    lower ranks one more where they do not split evenly, none past the
    n-th rank where n is below the rank count), this rank's
    round-robin over its own devices, exchanged once; each rank owns the
    next contiguous block."""
    rank, world = collective.rank_world()
    if total:
        n = n // world + (rank < n % world)
    mine = [str(d) for d in _round_robin(base, n)]
    lists = collective.all_gather_object(mine)
    counts = [len(x) for x in lists]
    if not total and len(set(counts)) != 1:
        raise ValueError(
            f"every rank of a global mesh holds the same number of "
            f"positions; the ranks hold {counts} (set {MESH_SIZE_ENV} or "
            "the visible devices alike on every rank)")
    devices = [torch.device(d) for x in lists for d in x]
    owners = [r for r, x in enumerate(lists) for _ in x]
    return devices, owners


def make_mesh2(
    replicas: int,
    shards: int | None = None,
    axes: tuple[str, str] = ("replica", "shard"),
    device: Any = None,
) -> Mesh:
    """2-D mesh for replicated serving: the corpus shards over
    ``axes[1]`` and replicates over ``axes[0]``; query batches split
    over ``axes[0]``. ``shards`` defaults to the mesh size (see
    ``make_mesh``) over ``replicas``. In a group of several ranks the
    mesh is global, laid row-major over the first ``replicas * shards``
    positions of the ranks' list as ``jax.devices()[:r*s]`` lays it:
    group g is positions ``[g*shards, (g+1)*shards)``, whichever ranks
    own them."""
    if replicas < 1 or (shards is not None and shards < 1):
        raise ValueError(f"a {replicas} x {shards} mesh is empty")
    base = _base_devices(device)
    if collective.rank_world()[1] == 1:
        if shards is None:
            total = _pool_size(base)
            if total % replicas:
                raise ValueError(
                    f"{total} positions not divisible by {replicas} replicas"
                )
            shards = total // replicas
        return Mesh(_round_robin(base, replicas * shards), axes,
                    shape=(replicas, shards))
    devices, owners = _global_positions(base, _pool_size(base), False)
    total = len(devices)
    if shards is None:
        if total % replicas:
            raise ValueError(f"{total} positions not divisible by "
                             f"{replicas} replicas")
        shards = total // replicas
    need = replicas * shards
    if need > total:
        raise ValueError(f"requested {need} positions, {total} visible")
    return Mesh(devices[:need], axes, shape=(replicas, shards),
                owners=owners[:need])
