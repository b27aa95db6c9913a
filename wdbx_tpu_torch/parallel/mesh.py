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
"""

from __future__ import annotations

import math
import os
from typing import Any, Sequence

import torch

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

    @property
    def size(self) -> int:
        return len(self.devices)


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
    ``device`` when one is given."""
    base = _base_devices(device)
    n = _pool_size(base) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one position, got {n}")
    return Mesh(_round_robin(base, n), (axis,))


def make_mesh2(
    replicas: int,
    shards: int | None = None,
    axes: tuple[str, str] = ("replica", "shard"),
    device: Any = None,
) -> Mesh:
    """2-D mesh for replicated serving: the corpus shards over
    ``axes[1]`` and replicates over ``axes[0]``; query batches split
    over ``axes[0]``. ``shards`` defaults to the mesh size (see
    ``make_mesh``) over ``replicas``."""
    base = _base_devices(device)
    if shards is None:
        total = _pool_size(base)
        if total % replicas:
            raise ValueError(
                f"{total} positions not divisible by {replicas} replicas"
            )
        shards = total // replicas
    if replicas < 1 or shards < 1:
        raise ValueError(f"a {replicas} x {shards} mesh is empty")
    return Mesh(_round_robin(base, replicas * shards), axes,
                shape=(replicas, shards))
