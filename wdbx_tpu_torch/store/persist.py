"""Per-position checkpoint backend for index slabs (``PERSIST_BACKEND=orbax``).

Torch port of ``wdbx_tpu/store/persist.py``. The npz path gathers the
whole slab to one host array; this backend writes each mesh position's
tensors from that position's own device into a file of its own
(``torch.save``), plus a JSON sidecar, so no host array ever holds more
than one position. Load puts position ``i`` back on ``devices[i]``.

The JAX package's backend is orbax / TensorStore, which needs JAX. The
port keeps its config value and its directory (``<path>.orbax/``) but
not its format: neither package reads the other's per-position
checkpoint, and a directory orbax wrote raises ``ValueError`` here. The
npz checkpoint stays the format both packages read.

On a mesh spanning ranks each rank writes and reads only the files of
shards it holds (``positions`` of ``total``, maybe none; a shard's file
once a directory): the lead rank clears the directory, every rank
writes its files, the lead writes the sidecar, with a barrier between
the steps on every rank. Where the ranks share the
checkpoint's directory, as JAX's multi-controller orbax checkpoints do,
rank 0 leads; where each rank has its own (its own data directory),
each leads in its own.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Sequence

import torch

from wdbx_tpu_torch.parallel import collective

#: the sidecar that marks a directory as this backend's
SIDECAR = "wdbx_positions.json"
FORMAT = "wdbx_tpu_torch.per_position.v1"


def _dir(path: str) -> str:
    return os.path.abspath(path) + ".orbax"


def save_arrays(path: str, arrays: dict[str, Sequence[torch.Tensor]],
                positions: Sequence[int] | None = None,
                total: int | None = None, lead: bool | None = None,
                split: bool | None = None) -> None:
    """Write ``arrays`` (name -> one tensor a position) as one file a
    position, each from its own device, plus the sidecar. ``positions``
    (default: all) numbers the given tensors among the checkpoint's
    ``total``. ``split`` (default: fewer than ``total`` given) says that
    the ranks share the writing: every rank then calls this, with the
    files it writes (maybe none), and the ranks meet at barriers around
    the writes. ``lead`` says whether this rank clears the directory and
    writes the sidecar (default: rank 0, or the only writer)."""
    d = _dir(path)
    counts = {len(v) for v in arrays.values()}
    if len(counts) != 1:
        raise ValueError(f"arrays disagree on the position count: {counts}")
    (n,) = counts
    positions = list(range(n)) if positions is None else list(positions)
    total = n if total is None else int(total)
    if len(positions) != n:
        raise ValueError(f"{n} tensors for positions {positions}")
    if split is None:
        split = total != n
    if lead is None:
        lead = not split or collective.rank_world()[0] == 0
    if lead:
        if os.path.isdir(d):
            shutil.rmtree(d)
        os.makedirs(d)
    if split:
        collective.barrier()
    for i, p in enumerate(positions):
        torch.save({name: arrays[name][i].detach() for name in arrays},
                   os.path.join(d, f"position{p:05d}.pt"))
    if split:
        collective.barrier()
    if lead:
        with open(os.path.join(d, SIDECAR), "w") as f:
            json.dump({"format": FORMAT, "positions": total,
                       "arrays": sorted(arrays)}, f)


def _positions(path: str) -> int | None:
    """Position count of the checkpoint at ``path`` (None if absent)."""
    d = _dir(path)
    if not os.path.isdir(d):
        return None
    side = os.path.join(d, SIDECAR)
    if not os.path.exists(side):
        raise ValueError(
            f"{d} is not a wdbx_tpu_torch per-position checkpoint (no "
            f"{SIDECAR}; an orbax checkpoint written by wdbx_tpu?): the "
            "packages do not read each other's sharded checkpoints, only "
            "npz (PERSIST_BACKEND=npz)"
        )
    with open(side) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{d}: unknown checkpoint format {meta.get('format')}")
    return int(meta["positions"])


def load_arrays(
    path: str, devices: Sequence[Any], positions: Sequence[int] | None = None,
    total: int | None = None,
) -> dict[str, list[torch.Tensor]] | None:
    """Restore name -> one tensor a position, ``positions[i]`` (default:
    all) onto ``devices[i]``; None if no checkpoint exists at ``path``.
    The checkpoint must have ``total`` positions (default
    ``len(devices)``)."""
    positions = (list(range(len(devices))) if positions is None
                 else list(positions))
    total = len(devices) if total is None else int(total)
    n = _positions(path)
    if n is None:
        return None
    if n != total:
        raise ValueError(
            f"{_dir(path)} holds {n} positions, the target has "
            f"{total}: per-position checkpoints load onto the same "
            "shard count (npz moves between counts)"
        )
    out: dict[str, list[torch.Tensor]] = {}
    for p, dev in zip(positions, devices):
        part = torch.load(os.path.join(_dir(path), f"position{p:05d}.pt"),
                          map_location=torch.device(dev), weights_only=True)
        for name, t in part.items():
            out.setdefault(name, []).append(t)
    return out


def exists(path: str) -> bool:
    return os.path.isdir(_dir(path))
