"""Rank meshes over `torch.distributed` (counterpart of `make_mesh` in
`repro/compat/mesh.py`).

The reference lays devices out on a named mesh and runs the serve inside
``shard_map``. Here each rank is a process, and a `RankMesh` names where it
sits: the axis names and sizes, this rank's coordinate on each axis, and one
process group per axis over the ranks that differ only in that coordinate
(``None`` for an axis of one rank, where the collectives send nothing).
Ranks are laid out row-major, the last axis fastest, as the reference's
devices are. `repro_torch.launch.mesh` starts the ranks.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence

import torch.distributed as dist

from repro_torch.distributed import collectives


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """This rank's place on a mesh of ranks."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    coords: tuple[int, ...]
    groups: tuple      # one ProcessGroup per axis, None where the axis has one rank

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of ``axis`` (None for an axis of one rank)."""
        return self.groups[self.axis_names.index(axis)]


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> RankMesh:
    """This rank's mesh of ``shape`` over the initialized default process
    group, whose world size must be the product of ``shape``. Every rank
    must call it, in the same order as its other group creations: it
    creates every axis group of the mesh (`dist.new_group` is collective
    over the world). Without an initialized process group only a mesh of
    one rank is allowed."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} / axis names {axes} length mismatch")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"mesh {shape} needs {n} ranks and no process group is "
                             "initialized (start the ranks with launch.mesh.spawn)")
        return RankMesh(axes, shape, (0,) * len(shape), (None,) * len(shape))
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"mesh {shape} needs {n} ranks, the process group has {world}")
    coords = _unravel(rank, shape)
    groups = []
    for ax, size in enumerate(shape):
        mine = None
        if size > 1:
            others = [range(s) for i, s in enumerate(shape) if i != ax]
            for rest in itertools.product(*others):
                line = [_ravel(rest[:ax] + (j,) + rest[ax:], shape) for j in range(size)]
                g = dist.new_group(line)
                collectives.label_group(g, axes[ax])
                if rank in line:
                    mine = g
        groups.append(mine)
    return RankMesh(axes, shape, coords, tuple(groups))


def _unravel(rank: int, shape: tuple[int, ...]) -> tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _ravel(coords: tuple[int, ...], shape: tuple[int, ...]) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


def one_rank(what: str) -> None:
    """Raise NotImplementedError when this process is one of several ranks:
    ``what`` runs on one rank only, as the reference's takes no mesh
    (ROADMAP.md §1)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"{what} runs on one rank; this process is rank {dist.get_rank()} of "
            f"{dist.get_world_size()} (the reference's takes no mesh; ROADMAP.md §1)")
