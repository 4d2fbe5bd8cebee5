"""A (batch x points) grid of ranks (counterpart of
`stratanet2_tpu/parallel/mesh.py` and of `make_mesh_2d` in
`parallel/point_sharded.py`): `torch.distributed` process groups take the
place of a JAX `Mesh`.

Ranks are laid out row-major, as `make_mesh_2d` lays out devices: rank
r = b * points + p sits in batch row b and point column p. The mesh holds
two groups, made once with `dist.new_group` (every rank makes every
group, in one order, as torch requires): all ranks (`group`, the axes
JAX's BatchNorm psums over) and the ranks of this rank's batch row
(`point_group`, which share a cloud's points). A group of one rank is
None: its collectives are the identity (`parallel/collectives.py`).
"""

from __future__ import annotations

import functools
from typing import Iterable, Optional, Union

import torch
import torch.distributed as dist

from stratanet2_tpu_torch.parallel import multihost
from stratanet2_tpu_torch.parallel.collectives import broadcast_

class Mesh:
    def __init__(self, batch: int, points: int, group, point_group):
        self.batch, self.points = batch, points
        self.group, self.point_group = group, point_group
        self.rank = multihost.rank()

    @property
    def size(self) -> int:
        return self.batch * self.points

    @property
    def batch_index(self) -> int:
        return self.rank // self.points

    @property
    def point_index(self) -> int:
        return self.rank % self.points

    def __repr__(self) -> str:
        return f"Mesh(batch={self.batch}, points={self.points}, rank={self.rank})"


def _new_group(ranks, world: int):
    if len(ranks) == 1:
        return None
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(list(ranks))


@functools.lru_cache(maxsize=None)
def make_mesh_2d(batch_devices: int, point_devices: int) -> Mesh:
    """The (batch x points) mesh over every rank of the process group (its
    world size must be batch_devices * point_devices). Memoized: one Mesh,
    and one set of groups, per shape for the life of the process group."""
    world = multihost.world_size()
    if batch_devices * point_devices != world:
        raise ValueError(
            f"a {batch_devices}x{point_devices} mesh needs {batch_devices * point_devices} "
            f"ranks, the process group has {world}"
        )
    point_groups = [_new_group(range(b * point_devices, (b + 1) * point_devices), world)
                    for b in range(batch_devices)]
    return Mesh(batch_devices, point_devices, _new_group(range(world), world),
                point_groups[multihost.rank() // point_devices])


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The 1-D data-parallel mesh over every rank."""
    world = multihost.world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested a {n_devices}-rank mesh, the process group has {world}")
    return make_mesh_2d(world, 1)


def _slice(x, axis: int, index: int, parts: int):
    n = x.shape[axis]
    if n % parts:
        raise ValueError(f"axis {axis} of size {n} does not divide over {parts} ranks")
    per = n // parts
    return x.narrow(axis, index * per, per) if isinstance(x, torch.Tensor) else \
        x.take(range(index * per, (index + 1) * per), axis=axis)


def shard_batch(mesh: Mesh, x):
    """This rank's rows of `x` (axis 0) over the batch axis."""
    return _slice(x, 0, mesh.batch_index, mesh.batch)


def shard_points(mesh: Mesh, x):
    """This rank's points of `x` (axis 1) over the point axis."""
    return _slice(x, 1, mesh.point_index, mesh.points)


def replicate(mesh: Mesh, tensors: Union[torch.nn.Module, torch.Tensor, Iterable[torch.Tensor]]):
    """Overwrite, in place, every tensor (a module's parameters and
    buffers) with rank 0's copy: afterwards they are equal bit for bit on
    every rank. Returns its argument."""
    if isinstance(tensors, torch.nn.Module):
        items = list(tensors.parameters()) + list(tensors.buffers())
    elif isinstance(tensors, torch.Tensor):
        items = [tensors]
    else:
        items = list(tensors)
    with torch.no_grad():
        for t in items:
            broadcast_(t.data, 0, mesh.group)
    return tensors
