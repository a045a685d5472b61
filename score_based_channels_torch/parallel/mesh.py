"""The 1-D ('data',) mesh over processes, the counterpart of the JAX
package's parallel/mesh.py.

The JAX package shards a batch's leading axis over the devices of one
mesh and lets XLA insert the collectives. Here each rank is one process
with one device: `Mesh.rows` is this rank's share of a batch's rows,
`Mesh.gather` all-gathers every rank's rows back into the batch order,
and `Mesh.mean` all-reduces a mean (the gradient's psum over a sharded
mean). Without a process group `make_mesh` gives a mesh of one rank,
whose collectives are no-ops.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    rank: int = 0
    world_size: int = 1
    group: Optional[object] = None  # None: the default group

    @property
    def distributed(self) -> bool:
        """True when a process group carries the collectives. A mesh of one
        rank needs none; one of more ranks without a group is an error
        rather than a silent run on this rank's rows alone."""
        if dist.is_available() and dist.is_initialized():
            return True
        if self.world_size > 1:
            raise RuntimeError(f"a mesh of {self.world_size} ranks needs an "
                               f"initialised process group")
        return False

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of n = k * world_size rows."""
        if n % self.world_size:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{self.world_size} ranks")
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of x (its leading axis)."""
        return x[self.rows(x.shape[0])]

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's x (equal shapes), concatenated along `dim` in rank
        order."""
        if not self.distributed:
            return x
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(self.world_size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def mean(self, tensors) -> None:
        """All-reduce each tensor to its mean over the ranks, in place, in
        one collective."""
        tensors = list(tensors)
        if not self.distributed or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        flat /= self.world_size
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier(group=self.group)


def make_mesh() -> Mesh:
    """The mesh of the initialised process group (every rank, one device
    each), or of this process alone when there is none."""
    if dist.is_available() and dist.is_initialized():
        return Mesh(dist.get_rank(), dist.get_world_size())
    return Mesh()


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0):
    """Pad the axis to a multiple by repeating rows from the start;
    returns (padded, n_valid)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    idx = torch.arange(rem, device=x.device) % n
    return torch.cat([x, x.index_select(axis, idx)], dim=axis), n


def data_sharding(mesh: Mesh, ndim: int):
    """The leading-axis split of an ndim tensor as a function: x -> this
    rank's rows (the JAX package's NamedSharding over ('data', None...))."""
    def shard(x: torch.Tensor) -> torch.Tensor:
        if x.dim() != ndim:
            raise ValueError(f"expected {ndim} dims, got {tuple(x.shape)}")
        return mesh.shard(x)

    return shard


def replicate(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Rank 0's x on every rank (a broadcast, in place; x unchanged when
    there is no group)."""
    if mesh.distributed:
        dist.broadcast(x, src=dist.get_global_rank(mesh.group, 0)
                       if mesh.group is not None else 0, group=mesh.group)
    return x


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of every tensor of a dict, list or tuple (0-d
    tensors and other leaves whole)."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dim() > 0:
        return mesh.shard(tree)
    return tree
