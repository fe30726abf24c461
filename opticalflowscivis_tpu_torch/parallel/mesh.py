"""Process mesh and the data-parallel collectives of a train step.

The counterpart of the reference package's ``parallel/mesh.py``.  Axes:
- ``data``  — data parallelism (the reference's only strategy: DDP over NCCL,
  Flow-2D/train.py:567).  Each rank computes the loss on its rows of the
  global batch; gradients are averaged over the axis by one all-reduce.
- ``space`` — spatial sharding of 3-D volumes along depth
  (``parallel.spatial``).

One process drives one device.  Rank ``r`` sits at ``(d, s) = divmod(r,
n_space)``, as the reference reshapes its device list to ``(n_data,
n_space)``.  Under gloo, a CUDA tensor goes through the host for each
collective (gloo's point-to-point ops take CPU tensors only); under NCCL it
stays on the card.

A train step's means and gradients reduce over the data axis, or over the
whole mesh when the space axis shards the volumes (``Mesh.spatial``: each
rank's loss is then a mean over its rows and slices, and the step's is the
mean over all ranks, ``parallel.spatial``).  With ``n_space > 1`` and
``spatial`` off, every rank of a space group runs the same step on the same
rows (the reference's trainer replicates the batch over ``space`` then).

Terms of a loss that are not linear in the batch (a ratio of sums over the
batch, a guard on a batch mean) would differ between one rank on the global
batch and k ranks each on its part.  ``Mesh.batch_ratio`` and
``Mesh.batch_mean`` give every rank the global value, with a local term
whose gradient, averaged over the ranks, is the global one; their
collectives run in the forward only, so the backward has none.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (no-op for ``group`` None)."""
    if group is None:
        return t
    if _via_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, group) -> torch.Tensor:
    """Overwrite ``t`` with the copy of the group's first rank."""
    if group is None:
        return t
    src = 0 if group is dist.group.WORLD else dist.get_global_rank(group, 0)
    if _via_host(t, group):
        host = t.cpu()
        dist.broadcast(host, src=src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an ``(n_data, n_space)`` mesh and its two groups
    (None where the axis has one rank).  ``spatial``: the space axis shards
    the volumes, so that a step reduces over the whole mesh."""

    n_data: int
    n_space: int
    rank: int
    data_group: Any = None
    space_group: Any = None
    spatial: bool = False

    @property
    def world_group(self):
        """The group of the whole mesh (None for a mesh of one rank)."""
        return dist.group.WORLD if self.n_data * self.n_space > 1 else None

    @property
    def _reduction(self) -> tuple[Any, int]:
        """(group, ranks) a step's means and gradients reduce over."""
        if self.spatial and self.n_space > 1:
            return self.world_group, self.n_data * self.n_space
        return self.data_group, self.n_data

    @property
    def data_index(self) -> int:
        return self.rank // self.n_space

    @property
    def space_index(self) -> int:
        return self.rank % self.n_space

    @property
    def is_writer(self) -> bool:
        """Rank 0 alone writes files."""
        return self.rank == 0

    # -- the collectives of a train step ---------------------------------------
    def batch_ratio(self, num: torch.Tensor, den: torch.Tensor, eps: float = 0.0,
                    den_batched: bool = True) -> torch.Tensor:
        """``sum(num) / (sum(den) + eps)`` over the global batch, where ``num``
        (and ``den`` when ``den_batched``) are this rank's sums over its part;
        a ``den`` that is not such a sum is the same on every rank."""
        group, k = self._reduction
        sums = torch.stack([num.detach().float(), den.detach().float()])
        all_reduce_(sums, group)
        if not den_batched:
            sums[1] = den.detach().float()
        d = sums[1] + eps
        value = sums[0] / d
        # d(N/D) = dN/D - N/D^2 dD; each rank holds 1/k of N (and of D when
        # batched), and the gradients are averaged over k ranks
        local = (k * num - (k if den_batched else 1) * value * den) / d
        return value + (local - local.detach())

    def batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of a per-rank mean ``x`` (over its rows, and
        its slices when ``spatial``): the global mean, with this rank's
        gradient."""
        group, k = self._reduction
        total = x.detach().float().clone()
        all_reduce_(total, group)
        return total / k + (x - x.detach())

    def mean_values(self, values: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Each detached 0-d value averaged over the ranks a step reduces
        over, in one all-reduce."""
        if not values:
            return values
        group, k = self._reduction
        stacked = torch.stack([v.detach().float() for v in values.values()])
        all_reduce_(stacked, group)
        stacked /= k
        return dict(zip(values, stacked.unbind()))

    def average_gradients(self, params) -> None:
        """Average the gradients of ``params`` over the ranks a step reduces
        over, in one all-reduce of a flat buffer; parameters without a
        gradient stay so (every rank runs the same graph, so the same ones
        have none)."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        group, k = self._reduction
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        all_reduce_(flat, group)
        flat /= k
        offset = 0
        for g in grads:
            n = g.numel()
            g.copy_(flat[offset : offset + n].view_as(g))
            offset += n

    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Give every rank of the mesh rank 0's parameters and buffers."""
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                broadcast_(t.data, self.world_group)

    def barrier(self, device: torch.device) -> None:
        """Wait until every rank of the mesh is here."""
        all_reduce_(torch.zeros(1, device=device), self.world_group)

    def agree(self, flag: bool, device: torch.device) -> bool:
        """Rank 0's ``flag`` on every rank of the mesh (a decision all ranks
        must take together, such as ending the run)."""
        t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
        return bool(broadcast_(t, self.world_group).item())


def make_mesh(n_data: int | None = None, n_space: int = 1, spatial: bool = False) -> Mesh:
    """The ``(n_data, n_space)`` mesh over the default process group, which
    must be initialised (``parallel.multihost.initialize_multihost``) with
    ``n_data * n_space`` processes; ``n_data`` None takes them all.  Every
    rank calls this in the same order (it creates the subgroups)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised default process group: launch with "
            "torchrun (`torchrun --nproc_per_node k ...`) or call "
            "parallel.initialize_multihost first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_space
    if n_data < 1 or n_space < 1 or n_data * n_space != world:
        raise ValueError(f"mesh ({n_data}, {n_space}) does not cover the {world} processes")
    rank = dist.get_rank()

    def group(ranks: list[int]):
        if len(ranks) == world:
            return dist.group.WORLD
        return dist.new_group(ranks) if len(ranks) > 1 else None

    data_group = space_group = None
    for s in range(n_space):  # every rank creates every group, in one order
        g = group([d * n_space + s for d in range(n_data)])
        if rank % n_space == s:
            data_group = g
    for d in range(n_data):
        g = group([d * n_space + s for s in range(n_space)])
        if rank // n_space == d:
            space_group = g
    return Mesh(n_data, n_space, rank, data_group, space_group, spatial and n_space > 1)


def trainer_mesh(n_data: int | None, n_space: int = 1, spatial: bool = False) -> Mesh | None:
    """The mesh a trainer runs on: None (one device, no collectives) without
    an initialised process group when the mesh has one rank; else the
    ``(n_data, n_space)`` mesh over the default group, whose size must be
    ``n_data * n_space`` (``n_data`` None takes what ``n_space`` leaves).
    ``spatial``: the space axis shards the volumes.  Never trains on one
    device when the mesh asks for more."""
    if n_space < 1:
        raise ValueError(f"n_space must be >= 1, got {n_space}")
    if not (dist.is_available() and dist.is_initialized()):
        if n_data in (None, 1) and n_space == 1:
            return None
        k = (n_data or 1) * n_space
        what = f"n_data={n_data}" + (f", n_space={n_space}" if n_space > 1 else "")
        raise RuntimeError(
            f"{what} needs a default process group of {k} processes, and "
            f"none is initialised: launch with `torchrun --nproc_per_node {k} -m "
            "opticalflowscivis_tpu_torch.cli train --config_json cfg.json` (the CLI "
            "initialises the group from torchrun's environment; add --cpu for gloo), "
            "or call parallel.initialize_multihost in each process first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_space
    if n_data * n_space != world:
        raise RuntimeError(
            f"n_data={n_data}, n_space={n_space}, but the default process group has {world} "
            "processes: launch one process per rank of the (n_data, n_space) mesh")
    return make_mesh(n_data, n_space, spatial)


def data_parallel_mesh(n_data: int | None) -> Mesh | None:
    """The data-parallel trainers' mesh: ``trainer_mesh(n_data)``, the
    ``(n_data, 1)`` mesh, or None on one device."""
    return trainer_mesh(n_data)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch: a tensor, a numpy array, or dicts,
    lists and tuples of them, each leading with the global batch axis."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    if not isinstance(batch, (torch.Tensor, np.ndarray)):
        raise TypeError(f"cannot shard a {type(batch).__name__}")
    b = batch.shape[0]
    if b % mesh.n_data:
        raise ValueError(f"batch {b} does not split over {mesh.n_data} data-parallel ranks")
    rows = b // mesh.n_data
    return batch[mesh.data_index * rows : (mesh.data_index + 1) * rows]
