"""Spatial sharding of volumes along depth: the batch split, halo exchange,
gather and scatter along the ``space`` axis, and the sharded warp.

The counterpart of the reference package's ``parallel/spatial.py``.  The
reference could not train on Droplet-3D at native 256^3 and downsampled
everything to 64^3 (Datasets/read_data.py:149-159); sharding the volume's
depth over the ``space`` axis of the mesh is the answer here too.

- ``volume_batch_sharding``: this rank's part of a global batch, its rows on
  ``data`` and its ``D / n_space`` slices of the first spatial axis on
  ``space`` (the reference's ``P('data', None, 'space')``).  Where the
  reference lets GSPMD partition every layer of IFNet-3D after it, each layer
  here has a depth-sharded form (``models.layers``, ``ops.resize``,
  ``models.ifnet``, the losses) that takes a ``DepthShard``.
- ``halo_exchange``: each rank extends its shard by its neighbours' edge
  slices along one dimension, exchanged point to point
  (``batch_isend_irecv``); differentiable, its backward sends each halo's
  gradient back to the rank that owns the slices (the transpose of the
  reference's ``ppermute``).
- ``gather_space`` / ``scatter_space``: the whole tensor on every rank of the
  space group, and this rank's slices of a whole tensor; the levels too
  coarse to shard are computed whole between the two.
- ``backward_warp3d_sharded``: the trilinear warp of a depth-sharded volume,
  the ``warp3d`` kernel run on each rank's haloed shard; its only
  communication is the 2·(r_z+1)-slice halo.

How a sharded step counts its loss and gradients: each rank's loss is the sum
of its terms, each a mean over this rank's rows and slices (a term that every
rank of a space group computes whole, such as ``l1_reg`` or a term on gathered
tensors, counts whole on each); the step's loss is the mean of the ranks'
losses over the whole mesh, and so are its gradients (``Mesh.spatial``).  With
equal shards the mean of the ranks' means is the mean over the global batch
and volume.  A term that is a sum over voxels, not a mean, counts
``n_space`` times its rank's sum.  The backward of each collective follows:
a halo's gradient is added where the slices came from, a gather's is summed
over the space group (every rank's loss reads the whole gathered tensor), a
scatter's is zero outside this rank's slices.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from opticalflowscivis_tpu_torch.ops.kernels.warp import warp3d
from opticalflowscivis_tpu_torch.parallel.mesh import Mesh, all_reduce_, shard_batch

BOUNDARIES = ("shift", "edge", "zeros")

# this process's collectives along the space axis, forward and backward: a
# halo exchange, a gather's all-gather or its backward's all-reduce
COLLECTIVES: dict[str, int] = {"halo_exchange": 0, "gather": 0}


def _group_rank(group) -> tuple[int, int]:
    """(this rank's index in ``group``, the group's size); (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _global(group, index: int) -> int:
    return index if group is dist.group.WORLD else dist.get_global_rank(group, index)


def _exchange(group, like: torch.Tensor, dim: int,
              to_left: torch.Tensor | None, from_left: int,
              to_right: torch.Tensor | None, from_right: int,
              ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Send ``to_left`` / ``to_right`` to the previous / next rank of ``group``
    and receive ``from_left`` / ``from_right`` slices (along ``dim``, shaped
    like ``like`` otherwise) from them, in one ``batch_isend_irecv``.  None
    and 0 mean nothing that way.  Under gloo the slices go through the host;
    under NCCL they stay on the device."""
    if to_left is None and to_right is None and not from_left and not from_right:
        return None, None  # a group of one, or a side with no halo
    COLLECTIVES["halo_exchange"] += 1
    idx, _ = _group_rank(group)
    host = like.is_cuda and dist.get_backend(group) == "gloo"
    device = torch.device("cpu") if host else like.device

    def buffer(k):
        sizes = list(like.shape)
        sizes[dim] = k
        return torch.empty(sizes, dtype=like.dtype, device=device)

    ops, got = [], [None, None]
    for side, sent, k, peer in ((0, to_left, from_left, idx - 1),
                                (1, to_right, from_right, idx + 1)):
        if sent is not None:
            sent = sent.contiguous()
            ops.append(dist.P2POp(dist.isend, sent.cpu() if host else sent,
                                  _global(group, peer), group))
        if k:
            got[side] = buffer(k)
            ops.append(dist.P2POp(dist.irecv, got[side], _global(group, peer), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(None if t is None else t.to(like.device) for t in got)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, before: int, after: int, dim: int, boundary: str):
        idx, n = _group_rank(group)
        length = x.shape[dim]
        ctx.group, ctx.halo, ctx.dim, ctx.boundary, ctx.length = (
            group, (before, after), dim, boundary, length)
        # my first `after` slices become the previous rank's right halo, my
        # last `before` slices the next rank's left halo
        from_left, from_right = _exchange(
            group, x, dim,
            x.narrow(dim, 0, after) if idx > 0 and after else None,
            before if idx > 0 else 0,
            x.narrow(dim, length - before, before) if idx < n - 1 and before else None,
            after if idx < n - 1 else 0)
        if from_left is None and before:
            from_left = _boundary_fill(x, before, dim, boundary, at_start=True)
        if from_right is None and after:
            from_right = _boundary_fill(x, after, dim, boundary, at_start=False)
        return torch.cat([t for t in (from_left, x, from_right) if t is not None], dim=dim)

    @staticmethod
    def backward(ctx, g):
        group, (before, after), dim, length = ctx.group, ctx.halo, ctx.dim, ctx.length
        idx, n = _group_rank(group)
        g_left, g_right = g.narrow(dim, 0, before), g.narrow(dim, before + length, after)
        dx = g.narrow(dim, before, length).clone()
        # my left halo came from the previous rank's last slices: its gradient
        # goes back there, and the next rank's left-halo gradient comes here
        from_left, from_right = _exchange(
            group, g, dim,
            g_left if idx > 0 and before else None, after if idx > 0 else 0,
            g_right if idx < n - 1 and after else None, before if idx < n - 1 else 0)
        if from_right is not None:
            dx.narrow(dim, length - before, before).add_(from_right)
        if from_left is not None:
            dx.narrow(dim, 0, after).add_(from_left)
        if idx == 0 and before:
            _boundary_grad(dx, g_left, before, dim, ctx.boundary, at_start=True)
        if idx == n - 1 and after:
            _boundary_grad(dx, g_right, after, dim, ctx.boundary, at_start=False)
        return dx, None, None, None, None, None


def _boundary_fill(x: torch.Tensor, halo: int, dim: int, boundary: str,
                   at_start: bool) -> torch.Tensor:
    """The halo of a shard at the global boundary, from its own data."""
    if boundary == "shift":
        return x.narrow(dim, 0 if at_start else x.shape[dim] - halo, halo)
    edge = x.narrow(dim, 0 if at_start else x.shape[dim] - 1, 1)
    sizes = list(x.shape)
    sizes[dim] = halo
    if boundary == "edge":
        return edge.expand(sizes)
    return x.new_zeros(sizes)


def _boundary_grad(dx: torch.Tensor, g_halo: torch.Tensor, halo: int, dim: int,
                   boundary: str, at_start: bool) -> None:
    """Add a global-boundary halo's gradient to the slices it was filled from."""
    length = dx.shape[dim]
    if boundary == "shift":
        dx.narrow(dim, 0 if at_start else length - halo, halo).add_(g_halo)
    elif boundary == "edge":
        dx.narrow(dim, 0 if at_start else length - 1, 1).add_(g_halo.sum(dim, keepdim=True))


def halo_exchange(x: torch.Tensor, group, halo: int | tuple[int, int], dim: int = 0,
                  boundary: str = "shift") -> torch.Tensor:
    """Pad this rank's shard with slices from each neighbour along ``dim``:
    ``halo`` of the previous rank's last slices before and of the next rank's
    first after, or ``(before, after)`` slices (ranks ordered as in
    ``group``; None is a group of one).  At the global boundary the halo is
    filled by ``boundary``:

    - ``'shift'``: the shard's own first/last slices (the full-array
      analogue is ``concat([x[:halo], x, x[-halo:]])``);
    - ``'edge'``: the outermost slice repeated — matching edge padding of the
      full array, i.e. grid-sample 'border' semantics;
    - ``'zeros'``: zeros (zero padding of the full array, a convolution's;
      not in the reference, which masks instead, ``ops/warp.py:217-238`` there).

    Differentiable in ``x``.  Every rank of ``group`` calls it with the same
    sizes, in the same order as its other collectives.
    """
    if boundary not in BOUNDARIES:
        raise ValueError(f"boundary must be one of {BOUNDARIES}, got {boundary!r}")
    dim = dim % x.dim()
    before, after = (halo, halo) if isinstance(halo, int) else halo
    length = x.shape[dim]
    if not (0 <= before <= length and 0 <= after <= length and before + after > 0):
        raise ValueError(f"halo {halo} must be in [1, {length}] (the shard's size)")
    return _HaloExchange.apply(x, group, before, after, dim, boundary)


def _all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x`` (all the same shape), in the group's order."""
    COLLECTIVES["gather"] += 1
    host = x.is_cuda and dist.get_backend(group) == "gloo"
    sent = x.detach().contiguous()
    sent = sent.cpu() if host else sent
    parts = [torch.empty_like(sent) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, sent, group=group)
    return [p.to(x.device) for p in parts] if host else parts


class _GatherSpace(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim: int):
        ctx.group, ctx.dim, ctx.length = group, dim, x.shape[dim]
        return torch.cat(_all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        # every rank's loss read the whole gathered tensor: sum the cotangents
        # over the group, keep this rank's slices
        total = g.contiguous().clone()
        COLLECTIVES["gather"] += 1
        all_reduce_(total, ctx.group)
        idx, _ = _group_rank(ctx.group)
        return total.narrow(ctx.dim, idx * ctx.length, ctx.length), None, None


def gather_space(x: torch.Tensor, mesh: Mesh, dim: int = 2) -> torch.Tensor:
    """The whole tensor along ``dim`` on every rank of the space group: the
    ranks' shards concatenated in the order of ``mesh.space_index``.
    Differentiable: the backward sums the cotangent over the space group and
    keeps this rank's slices (the gathered tensor is computed with on every
    rank, and each rank's loss counts whole; module docstring)."""
    if mesh.space_group is None:
        return x
    return _GatherSpace.apply(x, mesh.space_group, dim % x.dim())


def scatter_space(x: torch.Tensor, mesh: Mesh, dim: int = 2) -> torch.Tensor:
    """This rank's slices of a whole tensor along ``dim`` (computed alike on
    every rank of the space group).  The backward is zero outside them, so
    that the ranks' gradients add up to the whole tensor's once."""
    n = x.shape[dim] // mesh.n_space
    if n * mesh.n_space != x.shape[dim]:
        raise ValueError(f"size {x.shape[dim]} does not split over {mesh.n_space} space ranks")
    return x.narrow(dim, mesh.space_index * n, n)


@dataclasses.dataclass(frozen=True)
class DepthShard:
    """What a depth-sharded layer needs: the mesh, whose space group holds the
    shards in order, and the sharded axis of its channels-first input (2, the
    first spatial axis: depth of a volume, height of a 2-D frame)."""

    mesh: Mesh
    dim: int = 2

    @property
    def n(self) -> int:
        return self.mesh.n_space

    @property
    def index(self) -> int:
        return self.mesh.space_index

    def halo(self, x: torch.Tensor, halo, boundary: str, dim: int | None = None):
        return halo_exchange(x, self.mesh.space_group, halo,
                             self.dim if dim is None else dim, boundary)

    def gather(self, x: torch.Tensor, dim: int | None = None) -> torch.Tensor:
        return gather_space(x, self.mesh, self.dim if dim is None else dim)

    def scatter(self, x: torch.Tensor, dim: int | None = None) -> torch.Tensor:
        return scatter_space(x, self.mesh, self.dim if dim is None else dim)

    def pad_to_whole(self, x: torch.Tensor, dim: int | None = None) -> torch.Tensor:
        """This rank's shard placed in zeros of the whole tensor's size (no
        communication): the gather form's flow."""
        dim = self.dim if dim is None else dim
        n = x.shape[dim]
        pad = [0, 0] * (x.dim() - 1 - dim) + [self.index * n, (self.n - 1 - self.index) * n]
        return F.pad(x, pad)


def volume_batch_sharding(batch, mesh: Mesh, n_leading: int = 2):
    """This rank's part of a global batch ``[B, slots, *S, C]``
    (``n_leading=2``) or ``[B, *S, C]`` (``n_leading=1``): its rows on the
    data axis and its ``S[0] / n_space`` slices of the first spatial axis on
    the space axis, in the order of ``mesh.space_index`` (the reference's
    ``P('data', None, 'space')`` whatever the rank of ``S``).  A tensor or a
    numpy array."""
    rows = shard_batch(batch, mesh)
    depth = rows.shape[n_leading]
    n = depth // mesh.n_space
    if n * mesh.n_space != depth:
        raise ValueError(
            f"the first spatial axis ({depth}) does not split over n_space={mesh.n_space} "
            "ranks: pad the data to a multiple of n_space (TrainConfig.pad_multiple) or "
            "choose an n_space that divides it")
    lo = mesh.space_index * n
    return rows[(slice(None),) * n_leading + (slice(lo, lo + n),)]


def backward_warp3d_sharded(
    img: torch.Tensor,
    flow: torch.Tensor,
    mesh: Mesh,
    r_z: int = 8,
    padding: str = "border",
    r_yx: int = 0,
) -> torch.Tensor:
    """Depth-sharded trilinear warp: a halo exchange, then ``warp3d`` on the
    haloed shard.

    ``img [B, C, Z_local, Y, X]`` and ``flow [B, 3, Z_local, Y, X]`` (dz, dy,
    dx) are this rank's depth shard of the volume (its rows of the batch on
    the data axis, its ``Z / n_space`` slices on the space axis, in the order
    of ``mesh.space_index``); the result is the same shard of the warped
    volume.  Each rank receives ``mz = r_z + 1`` slices from each neighbour:
    with ``|flow_z|`` clipped to ``r_z`` (as the unsharded warp clips it), no
    sample leaves the haloed shard.  At the volume's global z ends the halo
    holds the edge slice (``border``) or zeros (``zeros``), so the kernel's
    own padding gives the unsharded warp's answer.  The kernel forms each z
    coordinate in the volume's frame (``warp3d``'s ``z_offset``): a shard's
    samples are the unsharded warp's bit for bit, also where a coordinate
    lies a rounding away from an integer, across which the z gradient jumps.  ``r_yx`` 0 leaves the
    in-plane flow unbounded, the reference's default (``warp3d``'s own
    default is 8).  The flow has no halo: it is zero-padded by ``mz`` slices
    and the output cut back, 2·mz/Z_local of extra work.  Differentiable in
    both; the reference's ``remat_taps`` has no counterpart, because the
    kernel keeps no per-tap residuals.
    """
    if padding not in ("border", "zeros"):
        raise ValueError(f"padding must be 'border' or 'zeros', got {padding!r}")
    if r_z < 1:  # warp3d reads r_z 0 as no bound: samples would leave the halo
        raise ValueError(f"r_z must be >= 1 (the halo is r_z+1 slices), got {r_z}")
    mz = r_z + 1
    z_local = img.shape[2]
    if z_local < mz:
        raise ValueError(
            f"depth {z_local * mesh.n_space} must split into {mesh.n_space} shards of "
            f">= r_z+1={mz} slices")
    img_h = halo_exchange(img, mesh.space_group, mz, dim=2,
                          boundary="edge" if padding == "border" else "zeros")
    flow_h = F.pad(flow, (0, 0, 0, 0, mz, mz))
    # the haloed shard's slice 0 is the volume's slice space_index * z_local - mz
    z_offset = mesh.space_index * z_local - mz
    return warp3d(img_h, flow_h, r_z, r_yx, padding, z_offset).narrow(2, mz, z_local)
