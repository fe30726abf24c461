"""Spatial sharding of volumes along depth — halo exchange and the sharded warp.

The counterpart of the reference package's ``parallel/spatial.py``.  The
reference could not train on Droplet-3D at native 256^3 and downsampled
everything to 64^3 (Datasets/read_data.py:149-159); sharding the volume's
depth over the ``space`` axis of the mesh is the answer here too.

- ``halo_exchange``: each rank extends its shard by its neighbours' edge
  slices along one dimension, exchanged point to point
  (``batch_isend_irecv``); differentiable, its backward sends each halo's
  gradient back to the rank that owns the slices (the transpose of the
  reference's ``ppermute``).
- ``backward_warp3d_sharded``: the trilinear warp of a depth-sharded volume,
  the ``warp3d`` kernel run on each rank's haloed shard; its only
  communication is the 2·(r_z+1)-slice halo.

The reference's ``volume_batch_sharding`` (GSPMD partitioning of every
IFNet-3D layer) has no counterpart yet: spatially sharded IFNet-3D training
is ROADMAP A.12b.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from opticalflowscivis_tpu_torch.ops.kernels.warp import warp3d
from opticalflowscivis_tpu_torch.parallel.mesh import Mesh

BOUNDARIES = ("shift", "edge", "zeros")


def _group_rank(group) -> tuple[int, int]:
    """(this rank's index in ``group``, the group's size); (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _global(group, index: int) -> int:
    return index if group is dist.group.WORLD else dist.get_global_rank(group, index)


def _exchange(group, to_left: torch.Tensor | None, to_right: torch.Tensor | None,
              like: torch.Tensor) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Send ``to_left`` / ``to_right`` to the previous / next rank of ``group``
    and receive what they send this way, in one ``batch_isend_irecv``.  None
    means no neighbour on that side.  Under gloo the slices go through the
    host; under NCCL they stay on the device."""
    if to_left is None and to_right is None:  # a group of one: nothing to post
        return None, None
    idx, _ = _group_rank(group)
    host = like.is_cuda and dist.get_backend(group) == "gloo"

    def staged(t):
        t = t.contiguous()
        return t.cpu() if host else t

    ops, from_left, from_right = [], None, None
    if to_left is not None:
        sent = staged(to_left)
        from_left = torch.empty_like(sent)
        peer = _global(group, idx - 1)
        ops += [dist.P2POp(dist.isend, sent, peer, group),
                dist.P2POp(dist.irecv, from_left, peer, group)]
    if to_right is not None:
        sent = staged(to_right)
        from_right = torch.empty_like(sent)
        peer = _global(group, idx + 1)
        ops += [dist.P2POp(dist.isend, sent, peer, group),
                dist.P2POp(dist.irecv, from_right, peer, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    back = (lambda t: t.to(like.device)) if host else (lambda t: t)
    return (None if from_left is None else back(from_left),
            None if from_right is None else back(from_right))


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, halo: int, dim: int, boundary: str):
        idx, n = _group_rank(group)
        ctx.group, ctx.halo, ctx.dim, ctx.boundary, ctx.length = group, halo, dim, boundary, x.shape[dim]
        first, last = x.narrow(dim, 0, halo), x.narrow(dim, x.shape[dim] - halo, halo)
        # my first slices become the previous rank's right halo, my last the next's left
        from_left, from_right = _exchange(group, first if idx > 0 else None,
                                          last if idx < n - 1 else None, x)
        if from_left is None:
            from_left = _boundary_fill(x, halo, dim, boundary, at_start=True)
        if from_right is None:
            from_right = _boundary_fill(x, halo, dim, boundary, at_start=False)
        return torch.cat([from_left, x, from_right], dim=dim)

    @staticmethod
    def backward(ctx, g):
        group, halo, dim, length = ctx.group, ctx.halo, ctx.dim, ctx.length
        idx, n = _group_rank(group)
        g_left, g_right = g.narrow(dim, 0, halo), g.narrow(dim, halo + length, halo)
        dx = g.narrow(dim, halo, length).clone()
        # my left halo came from the previous rank's last slices: its gradient
        # goes back there, and the next rank's left-halo gradient comes here
        from_left, from_right = _exchange(group, g_left if idx > 0 else None,
                                          g_right if idx < n - 1 else None, g)
        if from_right is not None:
            dx.narrow(dim, length - halo, halo).add_(from_right)
        if from_left is not None:
            dx.narrow(dim, 0, halo).add_(from_left)
        if idx == 0:
            _boundary_grad(dx, g_left, halo, dim, ctx.boundary, at_start=True)
        if idx == n - 1:
            _boundary_grad(dx, g_right, halo, dim, ctx.boundary, at_start=False)
        return dx, None, None, None, None


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


def halo_exchange(x: torch.Tensor, group, halo: int, dim: int = 0,
                  boundary: str = "shift") -> torch.Tensor:
    """Pad this rank's shard with ``halo`` slices from each neighbour along
    ``dim``: the previous rank's last slices before, the next rank's first
    after (ranks ordered as in ``group``; None is a group of one).  At the
    global boundary the halo is filled by ``boundary``:

    - ``'shift'``: the shard's own first/last ``halo`` slices (the full-array
      analogue is ``concat([x[:halo], x, x[-halo:]])``);
    - ``'edge'``: the outermost slice repeated ``halo`` times — matching
      edge padding of the full array, i.e. grid-sample 'border' semantics;
    - ``'zeros'``: zeros (zero padding of the full array; not in the
      reference, which masks instead, ``ops/warp.py:217-238`` there).

    Differentiable in ``x``.
    """
    if boundary not in BOUNDARIES:
        raise ValueError(f"boundary must be one of {BOUNDARIES}, got {boundary!r}")
    dim = dim % x.dim()
    if not 0 < halo <= x.shape[dim]:
        raise ValueError(f"halo {halo} must be in [1, {x.shape[dim]}] (the shard's size)")
    return _HaloExchange.apply(x, group, halo, dim, boundary)


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
