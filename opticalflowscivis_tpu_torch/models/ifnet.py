"""IFNet — RIFE-style student/teacher coarse-to-fine intermediate-flow network.

Counterpart of ``opticalflowscivis_tpu/models/ifnet.py``, one implementation
for ``ndim`` 2 and 3:

- ``IFBlock``: two stride-2 convs (kernel ``conv0_kernel``: 3 in 2-D, 4 in
  3-D), four residual double convs, and two transposed-conv heads emitting
  ``2 * ndim`` flow channels (F_t→0 and F_t→1) and 1 mask channel; inputs and
  flow are linearly downscaled by ``scale`` before and the outputs upscaled
  (flow values rescaled) after.
- ``IFNet``: the student blocks at scales (4, 2, 1), iterative residual flow
  refinement with a backward warp of both inputs after each block,
  mask-blended merging, the teacher block that also sees the ground-truth
  middle frame (at ``teacher_scale``; > 1 keeps every conv off full-resolution
  inputs, the single-device 256³ mode), and the masked-RMSE distillation loss.
- ``refine=True``: after the distillation loop (which sees the unrefined
  merges), the Contextnet/Unet residual of ``models/refine.py`` refines the
  last merged frame, ``clamp(merged + (res * 2 - 1), 0, 1)``.  The Unet sees
  the last student warps, the raw accumulated mask (before the sigmoid) and
  the flow; one ``Contextnet`` (module ``contextnet``) warps features of both
  frames, each by its own half of the flow.

Tensors inside are channels-first: images ``[B, C, H, W]`` or
``[B, C, Z, Y, X]``, flow ``[B, 2 * ndim, ...]`` with channels
(dy0, dx0, dy1, dx1) or (dz0, dy0, dx0, dz1, dy1, dx1).  Parameters are
float32; ``dtype`` selects the compute dtype (``torch.bfloat16`` or float32).

Every warp goes through ``ops.kernels.warp``: ``warp2d`` in 2-D, ``warp3d`` in
3-D.  On a CUDA tensor they launch the Hopper kernels (and their backward
kernels under autograd), on a CPU tensor the plain versions.  The
refinement's own feature warps are unbounded (``models/refine.py``).

- 2-D: the flow is clipped to ``±fast_warp_r`` (0 = unbounded), which is the
  TPU kernel's semantics; the reference's CPU path warps unbounded.
- 3-D with ``bounded_warp_rz > 0``: ``flow_z`` is clipped to
  ``±bounded_warp_rz`` and the in-plane components to
  ``±(fast_warp_r or bounded_warp_rz)``, the semantics of the reference's slab
  warp on the TPU (each z-tap runs the bounded 2-D kernel there); the
  reference's CPU path clips ``flow_z`` only.  With ``bounded_warp_rz == 0``
  the reference warps unbounded whatever ``fast_warp_r`` says, and so does
  this model.

A flow component at or beyond its radius carries no gradient through the warp.

``remat=True`` recomputes each IFBlock in the backward pass
(``torch.utils.checkpoint``, non-reentrant) instead of keeping its
activations: the memory mode of 256³ training.  The warps lie outside the
blocks and are not rerun, so the launch counts do not change.

Spans (``utils.profiling.span``): ``ofs.ifnet`` around ``forward``,
``ofs.block{i}`` around each block with its two warps, ``ofs.teacher``
around the teacher's, ``ofs.distill`` around the merges and the
distillation.  A block rerun under remat runs inside the backward of the
block's own operations, on autograd's thread, and opens no span there.

Depth-sharded (``forward(..., shard=DepthShard)``, spatially sharded
training): the inputs are this rank's slices of the first spatial axis, and
so are the outputs.
- A block's level (its input after the ``scale`` resize, then ÷2 and ÷4
  after the stride-2 convs) runs sharded when every shard there holds whole
  slices, starts on a multiple of the level's stride and holds the halo
  (``layers.conv_shardable``).  Below the first level that does not, the
  block's tensor at that level is gathered (``gather_space``), the rest of
  the block runs whole on every rank of the space group, and its output at
  that level is cut back (``scatter_space``).  The choice depends on shapes
  alone, so every rank issues the same collectives in the same order, also
  when ``remat`` reruns a block.
- The warps take ``backward_warp3d_sharded`` (the ``warp3d`` kernels'
  z-offset instances on a haloed shard) when ``bounded_warp_rz >= 1`` and a
  shard holds ``r_z + 1`` slices.  Otherwise (unbounded or 2-D warps, thin
  shards) the gather form: the frame gathered once per forward, this rank's
  flow zero-padded to the whole volume (``warp3d`` takes one depth for image
  and flow, so ``z_offset`` cannot stand in), one warp of the whole, and
  this rank's slices kept.
- The concatenations, sigmoids, blending and the distillation term are
  local; ``loss_distill`` is this rank's mean (``parallel.spatial`` says how
  the ranks' means make the global one).  The refinement runs whole on
  gathered inputs, its residual cut back to the shard.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from opticalflowscivis_tpu_torch.device import resolve_device
from opticalflowscivis_tpu_torch.models.layers import (
    ConvPReLU,
    DeconvPReLU,
    ResConvBlock,
    conv_shardable,
    deconv,
    deconv_forward,
    deconv_shardable,
)
from opticalflowscivis_tpu_torch.models.refine import Contextnet, Unet
from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d, warp3d
from opticalflowscivis_tpu_torch.ops.resize import resize_flow_nchw, resize_nchw
from opticalflowscivis_tpu_torch.parallel.spatial import backward_warp3d_sharded
from opticalflowscivis_tpu_torch.utils.profiling import span


class _Head(nn.Module):
    """Deconv(c → c/2) + PReLU, then deconv(c/2 → out); ``IFBlock.forward``
    runs the two, each on its level's shards or whole."""

    def __init__(self, c: int, out_ch: int, generator: torch.Generator, ndim: int):
        super().__init__()
        self.up = DeconvPReLU(c, c // 2, generator, ndim)
        self.out = deconv(c // 2, out_ch, generator, ndim)


class IFBlock(nn.Module):
    """One coarse-to-fine refinement block (reference IFNet.py:34-122, v2).

    ``in_ch`` counts the image-side input channels; a block that receives a
    flow gets ``2 * ndim`` more.  ``conv0_kernel`` is the kernel of the two
    stride-2 convs only.
    """

    def __init__(self, in_ch: int, c: int, generator: torch.Generator,
                 with_flow: bool = True, ndim: int = 2, conv0_kernel: int = 3):
        super().__init__()
        first = in_ch + (2 * ndim if with_flow else 0)
        self.conv0 = nn.Sequential(
            ConvPReLU(first, c // 2, generator, stride=2, ndim=ndim, kernel_size=conv0_kernel),
            ConvPReLU(c // 2, c, generator, stride=2, ndim=ndim, kernel_size=conv0_kernel),
        )
        self.convblock = nn.Sequential(*[ResConvBlock(c, generator, ndim) for _ in range(4)])
        self.flow_head = _Head(c, 2 * ndim, generator, ndim)
        self.mask_head = _Head(c, 1, generator, ndim)

    def sharded_levels(self, length: int, scale: int, n_shards: int,
                       dim: int = 2) -> tuple[bool, bool, bool, bool]:
        """Whether the input and the block's three levels (1/scale, then ÷2,
        ÷4) run on shards of ``length`` slices: each level holds whole
        slices, starts on a multiple of its stride and holds the halo of each
        layer that reads it."""
        heads = (self.flow_head, self.mask_head)
        n0 = length // scale
        n1 = n0 // self.conv0[0].conv.stride[dim - 2]
        n2 = n1 // self.conv0[1].conv.stride[dim - 2]
        ok1 = length % scale == 0 and n0 >= 1
        ok2 = ok1 and conv_shardable(self.conv0[0].conv, n0, n_shards, dim) and all(
            deconv_shardable(h.out, n1, n_shards, dim) for h in heads)
        ok3 = ok2 and conv_shardable(self.conv0[1].conv, n1, n_shards, dim) and all(
            conv_shardable(c.conv, n2, n_shards, dim)
            for block in self.convblock for c in block.convs) and all(
            deconv_shardable(h.up.deconv, n2, n_shards, dim) for h in heads)
        return True, ok1, ok2, ok3

    def forward(self, x: torch.Tensor, flow: torch.Tensor | None, scale: int, shard=None):
        """``(flow, mask)`` at ``x``'s size; on depth shards with ``shard``
        (the module docstring's rule for levels)."""
        if shard is None:
            ok = (False,) * 4
        else:
            ok = self.sharded_levels(x.shape[shard.dim], scale, shard.n, shard.dim)

        def on(level):  # the shard context of the layers that read a level
            return shard if ok[level] else None

        def down(t, level):  # the last sharded level before a whole one: gather
            return shard.gather(t) if ok[level] and not ok[level + 1] else t

        def up(t, level):  # ... and cut the whole result back there
            return shard.scatter(t) if ok[level] and not ok[level + 1] else t

        x = down(x, 0)
        flow = None if flow is None else down(flow, 0)
        full = tuple(x.shape[2:])
        if scale != 1:
            small = tuple(s // scale for s in full)
            x = resize_nchw(x, small)  # a shrink stays inside a shard
            if flow is not None:
                flow = resize_flow_nchw(flow, small)  # values rescale by 1/scale
        if flow is not None:
            x = torch.cat([x, flow.to(x.dtype)], dim=1)
        x = self.conv0[0](down(x, 1), on(2))
        x = self.conv0[1](down(x, 2), on(3))
        for block in self.convblock:
            x = block(x, on(3))
        f, m = (up(deconv_forward(head.out, up(head.up(x, on(3)), 2), on(2)), 1)
                for head in (self.flow_head, self.mask_head))
        if scale != 1:
            f = resize_flow_nchw(f, full, shard=on(1))  # values rescale by `scale`
            m = resize_nchw(m, full, shard=on(1))
        return up(f, 0), up(m, 0)


class IFNet(nn.Module):
    """Student/teacher coarse-to-fine interpolation flow network (2-D or 3-D).

    Call with channels-first ``img0, img1`` (C = ``in_channels``); ``gt`` (the
    real middle frame) enables the teacher branch and the distillation loss.
    """

    def __init__(
        self,
        ndim: int = 2,
        in_channels: int = 1,
        block_channels: Sequence[int] = (128, 96, 64),
        scales: Sequence[int] = (4, 2, 1),
        teacher_channels: int = 64,
        teacher_scale: int = 1,
        arbitrary_timestep: bool = False,
        conv0_kernel: int = 3,
        refine: bool = False,
        fast_warp_r: int = 0,
        bounded_warp_rz: int = 0,
        remat: bool = False,
        dtype: torch.dtype | None = None,
        device: str | torch.device | None = None,
        seed: int = 0,
    ):
        super().__init__()
        if ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {ndim}")
        if len(scales) != len(block_channels):
            raise ValueError("one scale per student block")
        device = resolve_device(device)
        self.ndim = ndim
        self.in_channels = in_channels
        self.scales = tuple(scales)
        self.teacher_scale = teacher_scale
        self.arbitrary_timestep = arbitrary_timestep
        self.fast_warp_r = fast_warp_r
        self.bounded_warp_rz = bounded_warp_rz
        self.remat = remat
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        c, ts = in_channels, int(arbitrary_timestep)
        kw = {"ndim": ndim, "conv0_kernel": conv0_kernel}
        for i, width in enumerate(block_channels):
            # block 0 sees (img0, img1); later blocks also (warped0, warped1, mask)
            in_ch = (2 * c if i == 0 else 4 * c + 1) + ts
            self.add_module(
                f"block{i}",
                IFBlock(in_ch, width, gen, with_flow=i > 0, **kw),
            )
        self.block_tea = IFBlock(5 * c + 1 + ts, teacher_channels, gen, **kw)
        self.n_blocks = len(block_channels)
        self.refine = refine
        if refine:
            # (img0, img1, warped0, warped1, mask, flow) into the Unet
            self.contextnet = Contextnet(c, gen, ndim)
            self.unet = Unet(4 * c + 1 + 2 * ndim, gen, ndim, out_channels=c)
        self.to(device)

    def _warp(self, img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        if self.ndim == 2:
            return warp2d(img, flow, self.fast_warp_r, "border")
        r_z = self.bounded_warp_rz
        r_yx = (self.fast_warp_r or r_z) if r_z > 0 else 0
        return warp3d(img, flow, r_z, r_yx, "border")

    def halo_warps(self, length: int) -> bool:
        """Whether depth shards of ``length`` slices warp through the halo
        (``backward_warp3d_sharded``) rather than the gather form."""
        r_z = self.bounded_warp_rz
        return self.ndim == 3 and r_z >= 1 and length >= r_z + 1

    def _warp_sharded(self, img: torch.Tensor, whole: torch.Tensor | None,
                      flow: torch.Tensor, shard) -> torch.Tensor:
        """This rank's slices of the warp: through the halo, or the gather
        form on ``whole``, the gathered frame (module docstring)."""
        if whole is None:
            r_z = self.bounded_warp_rz
            return backward_warp3d_sharded(img, flow, shard.mesh, r_z, "border",
                                           self.fast_warp_r or r_z)
        return shard.scatter(self._warp(whole, shard.pad_to_whole(flow)))

    def _block(self, block: IFBlock, x: torch.Tensor, flow: torch.Tensor | None, scale: int,
               shard=None):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, x, flow, scale, shard, use_reentrant=False)
        return block(x, flow, scale, shard)

    def forward(
        self,
        img0: torch.Tensor,
        img1: torch.Tensor,
        gt: torch.Tensor | None = None,
        timestep: float | torch.Tensor = 0.5,
        shard=None,
    ) -> dict:
        """``shard`` (a ``parallel.spatial.DepthShard``): the inputs are this
        rank's depth shards, and so are the outputs (module docstring)."""
        with span("ofs.ifnet"):
            compute = img0.dtype if self.dtype is None else self.dtype
            # the warp kernels read contiguous channels-first images
            img0 = img0.to(compute).contiguous()
            img1 = img1.to(compute).contiguous()
            nd = self.ndim
            if img0.dim() != nd + 2:
                raise ValueError(f"a {nd}-D IFNet takes [B, C, *S] with {nd} spatial axes, "
                                 f"got {tuple(img0.shape)}")

            def ts_channel() -> torch.Tensor:
                t = torch.as_tensor(timestep, dtype=compute, device=img0.device)
                if t.dim() == 1:
                    t = t.view((-1,) + (1,) * (nd + 1))
                return t.expand((img0.shape[0], 1) + tuple(img0.shape[2:]))

            whole0 = whole1 = None  # the gather form warps the whole frames: gather each once
            if shard is not None and not self.halo_warps(img0.shape[shard.dim]):
                whole0, whole1 = shard.gather(img0), shard.gather(img1)

            def warp(img, whole, f):
                if shard is None:
                    return self._warp(img, f)
                return self._warp_sharded(img, whole, f, shard)

            flow = mask = None
            warped0, warped1 = img0, img1
            flow_list, mask_list, merged = [], [], []
            for i in range(self.n_blocks):
                with span(f"ofs.block{i}"):
                    inp = [img0, img1] if flow is None else [img0, img1, warped0, warped1, mask]
                    if self.arbitrary_timestep:
                        inp.append(ts_channel())
                    block = getattr(self, f"block{i}")
                    flow_d, mask_d = self._block(block, torch.cat(inp, dim=1), flow,
                                                 self.scales[i], shard)
                    flow = flow_d if flow is None else flow + flow_d
                    mask = mask_d if mask is None else mask + mask_d
                    flow_list.append(flow)
                    mask_list.append(torch.sigmoid(mask))
                    warped0 = warp(img0, whole0, flow[:, :nd])  # F_t→0 samples img0
                    warped1 = warp(img1, whole1, flow[:, nd:])  # F_t→1 samples img1
                    merged.append((warped0, warped1))

            flow_teacher = merged_teacher = None
            loss_distill = torch.zeros((), dtype=torch.float32, device=img0.device)
            if gt is not None:
                with span("ofs.teacher"):
                    gt = gt.to(compute)
                    tea_inp = [img0, img1, warped0, warped1, mask, gt]
                    if self.arbitrary_timestep:
                        tea_inp.append(ts_channel())
                    flow_d, mask_d = self._block(self.block_tea, torch.cat(tea_inp, dim=1),
                                                 flow, self.teacher_scale, shard)
                    flow_teacher = flow + flow_d
                    w0_tea = warp(img0, whole0, flow_teacher[:, :nd])
                    w1_tea = warp(img1, whole1, flow_teacher[:, nd:])
                    mask_teacher = torch.sigmoid(mask + mask_d)
                    merged_teacher = w0_tea * mask_teacher + w1_tea * (1 - mask_teacher)

            with span("ofs.distill"):  # the merges, and the distillation toward the teacher
                merged_out = []
                for i in range(self.n_blocks):
                    m = merged[i][0] * mask_list[i] + merged[i][1] * (1 - mask_list[i])
                    merged_out.append(m)
                    if gt is not None:
                        # masked RMSE toward the teacher's flow wherever the student's
                        # reconstruction is worse than the teacher's by > 0.01
                        err_stu = (m - gt).abs().mean(dim=1, keepdim=True)
                        err_tea = (merged_teacher - gt).abs().mean(dim=1, keepdim=True)
                        worse = (err_stu > err_tea + 0.01).float().detach()
                        # eps inside the sqrt: the bare sqrt has an infinite gradient
                        # where student and teacher flows agree
                        rmse = torch.sqrt(
                            ((flow_teacher.detach() - flow_list[i]).float() ** 2)
                            .mean(dim=1, keepdim=True)
                            + 1e-12
                        )
                        loss_distill = loss_distill + (rmse * worse).mean()

            if self.refine:
                inputs = (img0, img1, warped0, warped1, mask, flow)
                if shard is not None:  # whole on gathered inputs, the residual cut back
                    inputs = tuple(shard.gather(t) for t in inputs)
                i0, i1, w0, w1, mk, fl = inputs
                c0 = self.contextnet(i0, fl[:, :nd])
                c1 = self.contextnet(i1, fl[:, nd:])
                res = self.unet(i0, i1, w0, w1, mk, fl, c0, c1)
                if shard is not None:
                    res = shard.scatter(res)
                merged_out[-1] = torch.clamp(merged_out[-1] + (res * 2 - 1), 0, 1)

            return {
                "flow_list": flow_list,
                "mask_list": mask_list,
                "merged": merged_out,
                "flow_teacher": flow_teacher,
                "merged_teacher": merged_teacher,
                "loss_distill": loss_distill,
            }


def ifnet_2d(
    in_channels: int = 1,
    dtype: torch.dtype | None = None,
    device: str | torch.device | None = None,
    seed: int = 0,
    **kw,
) -> IFNet:
    """Reference Flow-2D configuration: blocks (128, 96, 64), teacher 64.

    Warps clip the flow to ±16 by default (``fast_warp_r``, the TPU kernel's
    bound); pass ``fast_warp_r=0`` for unbounded warps.  Runs on ``cuda``
    unless ``device="cpu"``; weights are drawn from ``seed``.
    """
    kw.setdefault("fast_warp_r", 16)
    return IFNet(ndim=2, in_channels=in_channels, block_channels=(128, 96, 64),
                 teacher_channels=64, dtype=dtype, device=device,
                 seed=seed, **kw)


def ifnet_3d(
    in_channels: int = 1,
    dtype: torch.dtype | None = None,
    device: str | torch.device | None = None,
    seed: int = 0,
    **kw,
) -> IFNet:
    """Reference Flow-3D configuration: blocks (128, 64, 64), teacher 64,
    4-wide stride-2 convs.

    Warps clip ``flow_z`` to ±8 (``bounded_warp_rz``; the data's velocities
    are <= 8 voxels per step) and the in-plane flow to ±8 (``fast_warp_r``);
    pass ``bounded_warp_rz=0`` for unbounded warps.  Runs on ``cuda`` unless
    ``device="cpu"``; weights are drawn from ``seed``.
    """
    kw.setdefault("bounded_warp_rz", 8)
    kw.setdefault("fast_warp_r", 8)
    return IFNet(ndim=3, in_channels=in_channels, block_channels=(128, 64, 64),
                 teacher_channels=64, conv0_kernel=4, dtype=dtype, device=device,
                 seed=seed, **kw)
