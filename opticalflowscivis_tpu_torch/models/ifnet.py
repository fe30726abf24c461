"""IFNet — RIFE-style student/teacher coarse-to-fine intermediate-flow network.

Counterpart of ``opticalflowscivis_tpu/models/ifnet.py`` for ``ndim=2``:

- ``IFBlock``: two stride-2 convs, four residual double convs, and two
  transposed-conv heads emitting 4 flow channels (F_t→0 and F_t→1, each
  (dy, dx)) and 1 mask channel; inputs and flow are bilinearly downscaled by
  ``scale`` before and the outputs upscaled (flow values rescaled) after.
- ``IFNet``: the student blocks at scales (4, 2, 1), iterative residual flow
  refinement with a backward warp of both inputs after each block,
  mask-blended merging, the teacher block that also sees the ground-truth
  middle frame, and the masked-RMSE distillation loss.

Tensors inside are NCHW: images ``[B, C, H, W]``, flow ``[B, 4, H, W]`` with
channels (dy0, dx0, dy1, dx1).  Parameters are float32; ``dtype`` selects the
compute dtype (``torch.bfloat16`` or float32).

Every warp goes through ``ops.kernels.warp.warp2d``: on a CUDA tensor it
launches the Hopper kernel (and its backward kernel under autograd), on a CPU
tensor it runs the plain version.  Both clip the flow to ``±fast_warp_r``
(0 = unbounded), which is the TPU kernel's semantics; the reference's CPU
path warps unbounded.  A flow component with ``|flow| >= fast_warp_r``
carries no gradient through the warp.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from opticalflowscivis_tpu_torch.device import resolve_device
from opticalflowscivis_tpu_torch.models.layers import (
    ConvPReLU,
    DeconvPReLU,
    ResConvBlock,
    deconv,
    deconv_forward,
)
from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d
from opticalflowscivis_tpu_torch.ops.resize import resize_flow_nchw, resize_nchw


class _Head(nn.Module):
    """Deconv(c → c/2) + PReLU, then deconv(c/2 → out)."""

    def __init__(self, c: int, out_ch: int, generator: torch.Generator):
        super().__init__()
        self.up = DeconvPReLU(c, c // 2, generator)
        self.out = deconv(c // 2, out_ch, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return deconv_forward(self.out, self.up(x))


class IFBlock(nn.Module):
    """One coarse-to-fine refinement block (reference IFNet.py:34-122, v2).

    ``in_ch`` counts the image-side input channels; a block that receives a
    flow gets 4 more.
    """

    def __init__(self, in_ch: int, c: int, generator: torch.Generator,
                 with_flow: bool = True):
        super().__init__()
        first = in_ch + (4 if with_flow else 0)
        self.conv0 = nn.Sequential(
            ConvPReLU(first, c // 2, generator, stride=2),
            ConvPReLU(c // 2, c, generator, stride=2),
        )
        self.convblock = nn.Sequential(*[ResConvBlock(c, generator) for _ in range(4)])
        self.flow_head = _Head(c, 4, generator)
        self.mask_head = _Head(c, 1, generator)

    def forward(self, x: torch.Tensor, flow: torch.Tensor | None, scale: int):
        full = tuple(x.shape[2:])
        if scale != 1:
            small = tuple(s // scale for s in full)
            x = resize_nchw(x, small)
            if flow is not None:
                flow = resize_flow_nchw(flow, small)  # values rescale by 1/scale
        if flow is not None:
            x = torch.cat([x, flow.to(x.dtype)], dim=1)
        x = self.convblock(self.conv0(x))
        f = self.flow_head(x)
        m = self.mask_head(x)
        if scale != 1:
            f = resize_flow_nchw(f, full)  # values rescale by `scale`
            m = resize_nchw(m, full)
        return f, m


class IFNet(nn.Module):
    """Student/teacher coarse-to-fine interpolation flow network (2-D).

    Call with NCHW ``img0, img1`` (C = ``in_channels``); ``gt`` (the real
    middle frame) enables the teacher branch and the distillation loss.
    """

    def __init__(
        self,
        ndim: int = 2,
        in_channels: int = 1,
        block_channels: Sequence[int] = (128, 96, 64),
        scales: Sequence[int] = (4, 2, 1),
        teacher_channels: int = 64,
        arbitrary_timestep: bool = False,
        refine: bool = False,
        fast_warp_r: int = 0,
        dtype: torch.dtype | None = None,
        device: str | torch.device | None = None,
        seed: int = 0,
    ):
        super().__init__()
        if ndim != 2:
            raise NotImplementedError(
                "IFNet-3D is ported with the RIFE-3D slice (ROADMAP A.8)"
            )
        if refine:
            raise NotImplementedError(
                "Contextnet/Unet refinement (models/refine.py) is ported with "
                "the remaining models (ROADMAP A.10)"
            )
        if len(scales) != len(block_channels):
            raise ValueError("one scale per student block")
        device = resolve_device(device)
        self.in_channels = in_channels
        self.scales = tuple(scales)
        self.arbitrary_timestep = arbitrary_timestep
        self.fast_warp_r = fast_warp_r
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        c, ts = in_channels, int(arbitrary_timestep)
        for i, width in enumerate(block_channels):
            # block 0 sees (img0, img1); later blocks also (warped0, warped1, mask)
            in_ch = (2 * c if i == 0 else 4 * c + 1) + ts
            self.add_module(
                f"block{i}",
                IFBlock(in_ch, width, gen, with_flow=i > 0),
            )
        self.block_tea = IFBlock(5 * c + 1 + ts, teacher_channels, gen)
        self.n_blocks = len(block_channels)
        self.to(device)

    def _warp(self, img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        return warp2d(img, flow, self.fast_warp_r, "border")

    def forward(
        self,
        img0: torch.Tensor,
        img1: torch.Tensor,
        gt: torch.Tensor | None = None,
        timestep: float | torch.Tensor = 0.5,
    ) -> dict:
        compute = img0.dtype if self.dtype is None else self.dtype
        # the warp kernel reads contiguous NCHW images
        img0 = img0.to(compute).contiguous()
        img1 = img1.to(compute).contiguous()
        b, _, h, w = img0.shape

        def ts_channel() -> torch.Tensor:
            t = torch.as_tensor(timestep, dtype=compute, device=img0.device)
            if t.dim() == 1:
                t = t.view(-1, 1, 1, 1)
            return t.expand(b, 1, h, w)

        flow = mask = None
        warped0, warped1 = img0, img1
        flow_list, mask_list, merged = [], [], []
        for i in range(self.n_blocks):
            inp = [img0, img1] if flow is None else [img0, img1, warped0, warped1, mask]
            if self.arbitrary_timestep:
                inp.append(ts_channel())
            block = getattr(self, f"block{i}")
            flow_d, mask_d = block(torch.cat(inp, dim=1), flow, self.scales[i])
            flow = flow_d if flow is None else flow + flow_d
            mask = mask_d if mask is None else mask + mask_d
            flow_list.append(flow)
            mask_list.append(torch.sigmoid(mask))
            warped0 = self._warp(img0, flow[:, 0:2])  # F_t→0 samples img0
            warped1 = self._warp(img1, flow[:, 2:4])  # F_t→1 samples img1
            merged.append((warped0, warped1))

        flow_teacher = merged_teacher = None
        loss_distill = torch.zeros((), dtype=torch.float32, device=img0.device)
        if gt is not None:
            gt = gt.to(compute)
            tea_inp = [img0, img1, warped0, warped1, mask, gt]
            if self.arbitrary_timestep:
                tea_inp.append(ts_channel())
            # the teacher runs at scale 1; the reference's teacher_scale > 1
            # is a 3-D single-chip mode, ported with the RIFE-3D slice
            flow_d, mask_d = self.block_tea(torch.cat(tea_inp, dim=1), flow, 1)
            flow_teacher = flow + flow_d
            w0_tea = self._warp(img0, flow_teacher[:, 0:2])
            w1_tea = self._warp(img1, flow_teacher[:, 2:4])
            mask_teacher = torch.sigmoid(mask + mask_d)
            merged_teacher = w0_tea * mask_teacher + w1_tea * (1 - mask_teacher)

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
