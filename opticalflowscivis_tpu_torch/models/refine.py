"""Contextnet / Unet refinement: the optional residual fusion stage of RIFE.

Counterpart of ``opticalflowscivis_tpu/models/refine.py``, for ``ndim`` 2 and 3
(channels-first tensors, as in ``models/ifnet.py``):

- ``Conv2``: a stride-2 ``ConvPReLU`` then a stride-1 one.
- ``Contextnet``: a 4-stage feature pyramid (``c``, 2c, 4c, 8c channels at 1/2
  to 1/16 of the input).  At each stage the flow is resized to the new
  feature size from the previous stage's flow (values rescaled), and the
  features are backward-warped by it, unbounded, in border mode.  One
  ``Contextnet`` serves both input frames: its weights are shared.
- ``Unet``: 4 stride-2 ``Conv2`` stages down over the frames, their warps, the
  raw mask, the flow and both context pyramids, 4 ``DeconvPReLU`` stages up
  with skips, and a 3x3 conv into a sigmoid residual image.

Attribute names follow the upstream RIFE ``refine.py`` (``conv1``-``conv4`` of
the Contextnet; ``down0``-``down3``, ``up0``-``up3``, ``conv`` of the Unet);
``bridge.py`` maps the flax names onto them.

The 2-D warps are ``ops.kernels.warp.warp2d`` with ``r = 0`` on the NCHW
feature maps (the ``warp2d`` kernel and, under autograd, its backward with the
image gradient on a CUDA tensor); the 3-D ones go through the plain unbounded
``ops.warp.backward_warp``, as in the reference, where they are no Pallas
kernel either.
"""

from __future__ import annotations

import torch
from torch import nn

from opticalflowscivis_tpu_torch.models.layers import ConvPReLU, DeconvPReLU, conv, conv_forward
from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d
from opticalflowscivis_tpu_torch.ops.resize import resize_flow_nchw
from opticalflowscivis_tpu_torch.ops.warp import backward_warp


def warp_unbounded(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp channels-first ``x`` by ``flow`` (``ndim`` channels,
    row-major), unbounded, border mode."""
    if x.dim() == 4:
        return warp2d(x.contiguous(), flow, 0, "border")
    return backward_warp(x.movedim(1, -1), flow.movedim(1, -1)).movedim(-1, 1)


class Conv2(nn.Module):
    """Stride-``stride`` ``ConvPReLU`` then a stride-1 one, both 3 wide."""

    def __init__(self, in_ch: int, out_ch: int, generator: torch.Generator, ndim: int = 2,
                 stride: int = 2):
        super().__init__()
        self.conv1 = ConvPReLU(in_ch, out_ch, generator, stride=stride, ndim=ndim)
        self.conv2 = ConvPReLU(out_ch, out_ch, generator, ndim=ndim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class Contextnet(nn.Module):
    """4-stage pyramid of flow-warped context features of one frame."""

    def __init__(self, in_ch: int, generator: torch.Generator, ndim: int = 2, c: int = 16):
        super().__init__()
        widths = [in_ch, c, 2 * c, 4 * c, 8 * c]
        for i in range(4):
            self.add_module(f"conv{i + 1}", Conv2(widths[i], widths[i + 1], generator, ndim))

    def forward(self, x: torch.Tensor, flow: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for i in range(4):
            x = getattr(self, f"conv{i + 1}")(x)
            flow = resize_flow_nchw(flow, tuple(x.shape[2:]))
            feats.append(warp_unbounded(x, flow))
        return feats


class Unet(nn.Module):
    """Fusion UNet: a sigmoid residual image from the frames, their warps, the
    raw mask, the flow and both context pyramids."""

    def __init__(self, in_ch: int, generator: torch.Generator, ndim: int = 2, c: int = 16,
                 out_channels: int = 1):
        super().__init__()
        self.down0 = Conv2(in_ch, 2 * c, generator, ndim)
        self.down1 = Conv2(4 * c, 4 * c, generator, ndim)
        self.down2 = Conv2(8 * c, 8 * c, generator, ndim)
        self.down3 = Conv2(16 * c, 16 * c, generator, ndim)
        self.up0 = DeconvPReLU(32 * c, 8 * c, generator, ndim)
        self.up1 = DeconvPReLU(16 * c, 4 * c, generator, ndim)
        self.up2 = DeconvPReLU(8 * c, 2 * c, generator, ndim)
        self.up3 = DeconvPReLU(4 * c, c, generator, ndim)
        self.conv = conv(c, out_channels, generator, ndim)

    def forward(self, img0, img1, warped0, warped1, mask, flow, c0, c1) -> torch.Tensor:
        cat = torch.cat
        s0 = self.down0(cat([img0, img1, warped0, warped1, mask, flow.to(img0.dtype)], 1))
        s1 = self.down1(cat([s0, c0[0], c1[0]], 1))
        s2 = self.down2(cat([s1, c0[1], c1[1]], 1))
        s3 = self.down3(cat([s2, c0[2], c1[2]], 1))
        x = self.up0(cat([s3, c0[3], c1[3]], 1))
        x = self.up1(cat([x, s2], 1))
        x = self.up2(cat([x, s1], 1))
        x = self.up3(cat([x, s0], 1))
        return torch.sigmoid(conv_forward(self.conv, x))
