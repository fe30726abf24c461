"""UPFlow — PWC-style unsupervised optical-flow network with a cost volume.

Counterpart of ``opticalflowscivis_tpu/models/upflow.py``, as channels-first
``nn.Module``s:

- ``FeatureExtractor``: 6 levels, channels (in, 16, 32, 64, 96, 128, 196), each
  a stride-2 conv and a stride-1 conv with LeakyReLU(0.1); coarsest first.
- ``FlowEstimatorDense``: densely connected 5-conv stack (128, 128, 96, 64,
  32) and a linear 2-channel head; returns (dense features, flow residual).
- ``ContextNetwork``: dilations (1, 2, 4, 8, 16, 1) and a linear head.
- ``SGUModel``: SGU, the upsampler that takes its guidance from the features.
  A small dense estimator predicts an interpolation flow and a blend mask; the
  upsampled flow is warped by the interpolation flow and blended.
- ``UPFlowNet``: bidirectional coarse-to-fine decoding over the 5 coarsest
  pyramid levels with shared estimator weights.  Per level: x2 flow upsample
  (align-corners, values rescaled), feature warp (zeros padding x validity
  mask), optional feature normalisation, 9x9 cost volume, LeakyReLU, dense
  estimator and dilated context refinement.

Every convolution pads ``(dilation * (k - 1)) // 2`` on both sides (PyTorch's
own symmetric padding, also at stride 2 and at dilation 16).  Parameters are
float32 and initialised as flax does (LeCun-normal kernels, zero biases) from
the generator the caller passes; ``dtype`` selects the compute dtype of the
features (``torch.bfloat16`` or float32).  Every flow stays float32 whatever
the features' type.

The cost volume goes through ``ops.kernels.correlation.cost_volume_kernel``
and every warp through ``ops.kernels.warp.warp2d`` with ``r = 0`` (unbounded):
on CUDA tensors the Hopper kernels, on CPU tensors their plain versions.  A
bf16 feature map is warped by its float32 flow as it is (the kernel takes the
pair); the flow is never rounded to bf16.

Flow convention: row-major (dy, dx).  ``UPFlowNet.forward`` takes and returns
channels-first tensors; the trainer hands channels-last views to the losses.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from opticalflowscivis_tpu_torch.device import resolve_device
from opticalflowscivis_tpu_torch.models.layers import lecun_normal_
from opticalflowscivis_tpu_torch.ops.kernels.correlation import cost_volume_kernel
from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d, warp2d_with_mask
from opticalflowscivis_tpu_torch.ops.resize import resize_nchw, upsample_flow_as_nchw


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class ConvLeaky(nn.Module):
    """k x k conv (+ bias) and LeakyReLU(0.1); ``relu=False`` is a linear head."""

    def __init__(self, in_ch: int, out_ch: int, generator: torch.Generator,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1, relu: bool = True):
        super().__init__()
        pad = (dilation * (kernel_size - 1)) // 2
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride, pad, dilation)
        lecun_normal_(self.conv.weight, in_ch * kernel_size**2, generator)
        nn.init.zeros_(self.conv.bias)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        x = F.conv2d(x, c.weight.to(x.dtype), c.bias.to(x.dtype), c.stride, c.padding, c.dilation)
        return _leaky(x) if self.relu else x


class FeatureExtractor(nn.Module):
    def __init__(self, num_chs: Sequence[int], generator: torch.Generator):
        super().__init__()
        convs = []
        for c_in, c_out in zip(num_chs[:-1], num_chs[1:]):
            convs.append(ConvLeaky(c_in, c_out, generator, stride=2))
            convs.append(ConvLeaky(c_out, c_out, generator))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        pyramid = []
        for i in range(0, len(self.convs), 2):
            x = self.convs[i + 1](self.convs[i](x))
            pyramid.append(x)
        return pyramid[::-1]  # coarsest first


class FlowEstimatorDense(nn.Module):
    """``convs[:-1]`` are the dense stack, ``convs[-1]`` the linear head."""

    def __init__(self, in_ch: int, generator: torch.Generator,
                 f_channels: Sequence[int] = (128, 128, 96, 64, 32), out_channels: int = 2):
        super().__init__()
        convs = []
        for f in f_channels:
            convs.append(ConvLeaky(in_ch, f, generator))
            in_ch += f
        convs.append(ConvLeaky(in_ch, out_channels, generator, relu=False))
        self.convs = nn.ModuleList(convs)
        self.feat_channels = in_ch

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        for conv in self.convs[:-1]:
            x = torch.cat([conv(x), x], dim=1)
        return x, self.convs[-1](x)


class ContextNetwork(nn.Module):
    DILATIONS = (1, 2, 4, 8, 16, 1)

    def __init__(self, in_ch: int, generator: torch.Generator,
                 f_channels: Sequence[int] = (128, 128, 128, 96, 64, 32, 2)):
        super().__init__()
        convs = []
        for f, d in zip(f_channels[:-1], self.DILATIONS):
            convs.append(ConvLeaky(in_ch, f, generator, dilation=d))
            in_ch = f
        convs.append(ConvLeaky(in_ch, f_channels[-1], generator, relu=False))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = conv(x)
        return x


def warp_with_mask(feature: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Zeros-padded warp of ``feature [B, C, H, W]`` by ``flow [B, 2, H, W]``
    times the validity mask ``warped ones > 0.9999``.

    The mask is rounded to the feature's dtype (in bf16 a weight sum of 0.998
    rounds to 1 and counts as valid) and compared with the threshold in
    float32.  The reference compares in the feature's dtype too, where the
    threshold 0.9999 itself rounds to 1.0 in bf16 and ``mask > 1.0`` holds
    nowhere: its bf16 model zeroes every warped feature map.  The port does
    not carry that over; in float32 the two agree.
    """
    warped, mask = warp2d_with_mask(feature.contiguous(), flow, "zeros")
    return warped * (mask.float() > 0.9999).to(warped.dtype)


def normalize_features(f1: torch.Tensor, f2: torch.Tensor, across_channels: bool = True,
                       across_images: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """UFlow-style feature normalisation before the cost volume, on
    channels-first maps.  The variance is the population variance;
    ``across_images`` shares the mean of the two means and, as the reference
    has it, the variance *of the two variances*."""
    dims = tuple(range(1, f1.dim())) if across_channels else tuple(range(2, f1.dim()))
    stats = [(f.mean(dim=dims, keepdim=True), f.var(dim=dims, unbiased=False, keepdim=True))
             for f in (f1, f2)]
    if across_images:
        mean = torch.stack([m for m, _ in stats]).mean(dim=0)
        var = torch.stack([v for _, v in stats]).var(dim=0, unbiased=False)
        stats = [(mean, var), (mean, var)]
    (m1, v1), (m2, v2) = stats
    return (f1 - m1) / torch.sqrt(v1 + 1e-16), (f2 - m2) / torch.sqrt(v2 + 1e-16)


class SGUModel(nn.Module):
    """SGU: upsampling of a flow under guidance features of ``feat_channels``."""

    def __init__(self, generator: torch.Generator, feat_channels: int = 32):
        super().__init__()
        self.dense_estimator_mask = FlowEstimatorDense(
            2 * feat_channels, generator, f_channels=(32, 32, 32, 16, 8), out_channels=3)

    def forward(self, flow_init: torch.Tensor, feature_1: torch.Tensor, feature_2: torch.Tensor,
                output_level_flow: torch.Tensor | None = None) -> torch.Tensor:
        if flow_init.shape[2:] != feature_1.shape[2:]:
            flow_init = upsample_flow_as_nchw(flow_init, feature_1)
        f2_warp = warp_with_mask(feature_2, flow_init)
        _, out = self.dense_estimator_mask(torch.cat([feature_1, f2_warp], dim=1))
        inter_flow = out[:, :2]
        inter_mask = torch.sigmoid(out[:, 2:3])
        if output_level_flow is not None:
            inter_flow = upsample_flow_as_nchw(inter_flow, output_level_flow)
            inter_mask = resize_nchw(inter_mask, tuple(output_level_flow.shape[2:]),
                                     align_corners=True)
            flow_init = output_level_flow
        # the flow being resampled is float32: warp it by a float32 copy of the
        # interpolation flow (an exact upcast of the features' type)
        resampled = warp2d(flow_init.contiguous(), inter_flow.to(flow_init.dtype), 0, "border")
        return resampled * (1 - inter_mask) + flow_init * inter_mask


class SGUOutputConv(nn.Module):
    """Full-resolution guidance features for SGU."""

    def __init__(self, in_ch: int, generator: torch.Generator):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvLeaky(in_ch, 16, generator),
            ConvLeaky(16, 16, generator, stride=2),
            ConvLeaky(16, 32, generator),
            ConvLeaky(32, 32, generator, stride=2),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = conv(x)
        return x


@dataclasses.dataclass(frozen=True)
class UPFlowConfig:
    """Architecture knobs, with the reference's defaults."""

    in_channels: int = 3
    num_chs: tuple[int, ...] = (3, 16, 32, 64, 96, 128, 196)
    search_range: int = 4
    estimator_f_channels: tuple[int, ...] = (128, 128, 96, 64, 32)
    context_f_channels: tuple[int, ...] = (128, 128, 128, 96, 64, 32, 2)
    output_level: int = 4  # decode the 5 coarsest levels (1/64 .. 1/4)
    if_norm_before_cost_volume: bool = False
    norm_moments_across_channels: bool = True
    norm_moments_across_images: bool = True
    if_sgu_upsample: bool = False
    batch_directions: bool = True  # run the forward and backward decode
    #   streams stacked along the batch axis through the shared-weight subnets:
    #   one extractor / estimator / context / cost-volume call per level instead
    #   of two.  The same numbers (every op is per sample) and the same
    #   parameters, half the launches.


class UPFlowNet(nn.Module):
    """Bidirectional pyramid flow network.

    ``forward(im1, im2)`` takes channels-first frames ``[B, C, H, W]`` (H and W
    multiples of 64) and returns ``flow_f``, ``flow_b`` ``[B, 2, H, W]`` and
    ``flows``, the per-level ``(forward, backward)`` pairs, finest first, all
    float32.  Runs on ``cuda`` unless ``device="cpu"``; weights are drawn from
    ``seed``.
    """

    def __init__(self, cfg: UPFlowConfig = UPFlowConfig(), dtype: torch.dtype | None = None,
                 device: str | torch.device | None = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        self.n_levels = cfg.output_level + 1
        self.feature_extractor = FeatureExtractor(cfg.num_chs, gen)
        level_chs = tuple(cfg.num_chs[::-1][: self.n_levels])  # coarsest first
        self.conv_1x1 = nn.ModuleList(
            [ConvLeaky(ch, 32, gen, kernel_size=1) for ch in level_chs])
        corr_chs = (2 * cfg.search_range + 1) ** 2
        self.flow_estimators = FlowEstimatorDense(
            corr_chs + 32 + 2, gen, cfg.estimator_f_channels, out_channels=2)
        self.context_networks = ContextNetwork(
            self.flow_estimators.feat_channels + 2, gen, cfg.context_f_channels)
        if cfg.if_sgu_upsample:
            self.sgi_model = SGUModel(gen)
            self.sgu_output_conv = SGUOutputConv(cfg.num_chs[0], gen)
        else:
            self.sgi_model = self.sgu_output_conv = None
        self.to(device)

    def _decode(self, level: int, xa: torch.Tensor, xb: torch.Tensor, xa_1x1: torch.Tensor,
                xb_1x1: torch.Tensor | None, flow: torch.Tensor) -> torch.Tensor:
        """One level of one stream (or of both stacked): source features ``xa``,
        target features ``xb``, the coarser flow → this level's flow."""
        cfg = self.cfg
        flow_up = flow if flow.shape[2:] == xa.shape[2:] else upsample_flow_as_nchw(flow, xa)
        if level == 0:
            xb_warp = xb
        else:
            if self.sgi_model is not None:
                flow_up = self.sgi_model(flow_up, xa_1x1, xb_1x1)
            xb_warp = warp_with_mask(xb, flow_up)
        ca, cb = xa, xb_warp
        if cfg.if_norm_before_cost_volume:
            ca, cb = normalize_features(ca, cb, cfg.norm_moments_across_channels,
                                        cfg.norm_moments_across_images)
        corr = _leaky(cost_volume_kernel(ca, cb, cfg.search_range))
        feat, res = self.flow_estimators(torch.cat([corr, xa_1x1, flow_up.to(xa.dtype)], dim=1))
        flow_mid = flow_up + res.float()
        fine = self.context_networks(torch.cat([feat, flow_mid.to(xa.dtype)], dim=1))
        return flow_mid + fine.float()

    def forward(self, im1: torch.Tensor, im2: torch.Tensor) -> dict:
        cfg = self.cfg
        if im1.dim() != 4 or im1.shape != im2.shape:
            raise ValueError(f"expected two frames [B, C, H, W] of one shape, got "
                             f"{tuple(im1.shape)} and {tuple(im2.shape)}")
        compute = im1.dtype if self.dtype is None else self.dtype
        # contiguous channels-first frames: a channels-last view (what the
        # trainer's batches are) would make cuDNN return every feature map in
        # channels-last layout, which the warp kernel does not take and the
        # cost-volume kernel reads uncoalesced
        im1, im2 = im1.to(compute).contiguous(), im2.to(compute).contiguous()
        b = im1.shape[0]
        sgu = self.sgi_model

        if cfg.batch_directions:
            # Stacked streams: [0:b] is the forward direction (source im1,
            # target im2), [b:2b] the backward one.  The source features of the
            # stacked batch are the pyramid of [im1; im2] itself; the target
            # features are its halves swapped.
            im_a = torch.cat([im1, im2], dim=0)
            pyramid = self.feature_extractor(im_a)

            def swap(x):
                return torch.cat([x[b:], x[:b]], dim=0)

            flow = torch.zeros((2 * b, 2) + tuple(pyramid[0].shape[2:]), dtype=torch.float32,
                               device=im1.device)
            flows = []
            for level in range(self.n_levels):
                xa = pyramid[level]
                xa_1x1 = self.conv_1x1[level](xa)
                xb_1x1 = swap(xa_1x1) if sgu is not None else None
                flow = self._decode(level, xa, swap(xa), xa_1x1, xb_1x1, flow)
                flows.append((flow[:b], flow[b:]))
            flow_out = upsample_flow_as_nchw(flow, im_a)
            if sgu is not None:
                ga = self.sgu_output_conv(im_a)
                flow_out = sgu(flow, ga, swap(ga), output_level_flow=flow_out)
            return {"flow_f": flow_out[:b], "flow_b": flow_out[b:], "flows": flows[::-1]}

        p1 = self.feature_extractor(im1)
        p2 = self.feature_extractor(im2)
        flow_f = torch.zeros((b, 2) + tuple(p1[0].shape[2:]), dtype=torch.float32,
                             device=im1.device)
        flow_b = torch.zeros_like(flow_f)
        flows = []
        for level in range(self.n_levels):
            x1, x2 = p1[level], p2[level]
            x1_1x1 = self.conv_1x1[level](x1)
            x2_1x1 = self.conv_1x1[level](x2)
            flow_f = self._decode(level, x1, x2, x1_1x1, x2_1x1, flow_f)
            flow_b = self._decode(level, x2, x1, x2_1x1, x1_1x1, flow_b)
            flows.append((flow_f, flow_b))
        flow_f_out = upsample_flow_as_nchw(flow_f, im1)
        flow_b_out = upsample_flow_as_nchw(flow_b, im2)
        if sgu is not None:
            g1 = self.sgu_output_conv(im1)
            g2 = self.sgu_output_conv(im2)
            flow_f_out = sgu(flow_f, g1, g2, output_level_flow=flow_f_out)
            flow_b_out = sgu(flow_b, g2, g1, output_level_flow=flow_b_out)
        return {"flow_f": flow_f_out, "flow_b": flow_b_out, "flows": flows[::-1]}
