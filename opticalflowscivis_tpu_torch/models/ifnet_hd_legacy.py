"""RIFE HD v1 / v2: the legacy model-zoo networks and their checkpoint loader.

Counterpart of ``opticalflowscivis_tpu/models/ifnet_hd_legacy.py``.  An
upstream legacy checkpoint is a directory of three state dicts,
``flownet.pkl``, ``contextnet.pkl`` and ``unet.pkl``:

- v1 (``IFNet_HD`` / ``RIFE_HD``): 4 blocks (widths ``cs``, upstream
  (192, 128, 96, 48)) of squeeze-excite residual blocks with BatchNorm, a
  2-channel symmetric flow (frame 1 is warped by ``-flow``) and PixelShuffle
  flow heads; a ContextNet / FusionNet pair of SE residual blocks.
- v2 (``IFNet_HDv2`` / ``RIFE_HDv2``): 4 blocks of plain conv stacks, a
  4-channel bidirectional flow, transposed-conv heads; ContextNet / FusionNet
  of ``Conv2HD`` pairs.

``RIFEHDLegacy.inference``: the flow network at half resolution, the
ContextNet's flow-warped feature pyramids of both frames, the FusionNet's
sigmoid residual and blend mask, ``pred = clamp(blend + res, 0, 1)``.

As in the reference:
- PixelShuffle is ``F.pixel_shuffle`` (``nn.PixelShuffle``);
- the block-level resizes of v1 and v2 resize the flow spatially only, with
  no value rescale; the ContextNet's stage resizes and the final upsampling
  rescale it;
- the loader permutes the flow channels from upstream (dx, dy) to row-major
  (dy, dx): v1's head outputs ``[4, 5, 6, 7, 0, 1, 2, 3]`` before the
  shuffle, v2's ``[1, 0, 3, 2]``, and the flow input rows, which start at
  channel 6, of blocks 1-3 and of the FusionNet's first conv.

v1's BatchNorm is kept as ``BatchNorm2d`` in eval mode (its running
statistics), not folded into the convs as the reference's loader folds it:
the same function, and the upstream state dict loads with
``load_state_dict(strict=True)``.  Tensors are channels-first; every warp is
``warp2d`` with ``r = 0`` in border mode (the ``warp2d`` kernel on a CUDA
tensor): 16 per interpolated pair, 6 in the flow network, 8 in the two
context pyramids, 2 in the FusionNet.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from opticalflowscivis_tpu_torch.models.ifnet_hd import load_upstream_state, warp
from opticalflowscivis_tpu_torch.ops.resize import resize_flow_nchw, resize_nchw

_FLOW_SCALES = (8, 4, 2, 1)


class SharedPReLU(nn.PReLU):
    """``PReLU(num_parameters=1)``: one slope for every channel."""

    def __init__(self):
        super().__init__(1)


def _conv_b(in_ch, out_ch, k=3, stride=1, pad=1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, k, stride, pad), nn.PReLU(out_ch))


def _deconv(in_ch, out_ch) -> nn.Sequential:
    return nn.Sequential(nn.ConvTranspose2d(in_ch, out_ch, 4, 2, 1), nn.PReLU(out_ch))


class SEResBlock(nn.Module):
    """Squeeze-excite residual block.  ``bn=True``: ``IFNet_HD.ResBlock`` (a
    5-wide first conv, BatchNorm after both convs, no conv bias); ``bn=False``:
    ``RIFE_HD.ResBlock`` (3-wide, conv biases).  ``conv0`` projects the skip
    where the stride or the width changes."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, bn: bool = True):
        super().__init__()
        self.conv0 = (nn.Identity() if in_ch == out_ch and stride == 1
                      else nn.Conv2d(in_ch, out_ch, 3, stride, 1, bias=False))
        if bn:
            self.conv1 = nn.Sequential(nn.Conv2d(in_ch, out_ch, 5, stride, 2, bias=False),
                                       nn.BatchNorm2d(out_ch), nn.PReLU(out_ch))
            self.conv2 = nn.Sequential(nn.Conv2d(out_ch, out_ch, 3, 1, 1, bias=False),
                                       nn.BatchNorm2d(out_ch))
        else:
            self.conv1 = _conv_b(in_ch, out_ch, 3, stride, 1)
            self.conv2 = nn.Sequential(nn.Conv2d(out_ch, out_ch, 3, 1, 1))
        self.relu1 = SharedPReLU()
        self.relu2 = nn.PReLU(out_ch)
        self.fc1 = nn.Conv2d(out_ch, 16, 1, bias=False)
        self.fc2 = nn.Conv2d(16, out_ch, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv0(x)
        x = self.conv2(self.conv1(x))
        w = x.mean(dim=(2, 3), keepdim=True)
        w = torch.sigmoid(self.fc2(self.relu1(self.fc1(w))))
        return self.relu2(x * w + y)


class Conv2HD(nn.Module):
    """``RIFE_HDv2.Conv2``: a stride-``stride`` conv and a stride-1 conv, each with PReLU."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 2):
        super().__init__()
        self.conv1 = _conv_b(in_ch, out_ch, 3, stride, 1)
        self.conv2 = _conv_b(out_ch, out_ch, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


def _down(x: torch.Tensor, scale: int) -> torch.Tensor:
    return x if scale == 1 else resize_nchw(x, tuple(s // scale for s in x.shape[2:]))


# -- v1 ---------------------------------------------------------------------------


class IFBlockHDv1(nn.Module):
    """A 5-wide stride-2 conv, 6 SE residual blocks, a PixelShuffle head: a
    2-channel flow at the block's input resolution."""

    def __init__(self, in_planes: int, scale: int, c: int):
        super().__init__()
        self.scale = scale
        self.conv0 = nn.Sequential(nn.Conv2d(in_planes, c, 5, 2, 2, bias=False),
                                   nn.BatchNorm2d(c), nn.PReLU(c))
        for r in range(6):
            self.add_module(f"res{r}", SEResBlock(c, c))
        self.conv1 = nn.Conv2d(c, 8, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        full = tuple(x.shape[2:])
        x = self.conv0(_down(x, self.scale))
        for r in range(6):
            x = getattr(self, f"res{r}")(x)
        flow = F.pixel_shuffle(self.conv1(x), 2)
        return flow if self.scale == 1 else resize_nchw(flow, full)


class IFNetHDv1(nn.Module):
    """4 blocks refining a symmetric 2-channel flow at half the input resolution."""

    def __init__(self, cs: Sequence[int] = (192, 128, 96, 48)):
        super().__init__()
        for i, (c, s) in enumerate(zip(cs, _FLOW_SCALES)):
            self.add_module(f"block{i}", IFBlockHDv1(6 if i == 0 else 8, s, c))

    def forward(self, img0: torch.Tensor, img1: torch.Tensor, scale: float = 1.0):
        x = torch.cat([img0, img1], 1)
        x = resize_nchw(x, tuple(int(s * 0.5 * scale) for s in x.shape[2:]))
        flow = None
        flow_list = []
        for i in range(4):
            if flow is None:
                inp = x
            else:
                inp = torch.cat([warp(x[:, :3], flow), warp(x[:, 3:], -flow),
                                 flow.to(x.dtype)], 1)
            res = getattr(self, f"block{i}")(inp)
            flow = res if flow is None else flow + res
            flow_list.append(flow)
        if scale != 1.0:
            flow = resize_flow_nchw(flow, tuple(s // 2 for s in img0.shape[2:]))
            flow_list[-1] = flow
        return flow, flow_list


def _context_forward(net: nn.Module, x: torch.Tensor, flow: torch.Tensor) -> list:
    """``conv0``, then four stages, each warped by the previous stage's flow
    resized to its size (values rescaled)."""
    x = net.conv0(x)
    feats = []
    for i in range(1, 5):
        x = getattr(net, f"conv{i}")(x)
        flow = resize_flow_nchw(flow, tuple(x.shape[2:]))
        feats.append(warp(x, flow))
    return feats


class ContextNetHDv1(nn.Module):
    """A stride-2 conv and 4 stride-2 SE residual blocks (c, 2c, 4c, 8c)."""

    def __init__(self, c: int = 32):
        super().__init__()
        self.conv0 = _conv_b(3, c, 3, 2, 1)
        for i, (ci, co) in enumerate(((c, c), (c, 2 * c), (2 * c, 4 * c), (4 * c, 8 * c))):
            self.add_module(f"conv{i + 1}", SEResBlock(ci, co, 2, bn=False))

    forward = _context_forward


def _fuse(net: nn.Module, x: torch.Tensor, c0: list, c1: list) -> torch.Tensor:
    """The FusionNets' U: 4 stages down with the context pyramids, 4 up with skips."""
    s0 = net.down0(x)
    s1 = net.down1(torch.cat([s0, c0[0], c1[0]], 1))
    s2 = net.down2(torch.cat([s1, c0[1], c1[1]], 1))
    s3 = net.down3(torch.cat([s2, c0[2], c1[2]], 1))
    x = net.up0(torch.cat([s3, c0[3], c1[3]], 1))
    x = net.up1(torch.cat([x, s2], 1))
    x = net.up2(torch.cat([x, s1], 1))
    return net.up3(torch.cat([x, s0], 1))


def _add_ups(net: nn.Module, c: int) -> None:
    """The FusionNets' four 2x transposed convs ``up0``-``up3``."""
    for i, (ci, co) in enumerate(((32 * c, 8 * c), (16 * c, 4 * c), (8 * c, 2 * c), (4 * c, c))):
        net.add_module(f"up{i}", _deconv(ci, co))


class FusionNetHDv1(nn.Module):
    """U-net over the warped frames and both context pyramids; a 16-channel
    conv and a PixelShuffle give 4 channels (3 residual, 1 mask)."""

    def __init__(self, c: int = 32):
        super().__init__()
        self.conv0 = _conv_b(8, c, 3, 2, 1)
        self.down0 = SEResBlock(c, 2 * c, 2, bn=False)
        self.down1 = SEResBlock(4 * c, 4 * c, 2, bn=False)
        self.down2 = SEResBlock(8 * c, 8 * c, 2, bn=False)
        self.down3 = SEResBlock(16 * c, 16 * c, 2, bn=False)
        _add_ups(self, c)
        self.conv = nn.Conv2d(c, 16, 3, 1, 1)

    def forward(self, img0, img1, flow, c0, c1):
        warped0, warped1 = warp(img0, flow), warp(img1, -flow)
        x = self.conv0(torch.cat([warped0, warped1, flow.to(img0.dtype)], 1))
        out = F.pixel_shuffle(self.conv(_fuse(self, x, c0, c1)), 2)
        return out, warped0, warped1


# -- v2 ---------------------------------------------------------------------------


class IFBlockHDv2(nn.Module):
    """Two stride-2 convs, 6 convs, a transposed-conv head: a 4-channel flow
    at half the block's input resolution."""

    def __init__(self, in_planes: int, scale: int, c: int):
        super().__init__()
        self.scale = scale
        self.conv0 = nn.Sequential(_conv_b(in_planes, c, 3, 2, 1), _conv_b(c, 2 * c, 3, 2, 1))
        self.convblock = nn.Sequential(*[_conv_b(2 * c, 2 * c) for _ in range(6)])
        self.conv1 = nn.ConvTranspose2d(2 * c, 4, 4, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = tuple(s // 2 for s in x.shape[2:])
        flow = self.conv1(self.convblock(self.conv0(_down(x, self.scale))))
        return flow if self.scale == 1 else resize_nchw(flow, half)


class IFNetHDv2(nn.Module):
    """4 blocks refining a bidirectional 4-channel flow carried at half
    resolution; its 2x upsampling (values doubled) drives full-resolution warps."""

    def __init__(self, cs: Sequence[int] = (192, 128, 96, 48)):
        super().__init__()
        for i, (c, s) in enumerate(zip(cs, _FLOW_SCALES)):
            self.add_module(f"block{i}", IFBlockHDv2(6 if i == 0 else 10, s, c))

    def forward(self, img0: torch.Tensor, img1: torch.Tensor, scale: float = 1.0):
        x = torch.cat([img0, img1], 1)
        if scale != 1.0:
            x = resize_nchw(x, tuple(int(s * scale) for s in x.shape[2:]))
        full = tuple(x.shape[2:])
        flow = None
        flow_list = []
        for i in range(4):
            if flow is None:
                inp = x
            else:
                large = resize_flow_nchw(flow, full)
                inp = torch.cat([warp(x[:, :3], large[:, :2]), warp(x[:, 3:], large[:, 2:4]),
                                 large.to(x.dtype)], 1)
            res = getattr(self, f"block{i}")(inp)
            flow = res if flow is None else flow + res
            flow_list.append(flow)
        if scale != 1.0:
            flow = resize_flow_nchw(flow, tuple(s // 2 for s in img0.shape[2:]))
            flow_list[-1] = flow
        return flow, flow_list


class ContextNetHDv2(nn.Module):
    """5 ``Conv2HD`` stages; the last four warped."""

    def __init__(self, c: int = 32):
        super().__init__()
        self.conv0 = Conv2HD(3, c)
        for i, (ci, co) in enumerate(((c, c), (c, 2 * c), (2 * c, 4 * c), (4 * c, 8 * c))):
            self.add_module(f"conv{i + 1}", Conv2HD(ci, co))

    forward = _context_forward


class FusionNetHDv2(nn.Module):
    """``Conv2HD`` U-net; a transposed-conv head gives 4 channels."""

    def __init__(self, c: int = 32):
        super().__init__()
        self.conv0 = Conv2HD(10, c)
        self.down0 = Conv2HD(c, 2 * c)
        self.down1 = Conv2HD(4 * c, 4 * c)
        self.down2 = Conv2HD(8 * c, 8 * c)
        self.down3 = Conv2HD(16 * c, 16 * c)
        _add_ups(self, c)
        self.conv = nn.ConvTranspose2d(c, 4, 4, 2, 1)

    def forward(self, img0, img1, flow, c0, c1):
        warped0, warped1 = warp(img0, flow[:, :2]), warp(img1, flow[:, 2:4])
        x = self.conv0(torch.cat([warped0, warped1, flow.to(img0.dtype)], 1))
        return self.conv(_fuse(self, x, c0, c1)), warped0, warped1


# -- the composed model ----------------------------------------------------------


class RIFEHDLegacy(nn.Module):
    """``flownet``, ``contextnet`` and ``fusionnet`` of RIFE HD v1 or v2.

    ``inference(img0, img1)`` on RGB ``[B, 3, H, W]`` (H and W multiples of
    64) returns (pred, full-resolution flow, mask).
    """

    def __init__(self, version: int = 2, c_fusion: int = 32,
                 cs: Sequence[int] = (192, 128, 96, 48)):
        super().__init__()
        if version not in (1, 2):
            raise ValueError("version must be 1 (RIFE_HD) or 2 (RIFE_HDv2)")
        self.version = version
        if version == 1:
            self.flownet = IFNetHDv1(cs)
            self.contextnet = ContextNetHDv1(c_fusion)
            self.fusionnet = FusionNetHDv1(c_fusion)
        else:
            self.flownet = IFNetHDv2(cs)
            self.contextnet = ContextNetHDv2(c_fusion)
            self.fusionnet = FusionNetHDv2(c_fusion)

    def init(self, seed: int = 0) -> "RIFEHDLegacy":
        """Draw every weight afresh (torch's default initialisation) from
        ``seed``, and v1's BatchNorm statistics away from the identity, for
        tests and smoke runs without a checkpoint; the global RNG is left as
        it was."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    with torch.no_grad():
                        m.running_mean.normal_(0, 0.3)
                        m.running_var.uniform_(0.5, 1.5)
                        m.weight.normal_(1.0, 0.2)
                        m.bias.normal_(0, 0.2)
                elif m is not self and hasattr(m, "reset_parameters"):
                    m.reset_parameters()
        return self

    def predict(self, img0: torch.Tensor, img1: torch.Tensor, flow: torch.Tensor):
        """(pred, flow at full resolution, mask) from the half-resolution ``flow``."""
        if self.version == 1:
            c0, c1 = self.contextnet(img0, flow), self.contextnet(img1, -flow)
        else:
            c0, c1 = self.contextnet(img0, flow[:, :2]), self.contextnet(img1, flow[:, 2:4])
        flow = resize_flow_nchw(flow, tuple(img0.shape[2:]))
        out, warped0, warped1 = self.fusionnet(img0, img1, flow, c0, c1)
        res = torch.sigmoid(out[:, :3]) * 2 - 1
        mask = torch.sigmoid(out[:, 3:4])
        merged = warped0 * mask + warped1 * (1 - mask)
        return torch.clamp(merged + res, 0.0, 1.0), flow, mask

    def inference(self, img0: torch.Tensor, img1: torch.Tensor, scale: float = 1.0):
        flow, _ = self.flownet(img0, img1, scale)
        return self.predict(img0, img1, flow)


# -- the upstream checkpoint ---------------------------------------------------------


def _legacy_version(flownet_state: dict) -> int:
    """2 where the flow network has ``convblock`` stacks (v2), else 1."""
    return 2 if any("convblock" in k for k in flownet_state) else 1


def _legacy_widths(flownet_state: dict, contextnet_state: dict, version: int):
    """``(cs, c_fusion)`` read off the checkpoint: each block's first conv and
    the ContextNet's first conv."""
    first = "conv0.0.0.weight" if version == 2 else "conv0.0.weight"
    cs = tuple(int(flownet_state[f"block{i}.{first}"].shape[0]) for i in range(4))
    ctx_first = "conv0.conv1.0.weight" if version == 2 else "conv0.0.weight"
    return cs, int(contextnet_state[ctx_first].shape[0])


def _swap_rows(weight: torch.Tensor, start: int, perm: list) -> None:
    rows = weight[:, start:start + len(perm)]
    rows.copy_(rows[:, perm].clone())


@torch.no_grad()
def _permute_legacy_flow(model: RIFEHDLegacy) -> None:
    """Upstream (dx, dy) flow channels -> row-major (dy, dx): each flow head's
    outputs, and the flow input rows (from channel 6) of blocks 1-3 and of the
    FusionNet's first conv."""
    v1 = model.version == 1
    head_perm = [4, 5, 6, 7, 0, 1, 2, 3] if v1 else [1, 0, 3, 2]
    in_perm = [1, 0] if v1 else [1, 0, 3, 2]
    for i in range(4):
        block = getattr(model.flownet, f"block{i}")
        head = block.conv1
        out_dim = 0 if v1 else 1  # Conv2d is [out, in, ...], ConvTranspose2d [in, out, ...]
        head.weight.copy_(head.weight.index_select(out_dim, torch.tensor(head_perm)))
        head.bias.copy_(head.bias[head_perm].clone())
        if i > 0:
            first = block.conv0[0] if v1 else block.conv0[0][0]
            _swap_rows(first.weight, 6, in_perm)
    fuse_first = model.fusionnet.conv0[0] if v1 else model.fusionnet.conv0.conv1[0]
    _swap_rows(fuse_first.weight, 6, in_perm)


def load_torch_rife_hd_legacy(path: str, version: int | None = None) -> RIFEHDLegacy:
    """A ``RIFEHDLegacy`` with the weights of an upstream v1 / v2 checkpoint
    directory (``flownet.pkl``, ``contextnet.pkl``, ``unet.pkl``).

    Strips DDP ``module.`` prefixes, takes the version from the flow
    network's keys where ``version`` is None and the widths from the
    checkpoint, loads each part strictly, then carries the flow in row-major
    order (``_permute_legacy_flow``).  Returns the model on the CPU, in eval
    mode (v1's BatchNorm uses its running statistics).
    """
    flow_state = load_upstream_state(os.path.join(path, "flownet.pkl"))
    ctx_state = load_upstream_state(os.path.join(path, "contextnet.pkl"))
    unet_state = load_upstream_state(os.path.join(path, "unet.pkl"))
    found = _legacy_version(flow_state)
    if version is not None and version != found:
        raise ValueError(f"{path} holds a RIFE HD v{found} checkpoint, not v{version}")
    cs, c_fusion = _legacy_widths(flow_state, ctx_state, found)
    model = RIFEHDLegacy(found, c_fusion, cs)
    model.flownet.load_state_dict(flow_state, strict=True)
    model.contextnet.load_state_dict(ctx_state, strict=True)
    model.fusionnet.load_state_dict(unet_state, strict=True)
    _permute_legacy_flow(model)
    return model.eval()
