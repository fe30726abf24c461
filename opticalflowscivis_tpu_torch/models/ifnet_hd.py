"""IFNet-HDv3: the upstream RIFE v3.6 model-zoo network and its checkpoint loader.

Counterpart of ``opticalflowscivis_tpu/models/ifnet_hd.py``:

- ``IFBlockHD``: like ``IFBlock`` but the flow is always an input: two stride-2
  convs, four residual double convs, and transposed-conv heads for a 4-channel
  flow and a 1-channel mask, with the input and flow resized by ``scale``
  before (flow values rescaled) and the outputs resized back after.
- ``IFNetHDv3``: three blocks of width ``c`` (90 upstream) at scales (4, 2,
  1); each block runs twice, the second time on swapped inputs, and the two
  predictions are averaged (the second's flow halves swapped, its mask
  negated).  RGB frames; the flow starts at zero.

The modules are written in torch idiom with the upstream attribute names
(``block{i}.conv0.{j}.{0,1}``, ``convblock{k}``, ``conv1.*``, ``conv2.*``), so
an upstream ``flownet.pkl`` loads with ``load_state_dict(strict=True)``
(``load_torch_rife_hdv3``).  Upstream flow channels are (dx, dy) pairs; the
loader then permutes the flow head's outputs and the flow rows of each block's
first conv to this package's row-major (dy, dx), an exact
reparameterisation: the network computes the same values with the flow
carried in row-major order.

Tensors are channels-first ``[B, C, H, W]``; the warps are ``warp2d`` with
``r = 0`` in border mode (the ``warp2d`` kernel on a CUDA tensor).
"""

from __future__ import annotations

import torch
from torch import nn

from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d
from opticalflowscivis_tpu_torch.ops.resize import resize_flow_nchw, resize_nchw

FLOW_PERM = (1, 0, 3, 2)  # upstream (u0, v0, u1, v1) -> row-major (v0, u0, v1, u1)


def _conv(in_ch: int, out_ch: int, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, 3, stride, 1), nn.PReLU(out_ch))


def _head(c: int, out_ch: int) -> nn.Sequential:
    return nn.Sequential(nn.ConvTranspose2d(c, c // 2, 4, 2, 1), nn.PReLU(c // 2),
                         nn.ConvTranspose2d(c // 2, out_ch, 4, 2, 1))


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Unbounded border-mode warp of ``img [B, C, H, W]`` by a (dy, dx) flow."""
    return warp2d(img.contiguous(), flow, 0, "border")


class IFBlockHD(nn.Module):
    """One HDv3 block: ``(x [B, 7, H, W], flow [B, 4, H, W], scale)`` -> (flow, mask)."""

    def __init__(self, in_planes: int = 11, c: int = 90):
        super().__init__()
        self.conv0 = nn.Sequential(_conv(in_planes, c // 2, 2), _conv(c // 2, c, 2))
        for k in range(4):
            self.add_module(f"convblock{k}", nn.Sequential(_conv(c, c), _conv(c, c)))
        self.conv1 = _head(c, 4)
        self.conv2 = _head(c, 1)

    def forward(self, x: torch.Tensor, flow: torch.Tensor, scale: int):
        full = tuple(x.shape[2:])
        if scale != 1:
            small = tuple(s // scale for s in full)
            x = resize_nchw(x, small)
            flow = resize_flow_nchw(flow, small)
        feat = self.conv0(torch.cat([x, flow.to(x.dtype)], 1))
        for k in range(4):
            feat = getattr(self, f"convblock{k}")(feat) + feat
        f = self.conv1(feat)
        m = self.conv2(feat)
        if scale != 1:
            f = resize_flow_nchw(f, full)
            m = resize_nchw(m, full)
        return f, m


def _swap_flow(flow: torch.Tensor) -> torch.Tensor:
    return torch.cat([flow[:, 2:4], flow[:, :2]], 1)


class IFNetHDv3(nn.Module):
    """The upstream RIFE v3.6 inference network (student only).

    ``forward(img0, img1)`` on RGB ``[B, 3, H, W]`` (H and W multiples of 32)
    returns ``{"flow_list", "mask", "merged"}``: the flow after each block
    (``[B, 4, H, W]``, row-major, float32), the last sigmoid mask and the
    merged frame after each block.
    """

    def __init__(self, c: int = 90, scales: tuple[int, ...] = (4, 2, 1)):
        super().__init__()
        self.scales = tuple(scales)
        for i in range(len(self.scales)):
            self.add_module(f"block{i}", IFBlockHD(7 + 4, c))

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> dict:
        b, _, h, w = img0.shape
        flow = torch.zeros((b, 4, h, w), dtype=torch.float32, device=img0.device)
        mask = torch.zeros((b, 1, h, w), dtype=img0.dtype, device=img0.device)
        warped0, warped1 = img0, img1
        flow_list, mask_list, merged = [], [], []
        for i, scale in enumerate(self.scales):
            block = getattr(self, f"block{i}")
            f0, m0 = block(torch.cat([warped0[:, :3], warped1[:, :3], mask], 1), flow, scale)
            f1, m1 = block(torch.cat([warped1[:, :3], warped0[:, :3], -mask], 1),
                           _swap_flow(flow), scale)
            flow = flow + (f0.float() + _swap_flow(f1).float()) / 2
            mask = mask + (m0 - m1) / 2
            flow_list.append(flow)
            mask_list.append(mask)
            warped0 = warp(img0, flow[:, :2])
            warped1 = warp(img1, flow[:, 2:4])
            merged.append((warped0, warped1))
        out = []
        for (w0, w1), m in zip(merged, mask_list):
            s = torch.sigmoid(m)
            out.append(w0 * s + w1 * (1 - s))
        return {"flow_list": flow_list, "mask": torch.sigmoid(mask_list[-1]), "merged": out}


def load_upstream_state(path: str) -> dict[str, torch.Tensor]:
    """An upstream ``.pkl`` state dict on the CPU, DDP ``module.`` prefixes stripped."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k.replace("module.", ""): v for k, v in state.items()}


@torch.no_grad()
def _permute_flow_channels(net: IFNetHDv3) -> None:
    """Upstream (dx, dy) flow channels -> row-major (dy, dx): the flow head's
    outputs (dim 1 of a transposed conv's weight) and the last 4 input
    channels of each block's first conv."""
    perm = list(FLOW_PERM)
    for i in range(len(net.scales)):
        block = getattr(net, f"block{i}")
        first = block.conv0[0][0].weight
        first[:, -4:] = first[:, -4:][:, perm].clone()
        head = block.conv1[2]
        head.weight.copy_(head.weight[:, perm].clone())
        head.bias.copy_(head.bias[perm].clone())


def load_torch_rife_hdv3(path: str) -> IFNetHDv3:
    """An ``IFNetHDv3`` with the weights of an upstream v3.6 ``flownet.pkl``.

    Strips DDP ``module.`` prefixes, drops the teacher block (``block_tea``;
    inference never runs it), reads the width ``c`` off the checkpoint, loads
    strictly, then carries the flow in row-major (dy, dx) order
    (``_permute_flow_channels``).  The upstream transposed-conv weights load as
    they are.  Returns the model on the CPU.
    """
    state = {k: v for k, v in load_upstream_state(path).items() if not k.startswith("block_tea.")}
    net = IFNetHDv3(c=int(state["block0.conv0.1.0.weight"].shape[0]))
    net.load_state_dict(state, strict=True)
    _permute_flow_channels(net)
    return net.eval()
