"""Shared NN building blocks for IFNet, 2-D and 3-D (channels-first ``nn.Module``s).

Counterpart of ``opticalflowscivis_tpu/models/layers.py``:

- ``ConvPReLU``: ``Conv{2,3}d(k, stride, padding=(k - 1) // 2)`` + PReLU.
  Torch's symmetric padding is what the reference pads explicitly
  (``models/layers.py:52-62``); ``k`` is 3 everywhere but the two stride-2
  convs of a 3-D block, which use 4.
- ``DeconvPReLU``: ``ConvTranspose{2,3}d(k=4, s=2, p=1)`` + PReLU, which equals
  flax ``ConvTranspose(k=4, s=2, 'SAME')`` with the kernel spatially flipped
  (``bridge.py`` flips it).
- ``PReLU``: per-channel slope, initialised to 0.25.

Parameters are float32; the compute dtype is the input's (bf16 when the model
is asked for it): weights are cast to it on use, as flax's ``dtype`` does.
Initialisation follows flax: LeCun-normal (truncated normal, fan-in = input
channels x kernel volume) kernels and zero biases, drawn from the
``torch.Generator`` the caller passes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# std of a unit normal truncated to [-2, 2] (flax variance_scaling's constant)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class PReLU(nn.Module):
    """Per-channel parametric ReLU with slope init 0.25."""

    def __init__(self, channels: int, init: float = 0.25):
        super().__init__()
        self.slope = nn.Parameter(torch.full((channels,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.slope.to(x.dtype))


_CONV = {2: (nn.Conv2d, F.conv2d), 3: (nn.Conv3d, F.conv3d)}
_DECONV = {2: (nn.ConvTranspose2d, F.conv_transpose2d), 3: (nn.ConvTranspose3d, F.conv_transpose3d)}


def _check_ndim(ndim: int) -> None:
    if ndim not in _CONV:
        raise ValueError(f"ndim must be 2 or 3, got {ndim}")


def conv(in_ch: int, out_ch: int, generator: torch.Generator, ndim: int = 2,
         kernel_size: int = 3, stride: int = 1) -> nn.Module:
    """A conv with bias and padding ``(k - 1) // 2``, flax-initialised."""
    _check_ndim(ndim)
    c = _CONV[ndim][0](in_ch, out_ch, kernel_size, stride, (kernel_size - 1) // 2)
    lecun_normal_(c.weight, in_ch * kernel_size**ndim, generator)
    nn.init.zeros_(c.bias)
    return c


def conv_forward(c: nn.Module, x: torch.Tensor) -> torch.Tensor:
    fn = _CONV[x.dim() - 2][1]
    return fn(x, c.weight.to(x.dtype), c.bias.to(x.dtype), c.stride, c.padding)


class ConvPReLU(nn.Module):
    """Conv (+ bias) followed by per-channel PReLU."""

    def __init__(self, in_ch: int, out_ch: int, generator: torch.Generator,
                 stride: int = 1, ndim: int = 2, kernel_size: int = 3):
        super().__init__()
        self.conv = conv(in_ch, out_ch, generator, ndim, kernel_size, stride)
        self.prelu = PReLU(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.prelu(conv_forward(self.conv, x))


def deconv(in_ch: int, out_ch: int, generator: torch.Generator, ndim: int = 2) -> nn.Module:
    """Exact 2x upsampling transposed conv (k=4, s=2, p=1), flax-initialised."""
    _check_ndim(ndim)
    d = _DECONV[ndim][0](in_ch, out_ch, 4, 2, 1)
    lecun_normal_(d.weight, in_ch * 4**ndim, generator)
    nn.init.zeros_(d.bias)
    return d


def deconv_forward(d: nn.Module, x: torch.Tensor) -> torch.Tensor:
    fn = _DECONV[x.dim() - 2][1]
    return fn(x, d.weight.to(x.dtype), d.bias.to(x.dtype), d.stride, d.padding)


class DeconvPReLU(nn.Module):
    """2x transposed conv (+ bias) followed by PReLU."""

    def __init__(self, in_ch: int, out_ch: int, generator: torch.Generator, ndim: int = 2):
        super().__init__()
        self.deconv = deconv(in_ch, out_ch, generator, ndim)
        self.prelu = PReLU(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.prelu(deconv_forward(self.deconv, x))


class ResConvBlock(nn.Module):
    """``x + convs(x)``: the residual double conv of the reference's IFBlock."""

    def __init__(self, channels: int, generator: torch.Generator, ndim: int = 2):
        super().__init__()
        self.convs = nn.Sequential(
            ConvPReLU(channels, channels, generator, ndim=ndim),
            ConvPReLU(channels, channels, generator, ndim=ndim),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.convs(x)
