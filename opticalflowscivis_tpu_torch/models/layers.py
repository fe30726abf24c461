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

- ``conv_stack``: a list of ``ConvPReLU``, one per (features, stride).

Parameters are float32; the compute dtype is the input's (bf16 when the model
is asked for it): weights are cast to it on use, as flax's ``dtype`` does.

Depth-sharded forms: each module's ``forward`` takes an optional ``shard``
(``parallel.spatial.DepthShard``: the mesh and the sharded axis); without one
it is the plain layer.  With one, the input is this rank's slices of the
axis, and so is the output.  A conv reads ``conv_halo`` slices of its
neighbours' shards (zeros at the volume's ends, where the plain conv pads)
and runs without padding along the axis; a transposed conv takes a
``deconv_halo`` of input slices, runs whole and keeps the shard's outputs
(its backward then comes from the halo exchange's own).  ``conv_shardable`` /
``deconv_shardable`` say whether a shard of a given length may run so: its
start on a multiple of the stride and at least the halo's slices.  The
parameters and their names are the same either way.
Initialisation follows flax: LeCun-normal (truncated normal, fan-in = input
channels x kernel volume) kernels and zero biases, drawn from the
``torch.Generator`` the caller passes.
"""

from __future__ import annotations

import math
from typing import Sequence

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


def _axis_params(c: nn.Module, dim: int) -> tuple[int, int, int]:
    """(kernel, stride, padding) of ``c`` along tensor axis ``dim``."""
    return c.kernel_size[dim - 2], c.stride[dim - 2], c.padding[dim - 2]


def conv_halo(kernel: int, stride: int, padding: int) -> tuple[int, int]:
    """The slices before and after a shard that a conv's outputs on the shard
    read: output ``o`` reads inputs ``o·s - p`` to ``o·s - p + k - 1``, so a
    shard starting on a multiple of ``s`` needs ``p`` before and ``k - s - p``
    after (3³ s1: 1 and 1; 4³ s2 p1: 1 and 1; 3³ s2 p1: 1 and 0)."""
    return padding, kernel - stride - padding


def deconv_halo(kernel: int, stride: int, padding: int) -> tuple[int, int]:
    """The input slices before and after a shard that a transposed conv's
    outputs on the shard (``stride`` per input slice) read: input ``i`` feeds
    outputs ``i·s - p`` to ``i·s - p + k - 1`` (k4 s2 p1: 1 and 1)."""
    return (kernel - 1 - padding) // stride, (stride - 1 + padding) // stride


def conv_shardable(c: nn.Module, length: int, n_shards: int, dim: int = 2) -> bool:
    """Whether ``n_shards`` shards of ``length`` slices along ``dim`` run ``c``
    sharded: each starts on a multiple of the stride, holds the halo, and the
    shards' outputs tile the whole conv's."""
    k, s, p = _axis_params(c, dim)
    before, after = conv_halo(k, s, p)
    whole = length * n_shards
    return (length % s == 0 and min(before, after) >= 0 and max(before, after) <= length
            and (whole + 2 * p - k) // s + 1 == whole // s)


def deconv_shardable(d: nn.Module, length: int, n_shards: int, dim: int = 2) -> bool:
    """Whether ``n_shards`` shards of ``length`` slices run the transposed conv
    ``d`` sharded: they hold its input halo, and its outputs are ``stride``
    per input slice."""
    k, s, p = _axis_params(d, dim)
    return (max(deconv_halo(k, s, p)) <= length and k - 2 * p == s
            and d.output_padding[dim - 2] == 0)


def conv_forward(c: nn.Module, x: torch.Tensor, shard=None) -> torch.Tensor:
    fn = _CONV[x.dim() - 2][1]
    w, b = c.weight.to(x.dtype), c.bias.to(x.dtype)
    if shard is None:
        return fn(x, w, b, c.stride, c.padding)
    k, s, p = _axis_params(c, shard.dim)
    halo = conv_halo(k, s, p)
    if any(halo):
        x = shard.halo(x, halo, "zeros")
    padding = list(c.padding)
    padding[shard.dim - 2] = 0  # the halo (zeros at the volume's ends) pads
    return fn(x, w, b, c.stride, tuple(padding))


class ConvPReLU(nn.Module):
    """Conv (+ bias) followed by per-channel PReLU."""

    def __init__(self, in_ch: int, out_ch: int, generator: torch.Generator,
                 stride: int = 1, ndim: int = 2, kernel_size: int = 3):
        super().__init__()
        self.conv = conv(in_ch, out_ch, generator, ndim, kernel_size, stride)
        self.prelu = PReLU(out_ch)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        return self.prelu(conv_forward(self.conv, x, shard))


def deconv(in_ch: int, out_ch: int, generator: torch.Generator, ndim: int = 2) -> nn.Module:
    """Exact 2x upsampling transposed conv (k=4, s=2, p=1), flax-initialised."""
    _check_ndim(ndim)
    d = _DECONV[ndim][0](in_ch, out_ch, 4, 2, 1)
    lecun_normal_(d.weight, in_ch * 4**ndim, generator)
    nn.init.zeros_(d.bias)
    return d


def deconv_forward(d: nn.Module, x: torch.Tensor, shard=None) -> torch.Tensor:
    fn = _DECONV[x.dim() - 2][1]
    w, b = d.weight.to(x.dtype), d.bias.to(x.dtype)
    if shard is None:
        return fn(x, w, b, d.stride, d.padding)
    k, s, p = _axis_params(d, shard.dim)
    before, after = deconv_halo(k, s, p)
    length = x.shape[shard.dim]
    if before or after:
        x = shard.halo(x, (before, after), "zeros")
    out = fn(x, w, b, d.stride, d.padding)
    # output j of the haloed input is output j + (start - before)·s of the whole
    return out.narrow(shard.dim, before * s, length * s)


class DeconvPReLU(nn.Module):
    """2x transposed conv (+ bias) followed by PReLU."""

    def __init__(self, in_ch: int, out_ch: int, generator: torch.Generator, ndim: int = 2):
        super().__init__()
        self.deconv = deconv(in_ch, out_ch, generator, ndim)
        self.prelu = PReLU(out_ch)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        return self.prelu(deconv_forward(self.deconv, x, shard))


class ResConvBlock(nn.Module):
    """``x + convs(x)``: the residual double conv of the reference's IFBlock."""

    def __init__(self, channels: int, generator: torch.Generator, ndim: int = 2):
        super().__init__()
        self.convs = nn.Sequential(
            ConvPReLU(channels, channels, generator, ndim=ndim),
            ConvPReLU(channels, channels, generator, ndim=ndim),
        )

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        y = x
        for layer in self.convs:
            y = layer(y, shard)
        return x + y


def conv_stack(features: Sequence[int], ndim: int, strides: Sequence[int], in_channels: int,
               generator: torch.Generator) -> list[ConvPReLU]:
    """One ``ConvPReLU`` per ``(features, stride)`` pair, each reading the
    previous one's channels (the first ``in_channels``), as the reference's
    ``conv_stack`` lists them."""
    layers, c = [], in_channels
    for f, s in zip(features, strides):
        layers.append(ConvPReLU(c, f, generator, stride=s, ndim=ndim))
        c = f
    return layers
