"""Local cost-volume correlation (PWC / UPFlow style).

Counterpart of ``opticalflowscivis_tpu/ops/correlation.py``: for every integer
displacement ``d`` in ``[-max_disp, max_disp]^ndim``

    out[b, p, k(d)] = mean_c( f1[b, p, c] * f2[b, p + d, c] )

with zero padding outside ``f2``; the displacement axis is ordered row-major
over (d_axis0, d_axis1, ...), i.e. (dy, dx) in 2-D.  2-D with ``max_disp=4``
gives 81 output channels.

``cost_volume_plain`` is the readable version (shift, multiply, channel mean:
one pass per displacement), rank-generic and channels-first like the tensors
the models carry.  It is the CPU path and the oracle of the Hopper kernel
(``ops/kernels/correlation.py``, ``csrc/corr.cu``); on the card nothing on the
model's path calls it.  The kernel is 2-D only, as the TPU kernel it replaces:
a 3-D cost volume (``[B, C, Z, Y, X]``) has no kernel in either package and
takes the plain function on any device.

``cost_volume`` is the public channels-last form of the reference.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F


def cost_volume_plain(f1: torch.Tensor, f2: torch.Tensor, max_disp: int = 4) -> torch.Tensor:
    """Channels-first cost volume: ``[B, C, *S]`` x2 → ``[B, (2 md + 1)^ndim, *S]``.

    Products and sums in float32 (or the inputs' wider type), the result in
    ``f1``'s dtype.  Differentiable through autograd: that is the plain
    backward the kernel's gradients are held against.
    """
    if f1.shape != f2.shape:
        raise ValueError(f"shape mismatch: {tuple(f1.shape)} vs {tuple(f2.shape)}")
    if f1.dim() < 3:
        raise ValueError(f"expected [B, C, *S] feature maps, got {tuple(f1.shape)}")
    if max_disp < 0:
        raise ValueError(f"max_disp must be >= 0, got {max_disp}")
    spatial = tuple(f1.shape[2:])
    ndim = len(spatial)
    c = f1.shape[1]
    compute = torch.promote_types(f1.dtype, torch.float32)
    a = f1.to(compute)
    # F.pad lists the last axis first
    f2p = F.pad(f2.to(compute), (max_disp, max_disp) * ndim)
    outs = []
    for disp in itertools.product(range(2 * max_disp + 1), repeat=ndim):
        window = f2p[(slice(None), slice(None)) + tuple(
            slice(d, d + s) for d, s in zip(disp, spatial))]
        outs.append((a * window).sum(dim=1) / c)
    return torch.stack(outs, dim=1).to(f1.dtype)


def cost_volume(f1: torch.Tensor, f2: torch.Tensor, max_disp: int = 4) -> torch.Tensor:
    """Correlation volume of two channels-last feature maps.

    ``f1, f2: [B, *spatial, C]`` → ``[B, *spatial, (2 * max_disp + 1)^ndim]``.
    2-D inputs go through ``ops.kernels.correlation.cost_volume_kernel`` (the
    Hopper kernel on CUDA tensors, the plain version on CPU tensors); 3-D
    inputs take the plain version on any device.
    """
    a, b = f1.movedim(-1, 1), f2.movedim(-1, 1)
    if f1.dim() == 4:
        from opticalflowscivis_tpu_torch.ops.kernels.correlation import cost_volume_kernel

        return cost_volume_kernel(a, b, max_disp).movedim(1, -1)
    return cost_volume_plain(a, b, max_disp).movedim(1, -1)
