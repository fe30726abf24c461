"""Gaussian / Laplacian pyramid and the Laplacian-pyramid L1 loss.

Counterpart of ``opticalflowscivis_tpu/ops/pyramid.py`` for 2-D fields:

- ``gaussian_blur``: the separable 5-tap binomial [1, 4, 6, 4, 1] / 16 along
  every spatial axis, with reflect padding;
- ``laplacian_pyramid``: level i = current − upsample(downsample(blur(current)));
  the downsample is plain ``::2`` striding, the upsample zero-interleaves and
  blurs with a gain of 2 per axis, and an odd size's one-pixel overshoot is
  cropped;
- ``lap_loss``: the sum over 5 levels of the mean absolute difference of the
  two pyramids.

Arrays are channels-last ``[B, *S, C]`` as in the reference.  Inside, the
channels join the batch and each axis is one depthwise convolution, so that
3-D volumes only need ``conv3d`` and a third axis (ROADMAP A.8).  ``lap_loss``
computes in float32 whatever the inputs' dtypes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_BINOMIAL5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _check_2d(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise NotImplementedError(
            f"the pyramid is ported for 2-D fields [B, H, W, C], got {tuple(x.shape)}; "
            "volumes come with the RIFE-3D slice (ROADMAP A.8)"
        )


def _reflect_index(n: int, pad: int) -> np.ndarray:
    """Source indices of an axis of length ``n`` reflect-padded by ``pad``
    on both sides (edge not repeated); like numpy's, it keeps reflecting when
    ``pad >= n``, which ``F.pad`` refuses."""
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


def _blur_axis(x: torch.Tensor, axis: int, gain: float) -> torch.Tensor:
    """5-tap binomial filter along one spatial axis of ``x [N, 1, H, W]``."""
    idx = torch.from_numpy(_reflect_index(x.shape[axis], 2)).to(x.device)
    shape = [1, 1, 1, 1]
    shape[axis] = 5
    kernel = torch.tensor(_BINOMIAL5, dtype=x.dtype, device=x.device) * gain
    return F.conv2d(x.index_select(axis, idx), kernel.view(shape))


def _blur(x: torch.Tensor, gain_per_axis: float = 1.0) -> torch.Tensor:
    for axis in range(2, x.dim()):
        x = _blur_axis(x, axis, gain_per_axis)
    return x


def _to_planes(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, C]`` → ``[B*C, 1, H, W]``."""
    b, h, w, c = x.shape
    return x.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)


def _from_planes(x: torch.Tensor, b: int) -> torch.Tensor:
    """``[B*C, 1, H, W]`` → ``[B, H, W, C]``."""
    return x.reshape(b, -1, x.shape[2], x.shape[3]).permute(0, 2, 3, 1)


def gaussian_blur(x: torch.Tensor, gain_per_axis: float = 1.0) -> torch.Tensor:
    """Separable binomial blur over the spatial axes of ``[B, H, W, C]``."""
    _check_2d(x)
    return _from_planes(_blur(_to_planes(x), gain_per_axis), x.shape[0])


def _upsample(x: torch.Tensor) -> torch.Tensor:
    """Zero-interleave 2x per spatial axis, then blur with gain 2 per axis."""
    n, _, h, w = x.shape
    up = x.new_zeros((n, 1, 2 * h, 2 * w))
    up[:, :, ::2, ::2] = x
    return _blur(up, gain_per_axis=2.0)


def _planes_pyramid(current: torch.Tensor, max_levels: int) -> list[torch.Tensor]:
    pyr = []
    for _ in range(max_levels):
        down = _blur(current)[:, :, ::2, ::2]
        up = _upsample(down)
        # for odd sizes `up` overshoots by one
        pyr.append(current - up[:, :, : current.shape[2], : current.shape[3]])
        current = down
    return pyr


def laplacian_pyramid(img: torch.Tensor, max_levels: int = 5) -> list[torch.Tensor]:
    """Difference pyramid of ``[B, H, W, C]``, finest level first."""
    _check_2d(img)
    return [_from_planes(p, img.shape[0]) for p in _planes_pyramid(_to_planes(img), max_levels)]


def lap_loss(pred: torch.Tensor, target: torch.Tensor, max_levels: int = 5) -> torch.Tensor:
    """Sum over levels of mean-|diff| between the two Laplacian pyramids.

    Both pyramids are built in one pass over the two stacked inputs, in
    float32.
    """
    _check_2d(pred)
    if pred.shape != target.shape:
        raise ValueError(f"shapes differ: {tuple(pred.shape)} and {tuple(target.shape)}")
    n = pred.shape[0] * pred.shape[3]
    both = torch.cat([_to_planes(pred.float()), _to_planes(target.float())])
    levels = _planes_pyramid(both, max_levels)
    return sum((p[:n] - p[n:]).abs().mean() for p in levels)
