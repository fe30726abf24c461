"""Gaussian / Laplacian pyramid and the Laplacian-pyramid L1 loss.

Counterpart of ``opticalflowscivis_tpu/ops/pyramid.py`` for 2-D fields and volumes:

- ``gaussian_blur``: the separable 5-tap binomial [1, 4, 6, 4, 1] / 16 along
  every spatial axis, with reflect padding;
- ``laplacian_pyramid``: level i = current − upsample(downsample(blur(current)));
  the downsample is plain ``::2`` striding, the upsample zero-interleaves and
  blurs with a gain of 2 per axis (4 in 2-D, 8 in 3-D), and an odd size's
  one-pixel overshoot is cropped;
- ``lap_loss``: the sum over 5 levels of the mean absolute difference of the
  two pyramids.

Arrays are channels-last ``[B, *S, C]`` as in the reference.  Inside, the
channels join the batch and each axis is one single-channel convolution
(``conv2d`` or ``conv3d`` by rank).  ``lap_loss`` computes in float32 whatever
the inputs' dtypes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_BINOMIAL5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _check_rank(x: torch.Tensor) -> None:
    if x.dim() not in (4, 5):
        raise ValueError(
            f"the pyramid takes channels-last fields [B, H, W, C] or volumes "
            f"[B, Z, Y, X, C], got {tuple(x.shape)}"
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
    """5-tap binomial filter along one spatial axis of ``x [N, 1, *S]``."""
    idx = torch.from_numpy(_reflect_index(x.shape[axis], 2)).to(x.device)
    shape = [1] * x.dim()
    shape[axis] = 5
    kernel = torch.tensor(_BINOMIAL5, dtype=x.dtype, device=x.device) * gain
    conv = F.conv2d if x.dim() == 4 else F.conv3d
    return conv(x.index_select(axis, idx), kernel.view(shape))


def _blur(x: torch.Tensor, gain_per_axis: float = 1.0) -> torch.Tensor:
    for axis in range(2, x.dim()):
        x = _blur_axis(x, axis, gain_per_axis)
    return x


def _to_planes(x: torch.Tensor) -> torch.Tensor:
    """``[B, *S, C]`` → ``[B*C, 1, *S]``."""
    return x.movedim(-1, 1).reshape((-1, 1) + tuple(x.shape[1:-1]))


def _from_planes(x: torch.Tensor, b: int) -> torch.Tensor:
    """``[B*C, 1, *S]`` → ``[B, *S, C]``."""
    return x.reshape((b, -1) + tuple(x.shape[2:])).movedim(1, -1)


def gaussian_blur(x: torch.Tensor, gain_per_axis: float = 1.0) -> torch.Tensor:
    """Separable binomial blur over the spatial axes of ``[B, *S, C]``."""
    _check_rank(x)
    return _from_planes(_blur(_to_planes(x), gain_per_axis), x.shape[0])


def _every_other(nd: int) -> tuple:
    return (slice(None), slice(None)) + (slice(None, None, 2),) * nd


def _upsample(x: torch.Tensor) -> torch.Tensor:
    """Zero-interleave 2x per spatial axis, then blur with gain 2 per axis."""
    spatial = x.shape[2:]
    up = x.new_zeros(tuple(x.shape[:2]) + tuple(2 * s for s in spatial))
    up[_every_other(len(spatial))] = x
    return _blur(up, gain_per_axis=2.0)


def _planes_pyramid(current: torch.Tensor, max_levels: int) -> list[torch.Tensor]:
    nd = current.dim() - 2
    pyr = []
    for _ in range(max_levels):
        down = _blur(current)[_every_other(nd)]
        up = _upsample(down)
        # for odd sizes `up` overshoots by one
        crop = (slice(None), slice(None)) + tuple(slice(0, s) for s in current.shape[2:])
        pyr.append(current - up[crop])
        current = down
    return pyr


def laplacian_pyramid(img: torch.Tensor, max_levels: int = 5) -> list[torch.Tensor]:
    """Difference pyramid of ``[B, *S, C]``, finest level first."""
    _check_rank(img)
    return [_from_planes(p, img.shape[0]) for p in _planes_pyramid(_to_planes(img), max_levels)]


def lap_loss(pred: torch.Tensor, target: torch.Tensor, max_levels: int = 5,
             shard=None) -> torch.Tensor:
    """Sum over levels of mean-|diff| between the two Laplacian pyramids.

    Both pyramids are built in one pass over the two stacked inputs, in
    float32.  On a depth shard (``shard``: the inputs are this rank's slices
    of axis 1) both are gathered first, and the loss is the whole one.
    """
    _check_rank(pred)
    if shard is not None:
        pred, target = shard.gather(pred, 1), shard.gather(target, 1)
    if pred.shape != target.shape:
        raise ValueError(f"shapes differ: {tuple(pred.shape)} and {tuple(target.shape)}")
    n = pred.shape[0] * pred.shape[-1]
    both = torch.cat([_to_planes(pred.float()), _to_planes(target.float())])
    levels = _planes_pyramid(both, max_levels)
    return sum((p[:n] - p[n:]).abs().mean() for p in levels)
