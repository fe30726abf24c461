"""Spatial resizing with flow-magnitude rescaling — plain PyTorch, 2-D and 3-D.

Counterpart of ``opticalflowscivis_tpu/ops/resize.py``.  The half-pixel
(``align_corners=False``) linear resize without antialiasing is what the
reference's ``jax.image.resize(method='linear', antialias=False)`` computes
and what ``F.interpolate(mode='bilinear' / 'trilinear', align_corners=False)``
computes.
Flow fields are pixel displacements, so ``resize_flow`` also scales each flow
channel by the size ratio of its own axis.

The public functions take channels-last ``[B, *S, C]``; the ``*_nchw`` forms
take the channels-first tensors the model carries (``[B, C, H, W]`` or
``[B, C, Z, Y, X]``).  The align-corners branch is
UPFlow's and is ported with it (ROADMAP A.9).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


_MODES = {2: "bilinear", 3: "trilinear"}


def _check_rank(x: torch.Tensor, spatial) -> int:
    ndim = x.dim() - 2
    if ndim not in _MODES or len(spatial) != ndim:
        raise ValueError(
            f"cannot resize {tuple(x.shape)} to spatial size {tuple(spatial)}: "
            "expected a 2-D or 3-D field and one size per spatial axis"
        )
    return ndim


def resize_nchw(x: torch.Tensor, spatial: tuple[int, ...]) -> torch.Tensor:
    """Half-pixel linear resize of ``[B, C, *S]`` to ``[B, C, *spatial]``."""
    ndim = _check_rank(x, spatial)
    if tuple(x.shape[2:]) == tuple(spatial):
        return x
    return F.interpolate(x, size=tuple(spatial), mode=_MODES[ndim], align_corners=False)


def resize_flow_nchw(flow: torch.Tensor, spatial: tuple[int, ...]) -> torch.Tensor:
    """Resize ``[B, k * ndim, *S]`` displacement groups and rescale the values
    of each channel by the size ratio of its own axis."""
    ndim = flow.dim() - 2
    if flow.shape[1] % ndim:
        raise ValueError(f"flow channels {flow.shape[1]} not a multiple of ndim {ndim}")
    src = flow.shape[2:]
    out = resize_nchw(flow, spatial)
    ratios = torch.tensor(
        [t / s for t, s in zip(spatial, src)], dtype=out.dtype, device=out.device
    )
    return out * ratios.repeat(flow.shape[1] // ndim).view((1, -1) + (1,) * ndim)


def _check_align(align_corners: bool) -> None:
    if align_corners:
        raise NotImplementedError(
            "align_corners=True is UPFlow's resize and is ported with it "
            "(ROADMAP A.9)"
        )


def resize_spatial(
    x: torch.Tensor, spatial: tuple[int, ...], align_corners: bool = False
) -> torch.Tensor:
    """Resize channels-last ``[B, *S, C]`` to ``[B, *spatial, C]``."""
    _check_align(align_corners)
    return resize_nchw(x.movedim(-1, 1), spatial).movedim(1, -1)


def resize_like(x: torch.Tensor, ref: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    return resize_spatial(x, tuple(ref.shape[1:-1]), align_corners)


def resize_flow(
    flow: torch.Tensor, spatial: tuple[int, ...], align_corners: bool = False
) -> torch.Tensor:
    """Resize a channels-last displacement field and rescale it per axis."""
    _check_align(align_corners)
    return resize_flow_nchw(flow.movedim(-1, 1), spatial).movedim(1, -1)
