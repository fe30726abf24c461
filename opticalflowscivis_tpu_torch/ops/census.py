"""Census (ternary) transform and census loss, 2-D and 3-D.

Counterpart of ``opticalflowscivis_tpu/ops/census.py``:

- RIFE's ``Ternary``: 7x7 patches, soft-ternary normalisation
  ``t / sqrt(0.81 + t^2)``, hamming distance ``mean(d^2 / (0.1 + d^2))``,
  multiplied by a 1-pixel-border validity mask.
- UPFlow's ``census_loss_torch`` (``robust=True``): the same transform, the
  penalty ``(|d| + 0.01)^0.4`` averaged inside an occlusion mask eroded by the
  border mask.

Patches are gathered by shifting and stacking.  Channels-last ``[B, *S, C]``.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F


def _extract_patches(img: torch.Tensor, radius: int) -> torch.Tensor:
    """``[B, *S, 1] -> [B, *S, (2r+1)^ndim]`` zero-padded neighbourhood values."""
    spatial = tuple(img.shape[1:-1])
    ip = F.pad(img[..., 0], (radius, radius) * len(spatial))
    outs = []
    for off in itertools.product(range(2 * radius + 1), repeat=len(spatial)):
        outs.append(ip[(slice(None),) + tuple(slice(o, o + s) for o, s in zip(off, spatial))])
    return torch.stack(outs, dim=-1)


def census_transform(img: torch.Tensor, patch_size: int = 7) -> torch.Tensor:
    """Soft ternary transform of an image ``[B, *S, C]``; more than one channel
    is collapsed to its mean first."""
    if img.shape[-1] != 1:
        img = img.mean(dim=-1, keepdim=True)
    patches = _extract_patches(img, patch_size // 2)
    t = patches - img
    return t / torch.sqrt(0.81 + t * t)


def _hamming(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    d = (t1 - t2) ** 2
    return (d / (0.1 + d)).mean(dim=-1, keepdim=True)


def _border_mask(spatial: tuple[int, ...], pad: int, dtype, device) -> torch.Tensor:
    inner = torch.ones([s - 2 * pad for s in spatial], dtype=dtype, device=device)
    return F.pad(inner, (pad, pad) * len(spatial))[None, ..., None]


def census_loss(
    img0: torch.Tensor,
    img1: torch.Tensor,
    mask: torch.Tensor | None = None,
    patch_size: int = 7,
    robust: bool = False,
    mesh=None,
) -> torch.Tensor:
    """Census distance between two images.

    ``robust=False`` reproduces RIFE's Ternary map semantics (mean over the
    1-pixel-valid region); ``robust=True`` applies UPFlow's ``(|d| + 0.01)^0.4``
    penalty normalised by the (optionally occlusion-) masked area.  With a
    data-parallel ``mesh`` the sums run over the global batch (without a mask
    the area is one image's, so the term sums over the batch's images).
    """
    dist = _hamming(census_transform(img0, patch_size), census_transform(img1, patch_size))
    valid = _border_mask(tuple(img0.shape[1:-1]), 1, dist.dtype, dist.device)
    if robust:
        dist = (dist.abs() + 0.01) ** 0.4
    m = valid if mask is None else valid * mask
    num, den = (dist * m).sum(), m.sum()
    if mesh is None:
        return num / (den + 1e-6)
    return mesh.batch_ratio(num, den, 1e-6, den_batched=mask is not None)
