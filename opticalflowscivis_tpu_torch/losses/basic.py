"""Elementary loss functions on channels-last tensors, float32 accumulation.

Counterpart of ``opticalflowscivis_tpu/losses/basic.py``: images
``[B, *S, C]``, flows ``[B, *S, ndim]`` or, from the model,
``[B, *S, 2 * ndim]`` as (F_t→0, F_t→1), each (dy, dx) or (dz, dy, dx).
``sobel_loss`` is 2-D only, as in the reference.

On a depth shard (``shard``, a ``parallel.spatial.DepthShard``; spatially
sharded training) the tensors are this rank's slices of axis 1 and a loss is
this rank's share under the rule of ``parallel.spatial``: the means are this
rank's means, and a sum over voxels counts ``n_space`` times this rank's sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d, warp3d


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (_f32(pred) - _f32(target)).abs().mean()


def charbonnier(x: torch.Tensor, alpha: float = 0.25, epsilon: float = 1e-9) -> torch.Tensor:
    """Generalized Charbonnier penalty ``(x² + ε²)^α``."""
    return (_f32(x) ** 2 + epsilon**2) ** alpha


def epe(flow_pred: torch.Tensor, flow_gt: torch.Tensor, mean: bool = True) -> torch.Tensor:
    """End-point error: per-pixel L2 norm of the flow difference."""
    e = torch.linalg.vector_norm(_f32(flow_pred) - _f32(flow_gt), dim=-1)
    return e.mean() if mean else e


def sobel_loss(pred_flow: torch.Tensor, gt_flow: torch.Tensor) -> torch.Tensor:
    """L1 between the Sobel x/y edge maps of two 2-D flow fields, per channel."""
    kx = torch.tensor([[1, 0, -1], [2, 0, -2], [1, 0, -1]], dtype=torch.float32,
                      device=pred_flow.device)
    kernels = torch.stack([kx, kx.T])[:, None]  # [2, 1, 3, 3]

    def edges(f: torch.Tensor) -> torch.Tensor:
        b, h, w, c = f.shape
        planes = _f32(f).permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
        return F.conv2d(planes, kernels, padding=1)  # cross-correlation, as the reference

    return (edges(pred_flow) - edges(gt_flow)).abs().mean()


def photometric_loss(
    merged: torch.Tensor,
    flow: torch.Tensor,
    img0: torch.Tensor,
    img1: torch.Tensor,
    ndim: int,
    fast_warp_r: int = 0,
    shard=None,
) -> torch.Tensor:
    """RIFE's photometric consistency term.

    Warps the prediction by each flow half (zeros padding) and penalizes the
    Charbonnier difference against the opposite input frame.  The channel sum
    is divided by 3 and the batch sum by B whatever the channel count, which
    keeps the reference's loss scale.

    The two full-resolution warps go through ``warp2d`` / ``warp3d``: the
    Hopper kernels on CUDA tensors, the plain versions on the CPU.  In 2-D the
    flow is clipped to ``±fast_warp_r`` (0 = unbounded), the bound the model's
    own warps have; in 3-D the warp is unbounded, as the reference's is.
    On a depth shard each warp takes the gathered prediction and this rank's
    flow zero-padded to the whole, and keeps this rank's slices.
    """
    if ndim not in (2, 3) or merged.dim() != ndim + 2:
        raise ValueError(f"ndim {ndim} does not fit a prediction of {tuple(merged.shape)}")
    per_image_denom = merged.shape[0] * 3
    pred = merged.movedim(-1, 1).contiguous()
    flow_nchw = flow.movedim(-1, 1).to(pred.dtype)
    if shard is not None:
        pred = shard.gather(pred, 2)

    def one_side(f: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if shard is not None:
            f = shard.pad_to_whole(f, 2)
        if ndim == 2:
            warped = warp2d(pred, f, fast_warp_r, "zeros")
        else:
            warped = warp3d(pred, f, 0, 0, "zeros")
        if shard is not None:
            warped = shard.scatter(warped, 2)
        return charbonnier(_f32(warped.movedim(1, -1)) - _f32(target)).sum() / per_image_denom

    loss = one_side(flow_nchw[:, ndim:], img0) + one_side(flow_nchw[:, :ndim], img1)
    return loss / 2.0 * (1 if shard is None else shard.n)


def smoothness_loss(flow: torch.Tensor, shard=None) -> torch.Tensor:
    """First-order Charbonnier smoothness of a flow field.

    Zero-padded forward differences, summed over pixels, averaged over
    channels and divided by the batch size.  On a depth shard the difference
    across the shard's end reads the next rank's first slice (an ``edge``
    halo, whose last difference is the volume's zero).
    """
    f = _f32(flow)
    total = 0.0
    for axis in range(1, f.dim() - 1):
        if shard is not None and axis == 1:
            total = total + charbonnier(torch.diff(shard.halo(f, (0, 1), "edge", 1), dim=1))
            continue
        d = torch.diff(f, dim=axis)
        pad = [0, 0] * f.dim()
        pad[2 * (f.dim() - 1 - axis) + 1] = 1  # F.pad counts from the last axis
        total = total + charbonnier(F.pad(d, pad))
    return (total / 2.0).mean(dim=-1).sum() / f.shape[0] * (1 if shard is None else shard.n)


def flow_supervision(
    flow_list: list[torch.Tensor],
    flow_teacher: torch.Tensor | None,
    gt_flow: torch.Tensor,
    ndim: int,
) -> torch.Tensor:
    """Supervised flow loss against a synthetic ground truth.

    ``gt_flow`` is the per-step velocity of the middle frame; under backward
    warping F_t→1 = +v and F_t→0 = −v.  L1 over all student blocks (both
    directions) plus the teacher, averaged over the terms.
    """
    gt = _f32(gt_flow)
    flows = list(flow_list) + ([flow_teacher] if flow_teacher is not None else [])
    loss = sum(l1_loss(f[..., ndim:], gt) + l1_loss(f[..., :ndim], -gt) for f in flows)
    return loss / (2 * len(flows))
