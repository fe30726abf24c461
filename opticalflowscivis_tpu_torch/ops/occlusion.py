"""Forward-backward occlusion check.

Counterpart of ``opticalflowscivis_tpu/ops/occlusion.py`` (UPFlow's
``occ_check_model`` with ``occ_type='for_back_check'``): a pixel in frame 0 is
visible iff

    |f_fw(p) + f_bw(p + f_fw(p))|^2  <=  alpha1 * (|f_fw|^2 + |f_bw_warped|^2) + alpha2

The returned masks are 1 where visible; zero flow everywhere means all
visible.  ``bound_check=True`` also marks pixels whose target lies outside the
image as occluded, through the validity mask of the zeros-padded warp.
Channels-last ``[B, *S, ndim]`` flows; the masks are comparisons and carry no
gradient.
"""

from __future__ import annotations

import torch

from opticalflowscivis_tpu_torch.ops.warp import backward_warp


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum(dim=-1, keepdim=True)


def occ_check(
    flow_fw: torch.Tensor,
    flow_bw: torch.Tensor,
    alpha1: float = 0.1,
    alpha2: float = 0.5,
    bound_check: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (visible_mask_fw, visible_mask_bw), each ``[B, *S, 1]`` in {0, 1}."""

    def one_direction(fa, fb):
        if bound_check:
            fb_warped, valid = backward_warp(fb, fa, padding="zeros", return_mask=True)
        else:
            fb_warped = backward_warp(fb, fa, padding="zeros")
        diff = fa + fb_warped
        thresh = alpha1 * (_sq_norm(fa) + _sq_norm(fb_warped)) + alpha2
        vis = (_sq_norm(diff) <= thresh).to(fa.dtype)
        if bound_check:
            vis = vis * (valid > 0.999).to(fa.dtype)
        return vis

    return one_direction(flow_fw, flow_bw), one_direction(flow_bw, flow_fw)
