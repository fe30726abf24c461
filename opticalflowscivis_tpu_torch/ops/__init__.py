"""Core tensor ops in plain PyTorch; the Hopper kernels live in ``ops.kernels``.

Counterpart of ``opticalflowscivis_tpu/ops``: the 2-D and 3-D warps, the
resizes, the cost volume, the occlusion check, the census transform, SSIM and
the Laplacian pyramid.  Every kernel in ``ops.kernels`` keeps its plain version
here as the CPU path and its oracle on the card.
"""

from opticalflowscivis_tpu_torch.ops.census import census_loss, census_transform
from opticalflowscivis_tpu_torch.ops.correlation import cost_volume, cost_volume_plain
from opticalflowscivis_tpu_torch.ops.occlusion import occ_check

from opticalflowscivis_tpu_torch.ops.pyramid import gaussian_blur, lap_loss, laplacian_pyramid
from opticalflowscivis_tpu_torch.ops.resize import (
    resize_flow,
    resize_flow_nchw,
    resize_like,
    resize_nchw,
    resize_spatial,
    upsample_flow_as,
)
from opticalflowscivis_tpu_torch.ops.ssim import ssim, ssim_matlab
from opticalflowscivis_tpu_torch.ops.warp import (
    backward_warp,
    backward_warp_bounded,
    boundary_dilated_warp,
    multilinear_sample,
    warp2d_plain,
    warp3d_plain,
)

__all__ = [
    "backward_warp", "backward_warp_bounded", "boundary_dilated_warp", "multilinear_sample",
    "warp2d_plain", "warp3d_plain",
    "resize_flow", "resize_flow_nchw", "resize_like", "resize_nchw", "resize_spatial",
    "upsample_flow_as",
    "cost_volume", "cost_volume_plain", "occ_check", "census_loss", "census_transform",
    "ssim", "ssim_matlab",
    "gaussian_blur", "lap_loss", "laplacian_pyramid",
]
