"""Core tensor ops in plain PyTorch; the Hopper kernels live in ``ops.kernels``.

Counterpart of ``opticalflowscivis_tpu/ops``.  Ported so far: the 2-D and 3-D warps,
the half-pixel resize, SSIM and the Laplacian pyramid.  Every kernel in ``ops.kernels`` keeps its
plain version here as the CPU path and its oracle on the card.
"""

from opticalflowscivis_tpu_torch.ops.pyramid import gaussian_blur, lap_loss, laplacian_pyramid
from opticalflowscivis_tpu_torch.ops.resize import (
    resize_flow,
    resize_flow_nchw,
    resize_like,
    resize_nchw,
    resize_spatial,
)
from opticalflowscivis_tpu_torch.ops.ssim import ssim, ssim_matlab
from opticalflowscivis_tpu_torch.ops.warp import (
    backward_warp,
    backward_warp_bounded,
    multilinear_sample,
    warp2d_plain,
    warp3d_plain,
)

__all__ = [
    "backward_warp", "backward_warp_bounded", "multilinear_sample", "warp2d_plain", "warp3d_plain",
    "resize_flow", "resize_flow_nchw", "resize_like", "resize_nchw", "resize_spatial",
    "ssim", "ssim_matlab",
    "gaussian_blur", "lap_loss", "laplacian_pyramid",
]
