"""Loss library of the RIFE and UPFlow training paths, as plain functions.

Counterpart of ``opticalflowscivis_tpu/losses``.  ``lap_loss`` and SSIM live
in ``ops`` (shared with the metrics); ``vgg_perceptual_loss`` in
``losses.perceptual``.
"""

from opticalflowscivis_tpu_torch.losses.basic import (
    charbonnier,
    epe,
    flow_supervision,
    l1_loss,
    photometric_loss,
    smoothness_loss,
    sobel_loss,
)
from opticalflowscivis_tpu_torch.losses.rife import RIFELossWeights, rife_losses
from opticalflowscivis_tpu_torch.losses.selfsup import (
    SPTransformConfig,
    eq_loss,
    oi_loss,
    sp_transform_pair,
)
from opticalflowscivis_tpu_torch.losses.upflow import UPFlowLossConfig, upflow_losses
from opticalflowscivis_tpu_torch.losses.perceptual import vgg_perceptual_loss

__all__ = [
    "charbonnier", "epe", "l1_loss", "photometric_loss", "smoothness_loss",
    "sobel_loss", "flow_supervision", "RIFELossWeights", "rife_losses",
    "UPFlowLossConfig", "upflow_losses", "vgg_perceptual_loss",
    "SPTransformConfig", "sp_transform_pair", "eq_loss", "oi_loss",
]
