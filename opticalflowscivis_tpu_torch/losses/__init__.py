"""Loss library of the RIFE training path, as plain functions.

Counterpart of ``opticalflowscivis_tpu/losses``.  ``lap_loss`` and SSIM live
in ``ops`` (shared with the metrics).  The perceptual (VGG), UPFlow and
self-supervised losses are ported with their models (ROADMAP A.9, A.10).
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

__all__ = [
    "charbonnier", "epe", "l1_loss", "photometric_loss", "smoothness_loss",
    "sobel_loss", "flow_supervision", "RIFELossWeights", "rife_losses",
]
