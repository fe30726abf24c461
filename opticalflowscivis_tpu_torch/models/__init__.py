"""Models: the RIFE-style IFNet in 2-D and 3-D with its optional
Contextnet/Unet refinement, and the UPFlow pyramid flow network.  The
pretrained RIFE zoo models live in ``models.ifnet_hd`` (HDv3) and
``models.ifnet_hd_legacy`` (HD v1 and v2)."""

from opticalflowscivis_tpu_torch.models.ifnet import IFBlock, IFNet, ifnet_2d, ifnet_3d
from opticalflowscivis_tpu_torch.models.refine import Contextnet, Unet
from opticalflowscivis_tpu_torch.models.upflow import UPFlowConfig, UPFlowNet

__all__ = [
    "IFNet", "IFBlock", "ifnet_2d", "ifnet_3d", "Contextnet", "Unet",
    "UPFlowConfig", "UPFlowNet",
]
