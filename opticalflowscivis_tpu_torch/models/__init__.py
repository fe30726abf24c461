"""Models: the RIFE-style IFNet in 2-D and 3-D and the UPFlow pyramid flow
network (the zoo models are ported in a later slice, see ROADMAP)."""

from opticalflowscivis_tpu_torch.models.ifnet import IFBlock, IFNet, ifnet_2d, ifnet_3d
from opticalflowscivis_tpu_torch.models.upflow import UPFlowConfig, UPFlowNet

__all__ = ["IFBlock", "IFNet", "ifnet_2d", "ifnet_3d", "UPFlowConfig", "UPFlowNet"]
