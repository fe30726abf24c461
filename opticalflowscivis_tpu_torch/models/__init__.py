"""Models: the RIFE-style IFNet in 2-D and 3-D (UPFlow and the zoo models are
ported in later slices, see ROADMAP)."""

from opticalflowscivis_tpu_torch.models.ifnet import IFBlock, IFNet, ifnet_2d, ifnet_3d

__all__ = ["IFBlock", "IFNet", "ifnet_2d", "ifnet_3d"]
