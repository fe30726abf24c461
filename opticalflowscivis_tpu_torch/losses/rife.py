"""RIFE training loss composition.

Counterpart of ``opticalflowscivis_tpu/losses/rife.py``: seven weighted terms
(reconstruction, teacher reconstruction, distillation, block L1 regularizer,
photometric, smoothness, flow supervision) plus the optional flow leash, and
the ``parts`` dict under the same keys.  The 3-D recipe is a preset of
``RIFELossWeights``, not a code fork.  Every term is a mean over the batch
but the distillation guard, which under data parallelism tests the global
mean (``Mesh.batch_mean``).  On depth shards (``shard``) each term is this
rank's share under the rule of ``parallel.spatial``, and the guard tests the
mean over the whole mesh.

Spans (``utils.profiling.span``): ``ofs.losses`` around the composition and
``ofs.losses.<part>`` around each term computed (``l1``, ``tea``, ``reg``,
``photo``, ``smooth``, ``flow``, ``leash``: its key in ``parts`` without
``loss_``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch

from opticalflowscivis_tpu_torch.losses.basic import (
    flow_supervision,
    l1_loss,
    photometric_loss,
    smoothness_loss,
)
from opticalflowscivis_tpu_torch.ops.pyramid import lap_loss
from opticalflowscivis_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class RIFELossWeights:
    """Loss lambdas of the reference's 2-D recipe; ``preset_3d`` holds the 3-D one."""

    l1: float = 1.0
    tea: float = 1.0
    distill: float = 0.01
    reg: float = 1e-6
    photo: float = 1e-5
    smooth: float = 0.0
    flow: float = 0.0
    use_lap: bool = True  # LapLoss for reconstruction; False -> plain L1 (3-D)
    # The bounded warps have zero gradient for |flow| >= r, so flows that
    # drift past the radius freeze every warp and collapse training.  The
    # leash penalizes the excess with a live gradient, pulling escaped flows
    # back inside the region where the warps are exact.
    flow_leash: float = 0.0  # weight; 0 = off
    flow_leash_radius: float = 0.0  # radius r (match the warp radius)

    @staticmethod
    def preset_2d(flow_supervised: bool = False) -> "RIFELossWeights":
        # lambda_flow = 0.5 is the reference's choice for supervised runs on rectangle data
        return RIFELossWeights(flow=0.5 if flow_supervised else 0.0)

    @staticmethod
    def preset_3d(distill: float = 0.0) -> "RIFELossWeights":
        """The 3-D lambdas, except distill: the reference's 0.1 collapses 3-D
        training in the JAX package (documented there), so it is off unless
        passed explicitly."""
        return RIFELossWeights(distill=distill, reg=0.0, photo=0.0, use_lap=False)


def _block_param_l1(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """L1 norm of every parameter of ``block2`` and ``block_tea`` (weights,
    biases and PReLU slopes alike), by parameter name."""
    terms = [p.float().abs().sum() for name, p in params.items()
             if "block2" in name or "block_tea" in name]
    return torch.stack(terms).sum() if terms else torch.zeros(())


def rife_losses(
    outputs: dict,
    img0: torch.Tensor,
    img1: torch.Tensor,
    gt: torch.Tensor,
    params: Mapping[str, torch.Tensor],
    weights: RIFELossWeights,
    ndim: int,
    gt_flow: torch.Tensor | None = None,
    fast_warp_r: int = 0,
    mesh=None,
    shard=None,
):
    """Compose the total RIFE training loss.

    Args:
      outputs: IFNet forward dict (flow_list / mask_list / merged / teacher /
        distill) with channels-last tensors.
      img0, img1: input frames ``[B, *S, C]``.
      gt: ground-truth middle frame.
      params: ``dict(model.named_parameters())``, for the block2 / teacher L1
        regularizer.
      weights: lambda configuration.
      ndim: spatial rank (2 or 3).
      gt_flow: optional ground-truth flow ``[B, *S, ndim]`` (per-step
        velocity, row-major axes) enabling the supervised term.
      mesh: the ``parallel.Mesh`` of a train step on this rank's part of
        the batch (None on one device).
      shard: the ``parallel.spatial.DepthShard`` when the tensors are this
        rank's depth shards (spatially sharded training), else None.

    Returns:
      (loss_G, dict of weighted components); the dict mirrors the 7-tuple
      appended to ``loss.json``.
    """
    with span("ofs.losses"):
        merged = outputs["merged"]
        flow_list = outputs["flow_list"]
        flow_teacher = outputs["flow_teacher"]
        merged_teacher = outputs["merged_teacher"]
        zero = torch.zeros((), dtype=torch.float32, device=gt.device)

        def recon(pred, target):
            if weights.use_lap:
                return lap_loss(pred, target, shard=shard)
            return l1_loss(pred, target)

        with span("ofs.losses.l1"):
            loss_l1 = recon(merged[-1], gt)
        loss_tea = zero
        if merged_teacher is not None:
            with span("ofs.losses.tea"):
                loss_tea = recon(merged_teacher, gt)

        loss_distill = outputs["loss_distill"].float()
        if mesh is not None:
            loss_distill = mesh.batch_mean(loss_distill)  # the guard sees the global value
        # NaN / overflow guard: a bad distill value is dropped, gradient included
        loss_distill = torch.where(
            torch.isnan(loss_distill) | (loss_distill > 10.0), zero, loss_distill
        )

        l1_reg = loss_photo = loss_smooth = loss_flow = zero
        if weights.reg:
            with span("ofs.losses.reg"):
                l1_reg = _block_param_l1(params)
        if weights.photo:
            with span("ofs.losses.photo"):
                loss_photo = photometric_loss(merged[-1], flow_list[-1], img0, img1, ndim,
                                              fast_warp_r=fast_warp_r, shard=shard)
        if weights.smooth:
            with span("ofs.losses.smooth"):
                loss_smooth = smoothness_loss(flow_list[-1], shard)
        if weights.flow and gt_flow is not None:
            with span("ofs.losses.flow"):
                loss_flow = flow_supervision(flow_list, flow_teacher, gt_flow, ndim)

        parts = {
            "loss_l1": loss_l1 * weights.l1,
            "loss_tea": loss_tea * weights.tea,
            "loss_distill": loss_distill * weights.distill,
            "l1_reg": l1_reg * weights.reg,
            "loss_photo": loss_photo * weights.photo,
            "loss_smooth": loss_smooth * weights.smooth,
            "loss_flow": loss_flow * weights.flow,
        }
        if weights.flow_leash and weights.flow_leash_radius:
            with span("ofs.losses.leash"):
                r = weights.flow_leash_radius
                loss_leash = zero
                for f in list(flow_list) + ([flow_teacher] if flow_teacher is not None else []):
                    excess = torch.relu(f.float().abs() - (r - 1.0))
                    loss_leash = loss_leash + (excess**2).mean()
            parts["loss_leash"] = loss_leash * weights.flow_leash
        loss_G = sum(parts.values())
        parts["loss_G"] = loss_G
        return loss_G, parts
