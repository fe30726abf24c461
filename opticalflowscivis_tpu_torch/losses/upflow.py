"""UPFlow unsupervised loss composition.

Counterpart of ``opticalflowscivis_tpu/losses/upflow.py``:

- occlusion masks from the forward-backward check (``ops.occ_check``);
- photometric loss (abs_robust / charbonnier / L1 / weighted SSIM), optionally
  occlusion-normalised;
- census loss (``ops.census_loss``, robust) weighted by ``census_weight``;
- edge-aware first / second-order smoothness or plain delta smoothness, at full
  or 1/4 scale;
- multi-scale distillation of the final flow into the pyramid levels ('down'
  or 'upup' style).

All tensors are channels-last ``[B, H, W, C]`` with row-major (dy, dx) flows,
as in the reference; sums run in float32.  The full-resolution warps go through
``ops.backward_warp`` (on CUDA tensors the ``warp2d`` kernel, unbounded).
"""

from __future__ import annotations

import dataclasses

import torch

from opticalflowscivis_tpu_torch.ops.census import census_loss
from opticalflowscivis_tpu_torch.ops.occlusion import occ_check
from opticalflowscivis_tpu_torch.ops.resize import resize_like, upsample_flow_as
from opticalflowscivis_tpu_torch.ops.warp import backward_warp, boundary_dilated_warp


@dataclasses.dataclass(frozen=True)
class UPFlowLossConfig:
    occ_alpha_1: float = 0.1
    occ_alpha_2: float = 0.5
    stop_occ_gradient: bool = False
    photo_loss_type: str = "abs_robust"  # abs_robust | charbonnier | L1 | SSIM
    photo_loss_delta: float = 0.4
    photo_loss_use_occ: bool = False
    photo_weight: float = 1.0
    census_weight: float = 0.0
    smooth_level: str = "final"  # final | 1/4
    smooth_type: str = "edge"  # edge | delta
    smooth_order_1_weight: float = 1.0
    smooth_order_2_weight: float = 0.0
    msd_weight: float = 0.0
    msd_style: str = "upup"  # down | upup
    msd_use_occ: bool = True


def photo_loss_multi_type(
    x: torch.Tensor,
    y: torch.Tensor,
    occ_mask: torch.Tensor,
    loss_type: str = "abs_robust",
    delta: float = 0.4,
    use_occ: bool = False,
) -> torch.Tensor:
    x = x.float()
    y = y.float()
    if loss_type == "abs_robust":
        diff = ((x - y).abs() + 0.01) ** delta
    elif loss_type == "charbonnier":
        diff = ((x - y) ** 2 + 1e-6) ** delta
    elif loss_type == "L1":
        diff = (x - y + 1e-6).abs()
    elif loss_type == "SSIM":
        diff, occ_mask = weighted_ssim(x, y, occ_mask)
        use_occ = True
    else:
        raise ValueError(f"wrong photo_loss type: {loss_type}")
    if use_occ:
        return (diff * occ_mask).sum() / (occ_mask.sum() + 1e-6)
    return diff.mean()


def weighted_ssim(x, y, weight, c1=float("inf"), c2=9e-6, weight_epsilon=0.01):
    """Occlusion-weighted SSIM loss map with 'valid' 3x3 pooling; returns the
    map and the pooled weight, both ``[B, H - 2, W - 2, .]``."""

    def pool(z):
        out = z
        for axis in (1, 2):
            n = out.shape[axis] - 2
            out = (out.narrow(axis, 0, n) + out.narrow(axis, 1, n) + out.narrow(axis, 2, n)) / 3.0
        return out

    avg_w = pool(weight)
    w_plus = weight + weight_epsilon
    inv_avg_w = 1.0 / (avg_w + weight_epsilon)

    def wpool(z):
        return pool(z * w_plus) * inv_avg_w

    mu_x, mu_y = wpool(x), wpool(y)
    sx = wpool(x * x) - mu_x**2
    sy = wpool(y * y) - mu_y**2
    sxy = wpool(x * y) - mu_x * mu_y
    if c1 == float("inf"):
        n, d = 2 * sxy + c2, sx + sy + c2
    elif c2 == float("inf"):
        n, d = 2 * mu_x * mu_y + c1, mu_x**2 + mu_y**2 + c1
    else:
        n = (2 * mu_x * mu_y + c1) * (2 * sxy + c2)
        d = (mu_x**2 + mu_y**2 + c1) * (sx + sy + c2)
    return ((1 - n / d) / 2).clamp(0, 1), avg_w


def edge_aware_smoothness(img: torch.Tensor, pred: torch.Tensor, order: int = 1) -> torch.Tensor:
    """Image-gradient-weighted flow gradients, summed over the two axes."""
    img = img.float()
    pred = pred.float()
    total = 0.0
    for axis in (1, 2):

        def grad(z, stride=1, ax=axis):
            n = z.shape[ax] - stride
            return z.narrow(ax, 0, n) - z.narrow(ax, stride, n)

        if order == 1:
            pg = grad(pred)
            ig = grad(img)
        else:
            pg = grad(grad(pred))
            ig = grad(img, stride=2)
        w = torch.exp(-ig.abs().mean(dim=-1, keepdim=True))
        total = total + (pg.abs() * w).mean()
    return total


def flow_smooth_delta(flow: torch.Tensor, second_order: bool = False) -> torch.Tensor:
    """Plain L1 of the flow's gradients."""
    f = flow.float()
    dy = f[:, 1:] - f[:, :-1]
    dx = f[:, :, 1:] - f[:, :, :-1]
    loss = dx.abs().mean() + dy.abs().mean()
    if second_order:
        dx2 = dx[:, :, 1:] - dx[:, :, :-1]
        dxdy = dx[:, 1:] - dx[:, :-1]
        dydx = dy[:, :, 1:] - dy[:, :, :-1]
        dy2 = dy[:, 1:] - dy[:, :-1]
        for t in (dx2, dxdy, dydx, dy2):
            loss = loss + t.abs().mean()
    return loss


def upflow_losses(
    outputs: dict,
    im1: torch.Tensor,
    im2: torch.Tensor,
    cfg: UPFlowLossConfig,
    raw: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
):
    """(total, parts) from channels-last ``UPFlowNet`` outputs.

    ``raw = (im1_raw, im2_raw, start)`` enables boundary-dilated warping: the
    photometric and census warps sample the *uncropped* images at the crop
    offset ``start [B, 2]``, so flow vectors that point outside the training
    crop hit real pixels instead of border padding.  ``None`` keeps the
    border-padded warp (the zero-offset case).
    """
    flow_f, flow_b = outputs["flow_f"], outputs["flow_b"]
    flows = outputs["flows"]

    occ_fw, occ_bw = occ_check(flow_f, flow_b, cfg.occ_alpha_1, cfg.occ_alpha_2)
    if cfg.stop_occ_gradient:
        occ_fw, occ_bw = occ_fw.detach(), occ_bw.detach()

    # --- smooth loss
    if cfg.smooth_level == "final":
        s_ff, s_fb, s_im1, s_im2 = flow_f, flow_b, im1, im2
    else:  # '1/4': the finest decoded level
        s_ff, s_fb = flows[0]
        s_im1 = resize_like(im1, s_ff)
        s_im2 = resize_like(im2, s_fb)
    smooth = torch.zeros((), dtype=torch.float32, device=flow_f.device)
    for w, order in ((cfg.smooth_order_1_weight, 1), (cfg.smooth_order_2_weight, 2)):
        if w > 0:
            if cfg.smooth_type == "edge":
                smooth = smooth + w * (
                    edge_aware_smoothness(s_im1, s_ff, order)
                    + edge_aware_smoothness(s_im2, s_fb, order)
                )
            else:
                smooth = smooth + w * (
                    flow_smooth_delta(s_ff, order == 2) + flow_smooth_delta(s_fb, order == 2)
                )

    # --- photometric loss
    if raw is not None:
        im1_raw, im2_raw, start = raw
        im1_warp = boundary_dilated_warp(im2_raw, flow_f, start)
        im2_warp = boundary_dilated_warp(im1_raw, flow_b, start)
    else:
        im1_warp = backward_warp(im2, flow_f, padding="border")
        im2_warp = backward_warp(im1, flow_b, padding="border")
    photo = photo_loss_multi_type(
        im1, im1_warp, occ_fw, cfg.photo_loss_type, cfg.photo_loss_delta, cfg.photo_loss_use_occ,
    ) + photo_loss_multi_type(
        im2, im2_warp, occ_bw, cfg.photo_loss_type, cfg.photo_loss_delta, cfg.photo_loss_use_occ,
    )
    photo = photo * cfg.photo_weight

    # --- census loss
    census = torch.zeros((), dtype=torch.float32, device=flow_f.device)
    if cfg.census_weight > 0:
        census = cfg.census_weight * (
            census_loss(im1, im1_warp, mask=occ_fw if cfg.photo_loss_use_occ else None,
                        robust=True)
            + census_loss(im2, im2_warp, mask=occ_bw if cfg.photo_loss_use_occ else None,
                          robust=True)
        )

    # --- multi-scale distillation
    msd = torch.zeros((), dtype=torch.float32, device=flow_f.device)
    if cfg.msd_weight > 0:
        label_f, label_b = flow_f.detach(), flow_b.detach()
        for scale_f, scale_b in flows:
            if cfg.msd_style == "down":
                lf = upsample_flow_as(label_f, scale_f)
                lb = upsample_flow_as(label_b, scale_b)
                of = resize_like(occ_fw, scale_f, method="nearest")
                ob = resize_like(occ_bw, scale_b, method="nearest")
                sf, sb = scale_f, scale_b
            else:  # 'upup'
                lf, lb = label_f, label_b
                sf = upsample_flow_as(scale_f, label_f)
                sb = upsample_flow_as(scale_b, label_b)
                of, ob = occ_fw, occ_bw
            msd = msd + photo_loss_multi_type(sf, lf, of, "abs_robust", use_occ=cfg.msd_use_occ)
            msd = msd + photo_loss_multi_type(sb, lb, ob, "abs_robust", use_occ=cfg.msd_use_occ)
        msd = msd * cfg.msd_weight

    parts = {
        "photo_loss": photo,
        "smooth_loss": smooth,
        "census_loss": census,
        "msd_loss": msd,
        "occ_fw_mean": occ_fw.mean(),
    }
    total = photo + smooth + census + msd
    parts["loss_total"] = total
    return total, parts
