"""Self-supervised spatial-transform distillation (ARFlow / UPFlow ex_runner).

Counterpart of ``opticalflowscivis_tpu/losses/selfsup.py``:

- a random affine transform T (rotation, isotropic zoom, translation) plus
  appearance noise is applied to the frame pair;
- the *teacher* flow comes from the un-transformed pair (detached);
- the *student* runs on the transformed pair, and ``eq_loss`` penalises
  |student_flow - T(teacher_flow)| (transform-equivariance distillation);
- ``oi_loss`` is the occlusion-aware photometric loss on the transformed pair.

Channels-last ``[B, H, W, C]`` tensors.  The affine resampling reads the image
at arbitrary coordinates (``ops.multilinear_sample``, a plain gather on any
device); the flow vectors are rotated and scaled by the affine's linear part.
Random draws come from a ``torch.Generator``: they are not the reference's
``jax.random`` numbers, so parity tests hand the same drawn parameters to both.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from opticalflowscivis_tpu_torch.losses.upflow import photo_loss_multi_type
from opticalflowscivis_tpu_torch.ops.occlusion import occ_check
from opticalflowscivis_tpu_torch.ops.warp import backward_warp, multilinear_sample


@dataclasses.dataclass(frozen=True)
class SPTransformConfig:
    max_rotate_deg: float = 10.0
    min_zoom: float = 0.9
    max_zoom: float = 1.1
    max_translate: float = 0.1  # fraction of image size
    noise_std: float = 0.02
    add_noise: bool = True


def _uniform(shape, lo: float, hi: float, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (lo + (hi - lo) * u).to(device)


def random_affine_params(generator: torch.Generator, batch: int, cfg: SPTransformConfig,
                         device: str | torch.device = "cpu"):
    """Per-item (theta [B], zoom [B], (ty, tx) [B, 2]) draws, float32 on ``device``."""
    theta = _uniform((batch,), -cfg.max_rotate_deg, cfg.max_rotate_deg, generator, device)
    theta = theta * (math.pi / 180.0)
    zoom = _uniform((batch,), cfg.min_zoom, cfg.max_zoom, generator, device)
    trans = _uniform((batch, 2), -cfg.max_translate, cfg.max_translate, generator, device)
    return theta, zoom, trans


def _affine_matrix(theta: torch.Tensor, zoom: torch.Tensor) -> torch.Tensor:
    """Inverse-map linear part (output coord → input coord), row-major (y, x):
    rotate by -theta and scale by 1/zoom (pull-back)."""
    c, s = torch.cos(theta), torch.sin(theta)
    mat = torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], -2)
    return mat / zoom[:, None, None]


def apply_affine(img: torch.Tensor, theta, zoom, trans) -> torch.Tensor:
    """Warp ``[B, H, W, C]`` by the affine (about the image centre)."""
    _, h, w, _ = img.shape
    mat = _affine_matrix(theta, zoom)  # [B, 2, 2]
    yy = torch.arange(h, dtype=torch.float32, device=img.device) - (h - 1) / 2
    xx = torch.arange(w, dtype=torch.float32, device=img.device) - (w - 1) / 2
    grid = torch.stack(torch.meshgrid(yy, xx, indexing="ij"), dim=-1)  # [H, W, 2]
    # a [B,2,2] x [H,W,2] contraction over 2 terms, written out
    src = (mat[:, None, None, :, :] * grid[None, :, :, None, :]).sum(dim=-1)
    center = torch.tensor([(h - 1) / 2, (w - 1) / 2], dtype=torch.float32, device=img.device)
    shift = trans * torch.tensor([h, w], dtype=torch.float32, device=img.device)
    coords = src + center + shift[:, None, None, :]
    return multilinear_sample(img, coords, padding="border")


def transform_flow(flow: torch.Tensor, theta, zoom, trans) -> torch.Tensor:
    """Pull the flow field through the affine and rotate / scale the vectors.

    For T(p) = A p + t (input coords from output coords) the equivariant flow
    is flow'(p_out) = A^{-1} flow(T(p_out)); with A = R(-θ) / z the inverse is
    z · R(θ).
    """
    warped = apply_affine(flow, theta, zoom, trans)
    c, s = torch.cos(theta), torch.sin(theta)
    inv = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    inv = inv * zoom[:, None, None]
    return (inv[:, None, None, :, :] * warped[..., None, :]).sum(dim=-1)


def sp_transform_pair(generator: torch.Generator, im1: torch.Tensor, im2: torch.Tensor,
                      cfg: SPTransformConfig):
    """Transform both frames consistently; returns (im1', im2', params)."""
    theta, zoom, trans = random_affine_params(generator, im1.shape[0], cfg, im1.device)
    t1 = apply_affine(im1, theta, zoom, trans)
    t2 = apply_affine(im2, theta, zoom, trans)
    if cfg.add_noise and cfg.noise_std > 0:
        def noise(t):
            n = torch.randn(t.shape, generator=generator, device=generator.device)
            return t + cfg.noise_std * n.to(t.device, t.dtype)

        t1, t2 = noise(t1), noise(t2)
    return t1, t2, (theta, zoom, trans)


def eq_loss(student_flow: torch.Tensor, teacher_flow: torch.Tensor, params,
            occ_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Equivariance distillation: |flow(T(pair)) - T(detached teacher flow)|."""
    theta, zoom, trans = params
    target = transform_flow(teacher_flow.detach(), theta, zoom, trans)
    mask = apply_affine(occ_mask, theta, zoom, trans) if occ_mask is not None else None
    return photo_loss_multi_type(
        student_flow, target,
        mask if mask is not None else torch.ones_like(student_flow[..., :1]),
        "abs_robust", use_occ=mask is not None,
    )


def oi_loss(im1_t: torch.Tensor, im2_t: torch.Tensor, flow_fw_t: torch.Tensor,
            flow_bw_t: torch.Tensor) -> torch.Tensor:
    """Occlusion-masked photometric loss on the transformed pair."""
    occ_fw, _ = occ_check(flow_fw_t, flow_bw_t)
    warped = backward_warp(im2_t, flow_fw_t, padding="border")
    return photo_loss_multi_type(im1_t, warped, occ_fw, "abs_robust", use_occ=True)
