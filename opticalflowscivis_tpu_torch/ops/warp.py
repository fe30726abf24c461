"""Backward warping (grid-sample) — plain PyTorch 2-D bilinear gather.

Counterpart of ``opticalflowscivis_tpu/ops/warp.py`` (2-D part) and, through
``warp2d_plain``, the plain version of the Hopper warp kernel
(``ops/kernels/warp.py``).  These functions are the CPU path and the oracle
the kernel is held against on the card.

Semantics are the reference's: bilinear sampling at (identity + flow) in pixel
space, the same as ``grid_sample(align_corners=True)``.  ``'border'`` clamps
each corner index to the image, ``'zeros'`` drops out-of-range corners.  The
bounded variants first clip the flow to ``±r`` (``r = 0``: no bound), which
is what the TPU kernel computes (``ops/pallas/warp.py:184`` clips, and its
edge-padded window equals the per-corner clamp).  Under autograd they are
the plain backward of the kernel: ``|flow| >= r`` carries no flow gradient.

Flow convention: ``flow[..., 0] = dy``, ``flow[..., 1] = dx`` (row-major).
The public functions take channels-last ``[B, H, W, C]`` images; the
``*_nchw`` / ``warp2d_plain`` forms take the NCHW tensors the model carries.
"""

from __future__ import annotations

import torch

_PADDINGS = ("border", "zeros")


def _check_padding(padding: str) -> None:
    if padding not in _PADDINGS:
        raise ValueError(f"padding must be 'border' or 'zeros', got {padding!r}")


def sample_nchw(
    img: torch.Tensor,
    sy: torch.Tensor,
    sx: torch.Tensor,
    padding: str = "border",
    return_mask: bool = False,
):
    """Sample ``img [B, C, H, W]`` at absolute coords ``sy, sx [B, Ho, Wo]``.

    Four corner gathers with bilinear weights, accumulated in float32 (or the
    image's wider type) and returned in the image's dtype.  The optional mask
    ``[B, 1, Ho, Wo]`` is the fraction of interpolation weight that fell
    inside the image.
    """
    _check_padding(padding)
    b, c, h, w = img.shape
    compute = torch.promote_types(img.dtype, torch.float32)
    sy = sy.to(compute)
    sx = sx.to(compute)
    y0f = torch.floor(sy)
    x0f = torch.floor(sx)
    ay = sy - y0f
    ax = sx - x0f
    y0 = y0f.long()
    x0 = x0f.long()
    out_spatial = sy.shape[1:]
    flat = img.reshape(b, c, h * w).to(compute)

    out = torch.zeros((b, c) + tuple(out_spatial), dtype=compute, device=img.device)
    mask = torch.zeros((b,) + tuple(out_spatial), dtype=compute, device=img.device)
    # corner order (0,0), (0,1), (1,0), (1,1) and weight = (1 * wy) * wx, as
    # the reference's multilinear_sample accumulates
    for hy in (0, 1):
        iy = y0 + hy
        wy = ay if hy else 1.0 - ay
        vy = (iy >= 0) & (iy <= h - 1)
        iy = iy.clamp(0, h - 1)
        for hx in (0, 1):
            ix = x0 + hx
            wx = ax if hx else 1.0 - ax
            valid = vy & (ix >= 0) & (ix <= w - 1)
            ix = ix.clamp(0, w - 1)
            weight = wy * wx
            if padding == "zeros":
                weight = torch.where(valid, weight, torch.zeros_like(weight))
            idx = (iy * w + ix).reshape(b, 1, -1).expand(b, c, -1)
            gathered = torch.gather(flat, 2, idx).reshape(out.shape)
            out = out + gathered * weight[:, None]
            mask = mask + torch.where(valid, weight, torch.zeros_like(weight))

    out = out.to(img.dtype)
    if return_mask:
        return out, mask[:, None].to(img.dtype)
    return out


def _base_grid(h: int, w: int, dtype: torch.dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    ys = torch.arange(h, dtype=dtype, device=device).view(1, h, 1)
    xs = torch.arange(w, dtype=dtype, device=device).view(1, 1, w)
    return ys, xs


def _clip(flow: torch.Tensor, r: int) -> torch.Tensor:
    """Clip to ``±r`` (0 = unbounded).  The gradient passes only where
    ``|flow| < r``: a flow exactly on the bound counts as clamped, as in the
    TPU kernel (``ops/pallas/warp.py:323``) and the Hopper kernel, whereas
    ``torch.clamp`` would pass it there."""
    if r < 0:
        raise ValueError(f"r must be >= 0 (0 = unbounded), got {r}")
    flow = flow.to(torch.promote_types(flow.dtype, torch.float32))
    if r == 0:
        return flow
    return torch.where(flow.abs() < r, flow, torch.sign(flow.detach()) * r)


def warp2d_plain(
    img: torch.Tensor, flow: torch.Tensor, r: int = 0, padding: str = "border"
) -> torch.Tensor:
    """NCHW bounded warp: ``img [B, C, H, W]`` by ``flow [B, 2, H, W]`` (dy, dx).

    The plain version of the Hopper kernel: the flow is clipped to ``±r``
    first when ``r > 0``.  ``flow`` may be any strided view (the model passes
    channel slices of its 4-channel flow).
    """
    if img.dim() != 4 or flow.dim() != 4 or flow.shape[1] != 2:
        raise ValueError(
            f"expected img [B,C,H,W] and flow [B,2,H,W], got {tuple(img.shape)} "
            f"and {tuple(flow.shape)}"
        )
    b, _, h, w = img.shape
    if (flow.shape[0], flow.shape[2], flow.shape[3]) != (b, h, w):
        raise ValueError(f"flow {tuple(flow.shape)} does not match img {tuple(img.shape)}")
    compute = torch.promote_types(img.dtype, torch.float32)
    fl = _clip(flow, r).to(compute)
    ys, xs = _base_grid(h, w, compute, img.device)
    return sample_nchw(img, ys + fl[:, 0], xs + fl[:, 1], padding)


def multilinear_sample(
    img: torch.Tensor,
    coords: torch.Tensor,
    padding: str = "border",
    return_mask: bool = False,
):
    """Sample channels-last ``img [B, H, W, C]`` at ``coords [B, Ho, Wo, 2]``.

    ``coords[..., 0]`` is the absolute row, ``coords[..., 1]`` the column.
    Returns ``[B, Ho, Wo, C]`` (and the ``[B, Ho, Wo, 1]`` mask).
    """
    if img.dim() != 4 or coords.shape[-1] != 2:
        raise NotImplementedError(
            "only 2-D sampling is ported; the trilinear warp comes with the "
            "RIFE-3D slice (ROADMAP A.8)"
        )
    res = sample_nchw(
        img.permute(0, 3, 1, 2), coords[..., 0], coords[..., 1], padding, return_mask
    )
    if return_mask:
        out, mask = res
        return out.permute(0, 2, 3, 1), mask.permute(0, 2, 3, 1)
    return res.permute(0, 2, 3, 1)


def backward_warp(
    img: torch.Tensor,
    flow: torch.Tensor,
    padding: str = "border",
    return_mask: bool = False,
):
    """Sample channels-last ``img [B, H, W, C]`` at (identity + ``flow``).

    ``flow [B, H, W, 2]`` holds pixel displacements (dy, dx).  Unbounded:
    the counterpart of the reference's ``ops.warp.backward_warp``.
    """
    if img.dim() != 4 or flow.shape[-1] != 2:
        raise NotImplementedError(
            "only 2-D warps are ported; the trilinear warp comes with the "
            "RIFE-3D slice (ROADMAP A.8)"
        )
    compute = torch.promote_types(img.dtype, torch.float32)
    ys, xs = _base_grid(img.shape[1], img.shape[2], compute, img.device)
    fl = flow.to(compute)
    coords = torch.stack([ys + fl[..., 0], xs + fl[..., 1]], dim=-1)
    return multilinear_sample(img, coords, padding, return_mask)


def backward_warp_bounded(
    img: torch.Tensor, flow: torch.Tensor, r: int = 16, padding: str = "border"
) -> torch.Tensor:
    """Channels-last warp with the flow clipped to ``±r`` first (0 = unbounded).

    The plain counterpart of ``ops/pallas/warp.py::backward_warp_pallas``
    (forward): exact for ``|flow| <= r``, clamped beyond.
    """
    return backward_warp(img, _clip(flow, r), padding)
