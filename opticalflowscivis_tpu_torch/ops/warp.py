"""Backward warping (grid-sample) — plain PyTorch bilinear / trilinear gather.

Counterpart of ``opticalflowscivis_tpu/ops/warp.py`` and, through
``warp2d_plain`` and ``warp3d_plain``, the plain versions of the Hopper warp
kernels (``ops/kernels/warp.py``).  These functions are the CPU path and the
oracle the kernels are held against on the card.

Semantics are the reference's: multilinear sampling at (identity + flow) in
pixel space, the same as ``grid_sample(align_corners=True)``.  ``'border'``
clamps each corner index to the image, ``'zeros'`` drops out-of-range corners.
The bounded variants first clip the flow to ``±r`` (``r = 0``: no bound),
which is what the TPU kernel computes (``ops/pallas/warp.py:184`` clips, and
its edge-padded window equals the per-corner clamp).  Under autograd they are
the plain backward of the kernels: ``|flow| >= r`` carries no flow gradient.

``warp3d_plain`` is the *function* of the reference's slab decomposition
(``ops/warp.py::backward_warp3d_slab``): ``flow_z`` clipped to ``±r_z``, the
in-plane components to ``±r_yx`` (what the TPU path computes, where each
z-tap runs the bounded 2-D kernel; the reference's CPU path leaves the
in-plane flow unbounded), then one 8-corner gather.  In ``'zeros'`` mode
dropping out-of-range corners on all three axes equals the slab's
``in-plane zeros x clip(sum of in-range z weights)``.

On CUDA tensors the public 2-D ``backward_warp`` goes through the ``warp2d``
kernel with ``r = 0`` (UPFlow's warps are unbounded); its validity mask is then
a second launch on an image of ones under ``'zeros'`` padding, the same
function as the sum of in-range weights, and carries no gradient (every caller
only compares it with a threshold).  ``boundary_dilated_warp`` samples an image
larger than the flow's grid, which is not ``warp2d``'s shape: it is a plain
gather on any device.

Flow convention: ``flow[..., i]`` displaces along spatial axis ``i``
(row-major): (dy, dx) in 2-D, (dz, dy, dx) in 3-D.  The public functions take
channels-last ``[B, *S, C]`` images; ``sample_channels_first`` /
``warp2d_plain`` / ``warp3d_plain`` take the channels-first tensors the model carries.
"""

from __future__ import annotations

import itertools

import torch

_PADDINGS = ("border", "zeros")


def _check_padding(padding: str) -> None:
    if padding not in _PADDINGS:
        raise ValueError(f"padding must be 'border' or 'zeros', got {padding!r}")


def sample_channels_first(
    img: torch.Tensor,
    coords: tuple[torch.Tensor, ...],
    padding: str = "border",
    return_mask: bool = False,
    origin: tuple[int, ...] | None = None,
):
    """Sample ``img [B, C, *S]`` at absolute coords, one ``[B, *So]`` per axis.

    ``2^ndim`` corner gathers with multilinear weights, accumulated in float32
    (or the image's wider type) and returned in the image's dtype.  The
    optional mask ``[B, 1, *So]`` is the fraction of interpolation weight that
    fell inside the image.  ``origin``: the coords are in the frame of a larger
    array whose index ``origin`` is ``img``'s index 0 (per axis); floors and
    fractions are taken there, indices here.
    """
    _check_padding(padding)
    b, c = img.shape[:2]
    spatial = tuple(img.shape[2:])
    if len(coords) != len(spatial):
        raise ValueError(f"{len(coords)} coordinates for a {len(spatial)}-D image")
    compute = torch.promote_types(img.dtype, torch.float32)
    out_spatial = tuple(coords[0].shape[1:])
    flat = img.reshape(b, c, -1).to(compute)

    # per axis and side (low, high): weight, validity, clamped index * stride
    sides = []
    stride = 1
    origin = origin or (0,) * len(spatial)
    for size, s, at in zip(reversed(spatial), reversed(coords), reversed(origin)):
        s = s.to(compute)
        lo = torch.floor(s)
        frac = s - lo
        lo = lo.long() - at
        axis_sides = []
        for hi, w in ((0, 1.0 - frac), (1, frac)):
            idx = lo + hi
            valid = (idx >= 0) & (idx <= size - 1)
            axis_sides.append((w, valid, idx.clamp(0, size - 1) * stride))
        sides.append(axis_sides)
        stride *= size
    sides.reverse()

    out = torch.zeros((b, c) + out_spatial, dtype=compute, device=img.device)
    mask = torch.zeros((b,) + out_spatial, dtype=compute, device=img.device)
    # corner order (0,..,0), (0,..,1), ... and weight = ((1 * w0) * w1) * ..., as
    # the reference's multilinear_sample accumulates
    for corner in itertools.product((0, 1), repeat=len(spatial)):
        weight, valid, idx = sides[0][corner[0]]
        for axis_sides, hi in zip(sides[1:], corner[1:]):
            w, v, i = axis_sides[hi]
            weight, valid, idx = weight * w, valid & v, idx + i
        inside = torch.where(valid, weight, torch.zeros_like(weight))
        if padding == "zeros":
            weight = inside
        flat_idx = idx.reshape(b, 1, -1).expand(b, c, -1)
        gathered = torch.gather(flat, 2, flat_idx).reshape(out.shape)
        out = out + gathered * weight[:, None]
        mask = mask + inside

    out = out.to(img.dtype)
    if return_mask:
        return out, mask[:, None].to(img.dtype)
    return out


def _base_grid(spatial, dtype: torch.dtype, device) -> list[torch.Tensor]:
    """One broadcastable index tensor ``[1, .., S_i, .., 1]`` per spatial axis."""
    nd = len(spatial)
    grids = []
    for i, size in enumerate(spatial):
        shape = [1] * (nd + 1)
        shape[i + 1] = size
        grids.append(torch.arange(size, dtype=dtype, device=device).view(shape))
    return grids


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
    ys, xs = _base_grid((h, w), compute, img.device)
    return sample_channels_first(img, (ys + fl[:, 0], xs + fl[:, 1]), padding)


def warp3d_plain(
    img: torch.Tensor, flow: torch.Tensor, r_z: int = 0, r_yx: int = 0,
    padding: str = "border", z_offset: int = 0,
) -> torch.Tensor:
    """Channels-first bounded trilinear warp: ``img [B, C, Z, Y, X]`` by
    ``flow [B, 3, Z, Y, X]`` (dz, dy, dx).

    The plain version of the Hopper kernel: ``flow_z`` is clipped to ``±r_z``
    and ``flow_y``, ``flow_x`` to ``±r_yx`` first (each radius 0: no bound).
    ``flow`` may be any strided view (the model passes channel slices of its
    6-channel flow).  ``z_offset``: ``img`` is a slab whose slice 0 is slice
    ``z_offset`` of a larger volume; z coordinates are formed in the volume's
    frame (``kernels.warp.warp3d``).
    """
    if img.dim() != 5 or flow.dim() != 5 or flow.shape[1] != 3:
        raise ValueError(
            f"expected img [B,C,Z,Y,X] and flow [B,3,Z,Y,X], got {tuple(img.shape)} "
            f"and {tuple(flow.shape)}"
        )
    if (flow.shape[0],) + tuple(flow.shape[2:]) != (img.shape[0],) + tuple(img.shape[2:]):
        raise ValueError(f"flow {tuple(flow.shape)} does not match img {tuple(img.shape)}")
    compute = torch.promote_types(img.dtype, torch.float32)
    fz = _clip(flow[:, 0], r_z).to(compute)
    fyx = _clip(flow[:, 1:3], r_yx).to(compute)
    zs, ys, xs = _base_grid(tuple(img.shape[2:]), compute, img.device)
    return sample_channels_first(img, ((zs + z_offset) + fz, ys + fyx[:, 0], xs + fyx[:, 1]),
                                 padding, origin=(z_offset, 0, 0))


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def _check_rank(img: torch.Tensor, field: torch.Tensor, what: str) -> int:
    ndim = img.dim() - 2
    if ndim not in (2, 3):
        raise ValueError(f"expected a channels-last 2-D or 3-D image, got {tuple(img.shape)}")
    if field.dim() != img.dim() or field.shape[-1] != ndim:
        raise ValueError(f"{what} {tuple(field.shape)} does not fit a {ndim}-D image")
    return ndim


def multilinear_sample(
    img: torch.Tensor,
    coords: torch.Tensor,
    padding: str = "border",
    return_mask: bool = False,
):
    """Sample channels-last ``img [B, *S, C]`` at ``coords [B, *So, ndim]``.

    ``coords[..., i]`` is the absolute position along spatial axis ``i``.
    Returns ``[B, *So, C]`` (and the ``[B, *So, 1]`` mask).
    """
    ndim = _check_rank(img, coords, "coords")
    res = sample_channels_first(
        _channels_first(img), tuple(coords[..., i] for i in range(ndim)), padding, return_mask
    )
    if return_mask:
        out, mask = res
        return out.movedim(1, -1), mask.movedim(1, -1)
    return res.movedim(1, -1)


def backward_warp(
    img: torch.Tensor,
    flow: torch.Tensor,
    padding: str = "border",
    return_mask: bool = False,
):
    """Sample channels-last ``img [B, *S, C]`` at (identity + ``flow``).

    ``flow [B, *S, ndim]`` holds pixel displacements, (dy, dx) or
    (dz, dy, dx).  Unbounded: the counterpart of the reference's
    ``ops.warp.backward_warp``.
    """
    ndim = _check_rank(img, flow, "flow")
    if ndim == 2 and img.device.type == "cuda":
        return _backward_warp_kernel(img, flow, padding, return_mask)
    compute = torch.promote_types(img.dtype, torch.float32)
    base = _base_grid(tuple(img.shape[1:-1]), compute, img.device)
    fl = flow.to(compute)
    coords = torch.stack([g + fl[..., i] for i, g in enumerate(base)], dim=-1)
    return multilinear_sample(img, coords, padding, return_mask)


def _backward_warp_kernel(img: torch.Tensor, flow: torch.Tensor, padding: str,
                          return_mask: bool):
    """The 2-D ``backward_warp`` through ``ops.kernels.warp.warp2d(r=0)``:
    channels-last in and out.  The kernel reads a contiguous channels-first
    image, so a truly channels-last image (a batch's frames, 1-3 channels) is
    copied once; a channels-last view of a channels-first tensor is not."""
    from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d, warp2d_with_mask

    im, fl = img.movedim(-1, 1).contiguous(), flow.movedim(-1, 1)
    if not return_mask:
        return warp2d(im, fl, 0, padding).movedim(1, -1)
    warped, mask = warp2d_with_mask(im, fl, padding)
    return warped.movedim(1, -1), mask.movedim(1, -1)


def boundary_dilated_warp(img_raw: torch.Tensor, flow: torch.Tensor,
                          start: torch.Tensor) -> torch.Tensor:
    """Warp the *uncropped* channels-last image for a crop-sized flow field.

    The training crop sits at offset ``start [B, ndim]`` inside ``img_raw``;
    sampling at (crop grid + start + flow) lets flow vectors that point
    outside the crop (but inside the raw image) hit real pixels instead of
    padding.  Returns a crop-shaped warped image ``[B, *S_crop, C]``.
    """
    ndim = _check_rank(img_raw, flow, "flow")
    if start.shape != (flow.shape[0], ndim):
        raise ValueError(f"start {tuple(start.shape)} is not [B, {ndim}]")
    compute = torch.promote_types(img_raw.dtype, torch.float32)
    base = _base_grid(tuple(flow.shape[1:-1]), compute, flow.device)
    fl = flow.to(compute)
    offset = start.to(compute).view((-1,) + (1,) * ndim + (ndim,))
    coords = tuple(g + offset[..., i] + fl[..., i] for i, g in enumerate(base))
    return sample_channels_first(_channels_first(img_raw), coords, "border").movedim(1, -1)


def backward_warp_bounded(
    img: torch.Tensor, flow: torch.Tensor, r: int = 16, padding: str = "border"
) -> torch.Tensor:
    """Channels-last warp with every flow component clipped to ``±r`` first
    (0 = unbounded).

    In 2-D the plain counterpart of ``ops/pallas/warp.py::backward_warp_pallas``
    (forward): exact for ``|flow| <= r``, clamped beyond.
    """
    return backward_warp(img, _clip(flow, r), padding)
