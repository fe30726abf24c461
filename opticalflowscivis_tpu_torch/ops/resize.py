"""Spatial resizing with flow-magnitude rescaling — plain PyTorch, 2-D and 3-D.

Counterpart of ``opticalflowscivis_tpu/ops/resize.py``.  The half-pixel
(``align_corners=False``) linear resize without antialiasing is what the
reference's ``jax.image.resize(method='linear', antialias=False)`` computes
and what ``F.interpolate(mode='bilinear' / 'trilinear', align_corners=False)``
computes.
Flow fields are pixel displacements, so ``resize_flow`` also scales each flow
channel by the size ratio of its own axis.

``align_corners=True`` is the endpoint-aligned resize of the UPFlow path
(out coord ``i`` samples in coord ``i * (src - 1) / (dst - 1)``), which is
``F.interpolate(align_corners=True)`` wherever source and target have more
than one sample per axis.  Along an axis of size 1 the reference
(``jax.image.scale_and_translate``) differs from PyTorch, and the port follows
the reference: a source of size 1 gives its value at index 0 and zero beyond
(PyTorch repeats it), a target of size 1 gives zero (PyTorch takes index 0).
UPFlow meets the first at 64 x 64 inputs, where its coarsest plane is 1 x 1.
``method="nearest"`` picks ``floor((i + 0.5) * src / dst)``
(``F.interpolate(mode="nearest-exact")``), as ``jax.image.resize`` does.

The public functions take channels-last ``[B, *S, C]``; the ``*_nchw`` forms
take the channels-first tensors the models carry (``[B, C, H, W]`` or
``[B, C, Z, Y, X]``).

Depth-sharded (``shard``, a ``parallel.spatial.DepthShard``; half-pixel
linear only): ``x`` and ``spatial`` are this rank's slices of the sharded
axis.  Shrinking it by an integer factor f reads only inside a shard that
starts on a multiple of f (output o reads around f·o + (f - 1) / 2), so it
runs on the shard as it is; growing it by f reads one slice past each end,
which an ``edge`` halo supplies (the plain resize clamps there), and the
haloed result is cut back to the shard; the volume's first shard keeps no
halo before it, where the plain resize samples slice 0 alone.  The flow's values scale by the
ratio of the whole sizes, which equal shards give too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


_MODES = {2: "bilinear", 3: "trilinear"}


def _check_rank(x: torch.Tensor, spatial) -> int:
    ndim = x.dim() - 2
    if ndim not in _MODES or len(spatial) != ndim:
        raise ValueError(
            f"cannot resize {tuple(x.shape)} to spatial size {tuple(spatial)}: "
            "expected a 2-D or 3-D field and one size per spatial axis"
        )
    return ndim


def _resize_align_corners(x: torch.Tensor, spatial: tuple[int, ...], ndim: int) -> torch.Tensor:
    src = tuple(x.shape[2:])
    # an axis that keeps its size 1 is an identity for both frameworks; one
    # that grows from 1 or shrinks to 1 follows the reference (module docstring)
    grow = [s == 1 and d > 1 for s, d in zip(src, spatial)]
    shrink = [s > 1 and d == 1 for s, d in zip(src, spatial)]
    out = F.interpolate(x, size=tuple(spatial), mode=_MODES[ndim], align_corners=True)
    if any(shrink):
        return torch.zeros_like(out)
    for axis, g in enumerate(grow):
        if g:
            keep = torch.zeros(spatial[axis], dtype=out.dtype, device=out.device)
            keep[0] = 1
            shape = [1] * out.dim()
            shape[2 + axis] = -1
            out = out * keep.view(shape)
    return out


def _resize_sharded(x: torch.Tensor, spatial: tuple[int, ...], ndim: int, shard) -> torch.Tensor:
    d = shard.dim
    n, m = x.shape[d], spatial[d - 2]
    if n == m or n % m == 0:  # kept or shrunk: inside the shard
        return F.interpolate(x, size=spatial, mode=_MODES[ndim], align_corners=False)
    if m % n:
        raise ValueError(f"a depth-sharded resize takes integer factors, got {n} -> {m}")
    f = m // n
    haloed = shard.halo(x, 1, "edge")
    start = f
    if shard.index == 0:
        # the plain resize clamps a coordinate below 0 to slice 0 itself,
        # where the edge halo would blend slice 0 with its copy: start the
        # volume's first shard unhaloed, to run the plain arithmetic
        haloed, start = haloed.narrow(d, 1, n + 1), 0
    size = list(spatial)
    size[d - 2] = haloed.shape[d] * f
    out = F.interpolate(haloed, size=tuple(size), mode=_MODES[ndim], align_corners=False)
    return out.narrow(d, start, m)


def resize_nchw(x: torch.Tensor, spatial: tuple[int, ...], method: str = "linear",
                align_corners: bool = False, shard=None) -> torch.Tensor:
    """Resize ``[B, C, *S]`` to ``[B, C, *spatial]``: linear (half-pixel, or
    endpoint-aligned with ``align_corners``) or ``"nearest"``; on a depth
    shard with ``shard`` (module docstring)."""
    ndim = _check_rank(x, spatial)
    if method not in ("linear", "nearest"):
        raise ValueError(f"method must be 'linear' or 'nearest', got {method!r}")
    if tuple(x.shape[2:]) == tuple(spatial):
        return x
    if shard is not None:
        if method != "linear" or align_corners:
            raise ValueError("a depth-sharded resize is linear and half-pixel")
        return _resize_sharded(x, tuple(spatial), ndim, shard)
    if align_corners:
        if method != "linear":
            raise ValueError("align_corners=True is a linear resize")
        return _resize_align_corners(x, tuple(spatial), ndim)
    if method == "nearest":
        return F.interpolate(x, size=tuple(spatial), mode="nearest-exact")
    return F.interpolate(x, size=tuple(spatial), mode=_MODES[ndim], align_corners=False)


def resize_flow_nchw(flow: torch.Tensor, spatial: tuple[int, ...], method: str = "linear",
                     align_corners: bool = False, shard=None) -> torch.Tensor:
    """Resize ``[B, k * ndim, *S]`` displacement groups and rescale the values
    of each channel by the size ratio of its own axis (of the whole sizes on a
    depth shard)."""
    ndim = flow.dim() - 2
    if flow.shape[1] % ndim:
        raise ValueError(f"flow channels {flow.shape[1]} not a multiple of ndim {ndim}")
    src = flow.shape[2:]
    out = resize_nchw(flow, spatial, method, align_corners, shard)
    ratios = torch.tensor(
        [t / s for t, s in zip(spatial, src)], dtype=out.dtype, device=out.device
    )
    return out * ratios.repeat(flow.shape[1] // ndim).view((1, -1) + (1,) * ndim)


def upsample_flow_as_nchw(flow: torch.Tensor, ref: torch.Tensor,
                          method: str = "linear") -> torch.Tensor:
    """Channels-first ``upsample_flow_as``: match ``ref``'s spatial shape with
    ``align_corners=True`` and rescale the values."""
    return resize_flow_nchw(flow, tuple(ref.shape[2:]), method, align_corners=True)


def resize_spatial(
    x: torch.Tensor, spatial: tuple[int, ...], method: str = "linear",
    align_corners: bool = False,
) -> torch.Tensor:
    """Resize channels-last ``[B, *S, C]`` to ``[B, *spatial, C]``.

    ``align_corners=False`` is half-pixel (the RIFE path); ``align_corners=True``
    is endpoint-aligned (the UPFlow path).
    """
    return resize_nchw(x.movedim(-1, 1), spatial, method, align_corners).movedim(1, -1)


def resize_like(x: torch.Tensor, ref: torch.Tensor, method: str = "linear",
                align_corners: bool = False) -> torch.Tensor:
    return resize_spatial(x, tuple(ref.shape[1:-1]), method, align_corners)


def resize_flow(
    flow: torch.Tensor, spatial: tuple[int, ...], method: str = "linear",
    align_corners: bool = False,
) -> torch.Tensor:
    """Resize a channels-last displacement field and rescale it per axis."""
    return resize_flow_nchw(flow.movedim(-1, 1), spatial, method, align_corners).movedim(1, -1)


def upsample_flow_as(flow: torch.Tensor, ref: torch.Tensor, method: str = "linear") -> torch.Tensor:
    """UPFlow's ``upsample2d_flow_as(if_rate=True)``: match channels-last
    ``ref``'s spatial shape with ``align_corners=True`` and rescale the values."""
    return resize_flow(flow, tuple(ref.shape[1:-1]), method, align_corners=True)
