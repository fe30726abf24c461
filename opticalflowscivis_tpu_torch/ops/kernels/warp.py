"""Bilinear and trilinear backward warps: wrappers of the Hopper kernels in
``csrc/warp2d.cu`` and ``csrc/warp3d.cu``.

``warp2d`` is the counterpart of
``opticalflowscivis_tpu/ops/pallas/warp.py::backward_warp_pallas``, forward and
VJP; ``warp3d`` of the slab warp built on it,
``opticalflowscivis_tpu/ops/warp.py::backward_warp3d_slab`` (a scan of the 2-D
kernel over z-taps on the TPU, one 8-corner gather here).  Both dispatch by
the tensors' device:

- CUDA tensors launch the forward kernel (image and flow both f32 or both
  bf16; ``warp2d`` also takes a bf16 image with an f32 flow, as UPFlow warps
  its features), or raise on anything the kernel does not take; a gradient
  through it launches the backward kernel.  There is no fallback to the plain
  version;
- CPU tensors go to the plain version, ``ops.warp.warp2d_plain`` /
  ``warp3d_plain``, whose backward is PyTorch's autograd.

The flow is clipped to ``±r`` (``r = 0``: unbounded; in 3-D ``r_z`` for the z
component and ``r_yx`` for the in-plane ones), and a flow component with
``|flow| >= r`` carries no gradient: the clip's adjoint is zero at the
boundary too, as in the TPU kernel (``ops/pallas/warp.py:323``).

The forward kernels and the 3-D backward run on a grid of (x tiles, row
tiles, planes) that ``launch_geometry`` computes from the image's shape alone,
each thread on 4 (2-D) or 2 (3-D) consecutive x of one row; the 2-D backward
on the same grid with, where the pixels alone leave the card empty, channel
groups along the block's third dimension (``backward_geometry``).  Offsets
inside one plane (2-D) or volume (3-D) are 32-bit, so a plane of 2^31
elements or more, or a volume of 2^31 voxels or more, is refused with a
``ValueError`` before anything is allocated.
``warp2d_with_mask`` gets UPFlow's validity mask from the same launch as the
warp.

The backward kernels write ``dflow`` once per pixel, so two runs agree bit
for bit, and accumulate ``dimg`` with float32 atomics into a float32 buffer
that is zero-filled here and cast to the image's dtype afterwards (in 2-D
padded by 4 floats, which the kernel's vector atomics may touch with zeros);
atomics sum in an order that changes from run to run, so ``dimg`` is
reproducible only to float32 rounding.  When the image
needs no gradient (the model's warps sample the input frames) the buffer and
the atomics are skipped.  The flow and the incoming gradient are read through
their strides, in whatever layout the caller or autograd hands them over,
without a copy.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence

import torch
from torch.autograd.function import once_differentiable

from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES, OFFSET_LAUNCHES
from opticalflowscivis_tpu_torch.ops.kernels.build import load
from opticalflowscivis_tpu_torch.ops.warp import warp2d_plain, warp3d_plain

_DTYPES = (torch.float32, torch.bfloat16)

_MAX_INDEX = 2**31  # 32-bit offsets inside one plane or volume, 32-bit plane counts
_MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z
_THREADS = 256  # per block: __launch_bounds__ of the warp kernels
# consecutive x of one row per thread: kV of csrc/warp2d.cu and csrc/warp3d.cu
_PER_THREAD = {4: 4, 5: 2}


class Launch(NamedTuple):
    """Grid ``(gx, gy, gz)`` and block ``(tx, ty)`` of one warp launch,
    each thread on ``per_thread`` consecutive x of one row.

    ``strided``: the rows or the planes exceed the grid, and the kernel's
    grid-stride loops cover the rest.  ``groups``: the 2-D backward's channel
    groups, the block's third dimension (1 everywhere else)."""

    grid: tuple[int, int, int]
    block: tuple[int, int]
    per_thread: int
    strided: bool
    groups: int = 1


def _check_extent(shape: Sequence[int]) -> None:
    """Refuse an image whose plane (2-D) or volume (3-D) the kernels' 32-bit
    offsets cannot address."""
    elements = math.prod(shape[2:])
    if elements >= _MAX_INDEX:
        what = "plane" if len(shape) == 4 else "volume"
        raise ValueError(
            f"warp kernels address one {what} with 32-bit offsets: {tuple(shape)} has "
            f"{elements} elements in one, the limit is {_MAX_INDEX - 1}"
        )


def launch_geometry(shape: Sequence[int]) -> Launch:
    """The forward warp's launch over an image ``[B, C, H, W]`` (rows H,
    planes B) or ``[B, C, Z, Y, X]`` (rows Y, planes B * Z), from its shape
    alone; the 3-D backward launches on the same grid.

    A thread takes 4 consecutive x of a 2-D image, whatever its channels,
    and 2 of a volume.  A block holds ``tx`` threads along a row, enough to
    cover it (at most 256), and as many rows ``ty`` as fit in 256 threads (at
    most the plane's); rows and planes beyond the grid's 65535 limit are left
    to the kernel's grid-stride loops.  Raises ``ValueError`` for a plane or
    volume of 2^31 elements or more, or 2^31 planes or more.
    """
    if len(shape) not in (4, 5):
        raise ValueError(f"expected [B, C, H, W] or [B, C, Z, Y, X], got {tuple(shape)}")
    _check_extent(shape)
    width, rows = shape[-1], shape[-2]
    planes = shape[0] * math.prod(shape[2:-2])
    if planes >= _MAX_INDEX:
        raise ValueError(f"warp kernels count planes in 32 bits: {tuple(shape)} has {planes}")
    per_thread = _PER_THREAD[len(shape)]
    tx = min(_THREADS, -(-width // per_thread))
    ty = min(_THREADS // tx, rows)
    row_tiles = -(-rows // ty)
    gx = -(-width // (per_thread * tx))
    grid = (gx, min(row_tiles, _MAX_GRID_YZ), min(planes, _MAX_GRID_YZ))
    return Launch(grid, (tx, ty), per_thread, row_tiles > _MAX_GRID_YZ or planes > _MAX_GRID_YZ)


# The 2-D backward's channel groups: as many as bring the threads of a launch
# up to what the card holds at once (132 SMs x 2048), at least 4 channels a
# group, at most 256 threads a block; none at C <= 3
_RESIDENT_THREADS = 132 * 2048
_MIN_GROUP_CHANNELS = 4


def backward_geometry(shape: Sequence[int]) -> Launch:
    """The 2-D backward's launch over an image ``[B, C, H, W]``, from its
    shape alone: the forward's grid of (x tiles, row tiles, planes), each
    thread on 4 consecutive pixels of one row, and where the pixels alone
    leave the card empty (UPFlow's deep coarse levels: many channels over
    small planes) ``groups`` channel groups along the block's third
    dimension, each walking its share of the channels for the same pixels,
    with as many rows ``ty`` a block as fit in 256 threads.  Raises
    ``ValueError`` as ``launch_geometry`` does."""
    if len(shape) != 4:
        raise ValueError(f"expected [B, C, H, W], got {tuple(shape)}")
    forward = launch_geometry(shape)
    b, c, h, w = shape
    tx = forward.block[0]
    threads = b * h * forward.grid[0] * tx
    groups = 1
    while (2 * groups * _MIN_GROUP_CHANNELS <= c and 2 * groups * tx <= _THREADS
           and threads * groups < _RESIDENT_THREADS):
        groups *= 2
    if groups == 1:
        return forward
    ty = min(_THREADS // (tx * groups), h)
    row_tiles = -(-h // ty)
    grid = (forward.grid[0], min(row_tiles, _MAX_GRID_YZ), forward.grid[2])
    return Launch(grid, (tx, ty), forward.per_thread,
                  row_tiles > _MAX_GRID_YZ or b > _MAX_GRID_YZ, groups)


def _library() -> ctypes.CDLL:
    lib = load("warp2d")
    if lib.warp2d_forward.argtypes is None:
        lib.warp2d_forward.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 16 + [ctypes.c_void_p]
        )
        lib.warp2d_forward.restype = ctypes.c_int
        lib.warp2d_backward.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 21 + [ctypes.c_void_p]
        )
        lib.warp2d_backward.restype = ctypes.c_int
    return lib


def _type_code(img: torch.Tensor, flow: torch.Tensor) -> int:
    """The 2-D kernels' type flag: 0 all f32, 1 all bf16, 2 bf16 image with an
    f32 flow (and an f32 ``dflow``)."""
    if img.dtype == torch.float32:
        return 0
    return 1 if flow.dtype == torch.bfloat16 else 2


def _launch(img: torch.Tensor, flow: torch.Tensor, r: int, padding: str,
            with_mask: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One launch of the forward kernel: ``(out, mask or None)``."""
    geometry = launch_geometry(img.shape)
    b, c, h, w = img.shape
    out = torch.empty_like(img, memory_format=torch.contiguous_format)
    mask = torch.empty((b, 1, h, w), dtype=img.dtype, device=img.device) if with_mask else None
    fn = _library().warp2d_forward
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(
            img.data_ptr(), flow.data_ptr(), out.data_ptr(),
            mask.data_ptr() if with_mask else None,
            b, c, h, w, *flow.stride(),
            r, int(padding == "zeros"), _type_code(img, flow),
            *geometry.grid, *geometry.block, stream,
        )
    if err:
        raise RuntimeError(f"warp2d kernel launch failed with CUDA error {err}")
    LAUNCHES["warp2d"] += 1
    return out, mask


def _check_grad(img: torch.Tensor, grad_out: torch.Tensor, name: str) -> None:
    if grad_out.device != img.device or grad_out.dtype != img.dtype:
        raise TypeError(
            f"{name} backward got a gradient of {grad_out.dtype} on "
            f"{grad_out.device} for an image of {img.dtype} on {img.device}"
        )
    if grad_out.shape != img.shape:
        raise ValueError(
            f"{name} backward got a gradient {tuple(grad_out.shape)} for an "
            f"image {tuple(img.shape)}"
        )


def _launch_backward(
    img: torch.Tensor, flow: torch.Tensor, grad_out: torch.Tensor, r: int,
    padding: str, need_dimg: bool,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """One launch of the backward kernel, on ``backward_geometry``'s grid:
    ``(dimg or None, dflow)``."""
    _check_grad(img, grad_out, "warp2d")
    geometry = backward_geometry(img.shape)  # refuses 2^31 elements before allocating
    b, c, h, w = img.shape
    dflow = torch.empty((b, 2, h, w), dtype=flow.dtype, device=flow.device)
    acc = None
    if need_dimg:  # 4 floats beyond the image: the kernel's vector atomics may add 0 there
        acc = torch.zeros(img.numel() + 4, dtype=torch.float32, device=img.device)
        acc = acc[: img.numel()].view(img.shape)
    fn = _library().warp2d_backward
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(
            img.data_ptr(), flow.data_ptr(), grad_out.data_ptr(), dflow.data_ptr(),
            acc.data_ptr() if need_dimg else None,
            b, c, h, w, *flow.stride(), *grad_out.stride(),
            r, int(padding == "zeros"), _type_code(img, flow),
            *geometry.grid, *geometry.block, geometry.groups, stream,
        )
    if err:
        raise RuntimeError(f"warp2d backward kernel launch failed with CUDA error {err}")
    LAUNCHES["warp2d_bwd"] += 1
    return (acc.to(img.dtype) if need_dimg else None), dflow


class _Warp2dKernel(torch.autograd.Function):
    """``(out, mask or None)``; the mask carries no gradient."""

    @staticmethod
    def forward(ctx, img, flow, r, padding, with_mask):
        ctx.save_for_backward(img, flow)
        ctx.r, ctx.padding = r, padding
        out, mask = _launch(img, flow, r, padding, with_mask)
        if with_mask:
            ctx.mark_non_differentiable(mask)
        return out, mask

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out, _grad_mask):
        img, flow = ctx.saved_tensors
        need_dimg, need_dflow = ctx.needs_input_grad[:2]
        dimg, dflow = _launch_backward(img, flow, grad_out, ctx.r, ctx.padding, need_dimg)
        return dimg, (dflow if need_dflow else None), None, None, None


def _check_cuda_args(img: torch.Tensor, flow: torch.Tensor, name: str = "warp2d") -> None:
    if flow.device != img.device:
        raise ValueError(f"img on {img.device} but flow on {flow.device}")
    same = img.dtype in _DTYPES and flow.dtype == img.dtype
    mixed = name == "warp2d" and img.dtype == torch.bfloat16 and flow.dtype == torch.float32
    if not (same or mixed):
        raise TypeError(
            f"{name} kernel takes img and flow both float32 or both bfloat16"
            + (", or a bfloat16 img with a float32 flow" if name == "warp2d" else "")
            + f", got {img.dtype} and {flow.dtype}"
        )
    if not img.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous channels-first image")
    if img.numel() == 0:
        raise ValueError(f"{name} kernel got an empty image {tuple(img.shape)}")


def _check_args2d(img: torch.Tensor, flow: torch.Tensor, r: int, padding: str) -> None:
    if padding not in ("border", "zeros"):
        raise ValueError(f"padding must be 'border' or 'zeros', got {padding!r}")
    if not isinstance(r, int) or r < 0:
        raise ValueError(f"r must be an int >= 0 (0 = unbounded), got {r!r}")
    if img.dim() != 4 or flow.dim() != 4 or flow.shape[1] != 2:
        raise ValueError(
            f"expected img [B,C,H,W] and flow [B,2,H,W], got {tuple(img.shape)} "
            f"and {tuple(flow.shape)}"
        )
    b, _, h, w = img.shape
    if (flow.shape[0], flow.shape[2], flow.shape[3]) != (b, h, w):
        raise ValueError(f"flow {tuple(flow.shape)} does not match img {tuple(img.shape)}")


def _on_cpu(img: torch.Tensor, flow: torch.Tensor, name: str) -> bool:
    """True for CPU tensors (the plain version's), False for CUDA ones that
    the kernel takes; raises on anything else."""
    if img.device.type == "cpu" and flow.device.type == "cpu":
        return True
    if img.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {img.device}")
    _check_cuda_args(img, flow, name)
    return False


def warp2d(
    img: torch.Tensor, flow: torch.Tensor, r: int = 16, padding: str = "border"
) -> torch.Tensor:
    """Warp ``img [B, C, H, W]`` by ``flow [B, 2, H, W]`` (dy, dx), clipped to ±r.

    ``r = 0`` is unbounded.  Returns ``[B, C, H, W]`` in ``img``'s dtype;
    on CUDA, image and flow share one dtype, float32 or bfloat16, or the
    image is bfloat16 and the flow float32 (its gradient then float32 too).
    Differentiable in ``img`` and ``flow``; a flow component with
    ``|flow| >= r`` gets no gradient.
    """
    _check_args2d(img, flow, r, padding)
    if _on_cpu(img, flow, "warp2d"):
        return warp2d_plain(img, flow, r, padding)
    return _Warp2dKernel.apply(img, flow, r, padding, False)[0]


def warp2d_with_mask(
    img: torch.Tensor, flow: torch.Tensor, padding: str = "zeros"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unbounded ``warp2d`` and its validity mask ``[B, 1, H, W]``: the share of
    bilinear weight that fell inside the image, in ``img``'s dtype.

    The mask equals the warp of an image of ones under ``'zeros'`` padding bit
    for bit (on the card the same launch writes both) and carries no
    gradient: callers compare it with a threshold.
    """
    _check_args2d(img, flow, 0, padding)
    if _on_cpu(img, flow, "warp2d"):
        warped = warp2d_plain(img, flow, 0, padding)
        with torch.no_grad():
            ones = torch.ones((img.shape[0], 1) + tuple(img.shape[2:]), dtype=img.dtype,
                              device=img.device)
            mask = warp2d_plain(ones, flow, 0, "zeros")
        return warped, mask
    return _Warp2dKernel.apply(img, flow, 0, padding, True)


# -- 3-D ------------------------------------------------------------------------

_I64x5 = ctypes.c_int64 * 5


def _library3d() -> ctypes.CDLL:
    lib = load("warp3d")
    if lib.warp3d_forward.argtypes is None:
        ints = ctypes.POINTER(ctypes.c_int64)
        lib.warp3d_forward.argtypes = (
            [ctypes.c_void_p] * 3 + [ints] * 2 + [ctypes.c_int64] * 9 + [ctypes.c_void_p]
        )
        lib.warp3d_forward.restype = ctypes.c_int
        lib.warp3d_backward.argtypes = (
            [ctypes.c_void_p] * 5 + [ints] * 3 + [ctypes.c_int64] * 9 + [ctypes.c_void_p]
        )
        lib.warp3d_backward.restype = ctypes.c_int
        # the same with the slab's z offset after `zeros`
        lib.warp3d_forward_offset.argtypes = (
            [ctypes.c_void_p] * 3 + [ints] * 2 + [ctypes.c_int64] * 10 + [ctypes.c_void_p]
        )
        lib.warp3d_forward_offset.restype = ctypes.c_int
        lib.warp3d_backward_offset.argtypes = (
            [ctypes.c_void_p] * 5 + [ints] * 3 + [ctypes.c_int64] * 10 + [ctypes.c_void_p]
        )
        lib.warp3d_backward_offset.restype = ctypes.c_int
    return lib


def _modes(padding: str, z_offset: int, img: torch.Tensor) -> tuple[int, ...]:
    """The kernels' (zeros[, z_off], bf16) arguments: the offset only for the
    *_offset entries, which a nonzero offset selects."""
    zeros, bf16 = int(padding == "zeros"), int(img.dtype == torch.bfloat16)
    return (zeros, z_offset, bf16) if z_offset else (zeros, bf16)


def _launch3d(img: torch.Tensor, flow: torch.Tensor, r_z: int, r_yx: int,
              padding: str, z_offset: int = 0) -> torch.Tensor:
    geometry = launch_geometry(img.shape)
    out = torch.empty_like(img, memory_format=torch.contiguous_format)
    lib = _library3d()
    fn = lib.warp3d_forward_offset if z_offset else lib.warp3d_forward
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(
            img.data_ptr(), flow.data_ptr(), out.data_ptr(),
            _I64x5(*img.shape), _I64x5(*flow.stride()),
            r_z, r_yx, *_modes(padding, z_offset, img),
            *geometry.grid, *geometry.block, stream,
        )
    if err:
        raise RuntimeError(f"warp3d kernel launch failed with CUDA error {err}")
    LAUNCHES["warp3d"] += 1
    OFFSET_LAUNCHES["warp3d"] += bool(z_offset)
    return out


def _launch3d_backward(
    img: torch.Tensor, flow: torch.Tensor, grad_out: torch.Tensor, r_z: int, r_yx: int,
    padding: str, need_dimg: bool, z_offset: int = 0,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """One launch of the 3-D backward kernel, on the forward's grid:
    ``(dimg or None, dflow)``.  With a ``z_offset`` ``dimg`` is always
    computed: the ``*_offset`` backward has only the instances that write it
    (the sharded warp's calls)."""
    _check_grad(img, grad_out, "warp3d")
    need_dimg = need_dimg or bool(z_offset)
    geometry = launch_geometry(img.shape)  # refuses 2^31 voxels before allocating
    dflow = torch.empty((img.shape[0], 3) + tuple(img.shape[2:]), dtype=flow.dtype,
                        device=flow.device)
    acc = torch.zeros(img.shape, dtype=torch.float32, device=img.device) if need_dimg else None
    lib = _library3d()
    fn = lib.warp3d_backward_offset if z_offset else lib.warp3d_backward
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(
            img.data_ptr(), flow.data_ptr(), grad_out.data_ptr(), dflow.data_ptr(),
            acc.data_ptr() if need_dimg else None,
            _I64x5(*img.shape), _I64x5(*flow.stride()), _I64x5(*grad_out.stride()),
            r_z, r_yx, *_modes(padding, z_offset, img),
            *geometry.grid, *geometry.block, stream,
        )
    if err:
        raise RuntimeError(f"warp3d backward kernel launch failed with CUDA error {err}")
    LAUNCHES["warp3d_bwd"] += 1
    OFFSET_LAUNCHES["warp3d_bwd"] += bool(z_offset)
    return (acc.to(img.dtype) if need_dimg else None), dflow


class _Warp3dKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, flow, r_z, r_yx, padding, z_offset):
        ctx.save_for_backward(img, flow)
        ctx.radii, ctx.padding, ctx.z_offset = (r_z, r_yx), padding, z_offset
        return _launch3d(img, flow, r_z, r_yx, padding, z_offset)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        img, flow = ctx.saved_tensors
        need_dimg, need_dflow = ctx.needs_input_grad[:2]
        dimg, dflow = _launch3d_backward(img, flow, grad_out, *ctx.radii, ctx.padding,
                                         need_dimg, ctx.z_offset)
        return ((dimg if need_dimg else None), (dflow if need_dflow else None),
                None, None, None, None)


def warp3d(
    img: torch.Tensor, flow: torch.Tensor, r_z: int = 8, r_yx: int = 8,
    padding: str = "border", z_offset: int = 0,
) -> torch.Tensor:
    """Warp ``img [B, C, Z, Y, X]`` by ``flow [B, 3, Z, Y, X]`` (dz, dy, dx).

    ``flow_z`` is clipped to ``±r_z`` and ``flow_y``, ``flow_x`` to ``±r_yx``;
    a radius of 0 leaves its components unbounded.  Returns ``[B, C, Z, Y, X]``
    in ``img``'s dtype; on CUDA, image and flow share one dtype, float32 or
    bfloat16, and the image is contiguous while the flow may be any strided
    view.  Differentiable in ``img`` and ``flow``; a flow component at or
    beyond its radius gets no gradient.

    ``z_offset``: ``img`` is a slab of a larger volume whose slice 0 is the
    volume's slice ``z_offset`` (a depth shard with its halo): each z
    coordinate is formed in the volume's frame, as the call on the whole
    volume forms it, and indexed in the slab's, so that the slab's samples
    are the whole volume's bit for bit.
    """
    if padding not in ("border", "zeros"):
        raise ValueError(f"padding must be 'border' or 'zeros', got {padding!r}")
    for name, r in (("r_z", r_z), ("r_yx", r_yx)):
        if not isinstance(r, int) or r < 0:
            raise ValueError(f"{name} must be an int >= 0 (0 = unbounded), got {r!r}")
    if img.dim() != 5 or flow.dim() != 5 or flow.shape[1] != 3:
        raise ValueError(
            f"expected img [B,C,Z,Y,X] and flow [B,3,Z,Y,X], got {tuple(img.shape)} "
            f"and {tuple(flow.shape)}"
        )
    if (flow.shape[0],) + tuple(flow.shape[2:]) != (img.shape[0],) + tuple(img.shape[2:]):
        raise ValueError(f"flow {tuple(flow.shape)} does not match img {tuple(img.shape)}")
    if not isinstance(z_offset, int):
        raise ValueError(f"z_offset must be an int, got {z_offset!r}")
    if _on_cpu(img, flow, "warp3d"):
        return warp3d_plain(img, flow, r_z, r_yx, padding, z_offset)
    return _Warp3dKernel.apply(img, flow, r_z, r_yx, padding, z_offset)
