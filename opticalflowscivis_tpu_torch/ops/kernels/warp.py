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

The backward kernels write ``dflow`` once per pixel and accumulate ``dimg``
with float32 atomics into a float32 buffer that is zero-filled here and cast
to the image's dtype afterwards; atomics sum in an order that changes from run
to run, so ``dimg`` is reproducible only to float32 rounding.  When the image
needs no gradient (the model's warps sample the input frames) the buffer and
the atomics are skipped.  The flow and the incoming gradient are read through
their strides, in whatever layout the caller or autograd hands them over,
without a copy.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
from opticalflowscivis_tpu_torch.ops.kernels.build import load
from opticalflowscivis_tpu_torch.ops.warp import warp2d_plain, warp3d_plain

_DTYPES = (torch.float32, torch.bfloat16)


def _library() -> ctypes.CDLL:
    lib = load("warp2d")
    if lib.warp2d_forward.argtypes is None:
        lib.warp2d_forward.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 11 + [ctypes.c_void_p]
        )
        lib.warp2d_forward.restype = ctypes.c_int
        lib.warp2d_backward.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 15 + [ctypes.c_void_p]
        )
        lib.warp2d_backward.restype = ctypes.c_int
    return lib


def _type_code(img: torch.Tensor, flow: torch.Tensor) -> int:
    """The 2-D kernels' type flag: 0 all f32, 1 all bf16, 2 bf16 image with an
    f32 flow (and an f32 ``dflow``)."""
    if img.dtype == torch.float32:
        return 0
    return 1 if flow.dtype == torch.bfloat16 else 2


def _launch(img: torch.Tensor, flow: torch.Tensor, r: int, padding: str) -> torch.Tensor:
    b, c, h, w = img.shape
    out = torch.empty_like(img, memory_format=torch.contiguous_format)
    fn = _library().warp2d_forward
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(
            img.data_ptr(), flow.data_ptr(), out.data_ptr(),
            b, c, h, w, *flow.stride(),
            r, int(padding == "zeros"), _type_code(img, flow), stream,
        )
    if err:
        raise RuntimeError(f"warp2d kernel launch failed with CUDA error {err}")
    LAUNCHES["warp2d"] += 1
    return out


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
    """One launch of the backward kernel: ``(dimg or None, dflow)``."""
    _check_grad(img, grad_out, "warp2d")
    b, c, h, w = img.shape
    dflow = torch.empty((b, 2, h, w), dtype=flow.dtype, device=flow.device)
    acc = torch.zeros(img.shape, dtype=torch.float32, device=img.device) if need_dimg else None
    fn = _library().warp2d_backward
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(
            img.data_ptr(), flow.data_ptr(), grad_out.data_ptr(), dflow.data_ptr(),
            acc.data_ptr() if need_dimg else None,
            b, c, h, w, *flow.stride(), *grad_out.stride(),
            r, int(padding == "zeros"), _type_code(img, flow), stream,
        )
    if err:
        raise RuntimeError(f"warp2d backward kernel launch failed with CUDA error {err}")
    LAUNCHES["warp2d_bwd"] += 1
    return (acc.to(img.dtype) if need_dimg else None), dflow


class _Warp2dKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, flow, r, padding):
        ctx.save_for_backward(img, flow)
        ctx.r, ctx.padding = r, padding
        return _launch(img, flow, r, padding)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        img, flow = ctx.saved_tensors
        need_dimg, need_dflow = ctx.needs_input_grad[:2]
        dimg, dflow = _launch_backward(img, flow, grad_out, ctx.r, ctx.padding, need_dimg)
        return dimg, (dflow if need_dflow else None), None, None


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
    if img.device.type == "cpu" and flow.device.type == "cpu":
        return warp2d_plain(img, flow, r, padding)
    if img.device.type != "cuda":
        raise ValueError(f"warp2d runs on cuda or cpu tensors, got {img.device}")
    _check_cuda_args(img, flow)
    return _Warp2dKernel.apply(img, flow, r, padding)


def warp2d_with_mask(
    img: torch.Tensor, flow: torch.Tensor, padding: str = "zeros"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unbounded ``warp2d`` and its validity mask ``[B, 1, H, W]``: the share of
    bilinear weight that fell inside the image, in ``img``'s dtype.

    The mask is the warp of an image of ones under ``'zeros'`` padding (a
    second launch on the card) and carries no gradient: callers compare it
    with a threshold.
    """
    warped = warp2d(img, flow, 0, padding)
    with torch.no_grad():
        ones = torch.ones((img.shape[0], 1) + tuple(img.shape[2:]), dtype=img.dtype,
                          device=img.device)
        mask = warp2d(ones, flow, 0, "zeros")
    return warped, mask


# -- 3-D ------------------------------------------------------------------------

_I64x5 = ctypes.c_int64 * 5


def _library3d() -> ctypes.CDLL:
    lib = load("warp3d")
    if lib.warp3d_forward.argtypes is None:
        ints = ctypes.POINTER(ctypes.c_int64)
        lib.warp3d_forward.argtypes = (
            [ctypes.c_void_p] * 3 + [ints] * 2 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
        )
        lib.warp3d_forward.restype = ctypes.c_int
        lib.warp3d_backward.argtypes = (
            [ctypes.c_void_p] * 5 + [ints] * 3 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
        )
        lib.warp3d_backward.restype = ctypes.c_int
    return lib


def _launch3d(img: torch.Tensor, flow: torch.Tensor, r_z: int, r_yx: int,
              padding: str) -> torch.Tensor:
    out = torch.empty_like(img, memory_format=torch.contiguous_format)
    fn = _library3d().warp3d_forward
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(
            img.data_ptr(), flow.data_ptr(), out.data_ptr(),
            _I64x5(*img.shape), _I64x5(*flow.stride()),
            r_z, r_yx, int(padding == "zeros"), int(img.dtype == torch.bfloat16), stream,
        )
    if err:
        raise RuntimeError(f"warp3d kernel launch failed with CUDA error {err}")
    LAUNCHES["warp3d"] += 1
    return out


def _launch3d_backward(
    img: torch.Tensor, flow: torch.Tensor, grad_out: torch.Tensor, r_z: int, r_yx: int,
    padding: str, need_dimg: bool,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """One launch of the 3-D backward kernel: ``(dimg or None, dflow)``."""
    _check_grad(img, grad_out, "warp3d")
    dflow = torch.empty((img.shape[0], 3) + tuple(img.shape[2:]), dtype=flow.dtype,
                        device=flow.device)
    acc = torch.zeros(img.shape, dtype=torch.float32, device=img.device) if need_dimg else None
    fn = _library3d().warp3d_backward
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(
            img.data_ptr(), flow.data_ptr(), grad_out.data_ptr(), dflow.data_ptr(),
            acc.data_ptr() if need_dimg else None,
            _I64x5(*img.shape), _I64x5(*flow.stride()), _I64x5(*grad_out.stride()),
            r_z, r_yx, int(padding == "zeros"), int(img.dtype == torch.bfloat16), stream,
        )
    if err:
        raise RuntimeError(f"warp3d backward kernel launch failed with CUDA error {err}")
    LAUNCHES["warp3d_bwd"] += 1
    return (acc.to(img.dtype) if need_dimg else None), dflow


class _Warp3dKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, flow, r_z, r_yx, padding):
        ctx.save_for_backward(img, flow)
        ctx.radii, ctx.padding = (r_z, r_yx), padding
        return _launch3d(img, flow, r_z, r_yx, padding)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        img, flow = ctx.saved_tensors
        need_dimg, need_dflow = ctx.needs_input_grad[:2]
        dimg, dflow = _launch3d_backward(img, flow, grad_out, *ctx.radii, ctx.padding,
                                         need_dimg)
        return dimg, (dflow if need_dflow else None), None, None, None


def warp3d(
    img: torch.Tensor, flow: torch.Tensor, r_z: int = 8, r_yx: int = 8,
    padding: str = "border",
) -> torch.Tensor:
    """Warp ``img [B, C, Z, Y, X]`` by ``flow [B, 3, Z, Y, X]`` (dz, dy, dx).

    ``flow_z`` is clipped to ``±r_z`` and ``flow_y``, ``flow_x`` to ``±r_yx``;
    a radius of 0 leaves its components unbounded.  Returns ``[B, C, Z, Y, X]``
    in ``img``'s dtype; on CUDA, image and flow share one dtype, float32 or
    bfloat16, and the image is contiguous while the flow may be any strided
    view.  Differentiable in ``img`` and ``flow``; a flow component at or
    beyond its radius gets no gradient.
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
    if img.device.type == "cpu" and flow.device.type == "cpu":
        return warp3d_plain(img, flow, r_z, r_yx, padding)
    if img.device.type != "cuda":
        raise ValueError(f"warp3d runs on cuda or cpu tensors, got {img.device}")
    _check_cuda_args(img, flow, "warp3d")
    return _Warp3dKernel.apply(img, flow, r_z, r_yx, padding)
