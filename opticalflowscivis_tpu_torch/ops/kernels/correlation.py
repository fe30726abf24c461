"""2-D cost volume: wrapper of the Hopper kernels in ``csrc/corr.cu``.

``cost_volume_kernel`` is the counterpart of
``opticalflowscivis_tpu/ops/pallas/correlation.py::cost_volume_pallas``,
forward and VJP (the TPU package's VJP is jnp; here it is a kernel too).  It
dispatches by the tensors' device:

- CUDA tensors launch ``corr_forward`` (``f1`` and ``f2`` both float32 or both
  bfloat16, any strides, ``max_disp`` 1 to 4: every configuration of the
  package uses at most 4), or raise on anything the kernel does not take; a
  gradient through it launches ``corr_backward`` once, which writes ``df1``,
  ``df2`` or both, whichever inputs need one.  There is no fallback to the
  plain version;
- CPU tensors go to ``ops.correlation.cost_volume_plain``, whose backward is
  PyTorch's autograd.

The TPU dispatch gate (the Pallas kernel is switched off below a plane size
there) is tuning for that machine and is not carried over: on the card every
2-D cost volume goes through the kernel.

``forward_launch`` computes, from the shape alone, the launch that
``corr_forward`` makes (``fwd_geometry`` in ``csrc/corr.cu``, which
``corr_forward_launch`` reports): tiles of 16 rows x 32 columns, or of 1 row
where 16-row tiles would give fewer than 66 blocks (half of an H100's SMs),
times groups of 3 of
the ``2 md + 1`` row offsets; 128 threads; dynamic shared memory that depends
on ``max_disp``, the tile and the element size.

``backward_launch`` computes, from the shape alone, the launch that
``corr_backward`` makes (the same arithmetic as ``bwd_geometry`` in
``csrc/corr.cu``, which ``corr_backward_launch`` reports): blocks of 8 x 16
pixels and 32 channels, 128 threads, and dynamic shared memory that depends
on ``max_disp`` only.  The wrappers ask them before anything is allocated,
so a shape beyond CUDA's grid or the shared-memory budget raises
``ValueError`` and launches nothing.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch
from torch.autograd.function import once_differentiable

from opticalflowscivis_tpu_torch.ops.correlation import cost_volume_plain
from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
from opticalflowscivis_tpu_torch.ops.kernels.build import load

_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_MAX_DISP = (1, 4)  # csrc/corr.cu instantiates its kernels for these max_disp
_I64x4 = ctypes.c_int64 * 4
_I64x5 = ctypes.c_int64 * 5
_I64x6 = ctypes.c_int64 * 6

# the forward's geometry: the F* constants of csrc/corr.cu
_FWD_COLS = 32  # tile columns: 8 threads of 4 x
_FWD_ROWS = (16, 1)  # tile rows: 16, or 1 where 16 would give too few blocks
_FWD_DY = 3  # row offsets dy per block
_FWD_THREADS = 128
_FWD_STAGES = 3  # channel stages in the cp.async ring
_FWD_WANT_BLOCKS = 132 // 2  # 16-row tiles busy at least half of an H100's SMs

# the backward's geometry: the B* constants of csrc/corr.cu
_BWD_TILE = (8, 16)  # pixel rows, columns of a block
_BWD_SLAB = 32  # channels per block: 4 groups of 8, one group per thread
_BWD_THREADS = 128
_SHARED_LIMIT = 232448  # bytes of shared memory one block may hold on Hopper (227 KB)
_MAX_GRID_X = 2**31 - 1
_MAX_GRID_YZ = 65535


class ForwardLaunch(NamedTuple):
    grid: tuple[int, int, int]  # x tiles, row tiles, samples * dy groups
    threads: int
    shared_bytes: int
    tile_rows: int  # 16, or 1 (16 channel groups of one row a block)


def forward_shared_bytes(max_disp: int, tile_rows: int, elem_bytes: int) -> int:
    """Dynamic shared memory of one forward block: a ring of 3 stages of
    channels (4 a stage with 16-row tiles, 32 with 1-row tiles), each channel
    f1's ``tile_rows x 32`` and the window's ``tile_rows + 2`` rows of
    ``28 + 4 ceil((4 + 2 md) / 4)`` elements, in the inputs' type; 1-row
    tiles need at least room for the 16 groups' f32 sums (128 threads x 3 dy
    x ``(2 md + 1)`` float4)."""
    nv = -(-(4 + 2 * max_disp) // 4)
    per_channel = tile_rows * _FWD_COLS + (tile_rows + _FWD_DY - 1) * (_FWD_COLS - 4 + 4 * nv)
    ring = _FWD_STAGES * (4 if tile_rows == 16 else 32) * per_channel * elem_bytes
    sums = 0 if tile_rows == 16 else _FWD_THREADS * _FWD_DY * (2 * max_disp + 1) * 16
    return max(ring, sums)


def forward_launch(shape: Sequence[int], max_disp: int, bf16: bool = False) -> ForwardLaunch:
    """The forward kernel's launch for features ``[B, C, H, W]`` (bfloat16 or
    float32), from the shape alone.  Raises ``ValueError`` where the grid
    exceeds CUDA's limits or ``max_disp`` is not one the kernel is built
    for."""
    if len(shape) != 4 or min(shape) < 1:
        raise ValueError(f"expected non-empty features [B, C, H, W], got {tuple(shape)}")
    lo, hi = _KERNEL_MAX_DISP
    if not isinstance(max_disp, int) or not lo <= max_disp <= hi:
        raise ValueError(f"corr kernel is built for max_disp {lo} to {hi}, got {max_disp!r}")
    b, _, h, w = shape
    gx, gz = -(-w // _FWD_COLS), b * -(-(2 * max_disp + 1) // _FWD_DY)
    rows = _FWD_ROWS[0] if gx * -(-h // _FWD_ROWS[0]) * gz >= _FWD_WANT_BLOCKS else _FWD_ROWS[1]
    grid = (gx, -(-h // rows), gz)
    if grid[0] > _MAX_GRID_X or max(grid[1:]) > _MAX_GRID_YZ:
        raise ValueError(
            f"corr forward grid {grid} for {tuple(shape)} exceeds CUDA's limits "
            f"({_MAX_GRID_X}, {_MAX_GRID_YZ}, {_MAX_GRID_YZ})"
        )
    shared = forward_shared_bytes(max_disp, rows, 2 if bf16 else 4)
    return ForwardLaunch(grid, _FWD_THREADS, shared, rows)


class BackwardLaunch(NamedTuple):
    grid: tuple[int, int, int]  # x tiles, row tiles, gradients * samples * channel slabs
    threads: int
    shared_bytes: int


def backward_shared_bytes(max_disp: int) -> int:
    """Dynamic shared memory of one backward block: the window of a slab of
    32 channels, ``(8 + 2 md)`` rows of ``16 + 2 md`` columns (row stride
    rounded up to 4 floats, channel stride 16 floats off a multiple of 32 so
    that neighbouring channels fall in other banks), and two buffers of the
    ``2 md + 1`` coefficient planes of one row offset over the tile."""
    rows, cols = _BWD_TILE
    nd = 2 * max_disp + 1
    wh, ww4 = rows + 2 * max_disp, -(-(cols + 2 * max_disp) // 4) * 4
    cs = wh * ww4 + (16 - (wh * ww4) % 32) % 32
    return 4 * (_BWD_SLAB * cs + 2 * nd * rows * cols)


def backward_launch(shape: Sequence[int], max_disp: int, copies: int = 2) -> BackwardLaunch:
    """The backward kernel's launch for features ``[B, C, H, W]`` and
    ``copies`` gradients (1: df1 or df2, 2: both), from the shape alone.
    Raises ``ValueError`` where the grid exceeds CUDA's limits, the shared
    memory exceeds what a block may hold, or ``max_disp`` is not one the
    kernel is built for."""
    if len(shape) != 4 or min(shape) < 1:
        raise ValueError(f"expected non-empty features [B, C, H, W], got {tuple(shape)}")
    if not isinstance(max_disp, int) or max_disp < 1 or copies not in (1, 2):
        raise ValueError(f"no backward launch for max_disp {max_disp!r}, {copies!r} gradients")
    b, c, h, w = shape
    rows, cols = _BWD_TILE
    grid = (-(-w // cols), -(-h // rows), b * copies * -(-c // _BWD_SLAB))
    if grid[0] > _MAX_GRID_X or max(grid[1:]) > _MAX_GRID_YZ:
        raise ValueError(
            f"corr backward grid {grid} for {tuple(shape)} exceeds CUDA's limits "
            f"({_MAX_GRID_X}, {_MAX_GRID_YZ}, {_MAX_GRID_YZ})"
        )
    shared = backward_shared_bytes(max_disp)
    if shared > _SHARED_LIMIT:
        raise ValueError(
            f"corr backward at max_disp {max_disp} needs {shared} bytes of shared memory, "
            f"more than the {_SHARED_LIMIT} a block may hold"
        )
    lo, hi = _KERNEL_MAX_DISP
    if not lo <= max_disp <= hi:
        raise ValueError(f"corr kernel is built for max_disp {lo} to {hi}, got {max_disp}")
    return BackwardLaunch(grid, _BWD_THREADS, shared)


def _library() -> ctypes.CDLL:
    lib = load("corr")
    if lib.corr_forward.argtypes is None:
        ints = ctypes.POINTER(ctypes.c_int64)
        lib.corr_forward.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 5 + [ints] * 2
            + [ctypes.c_int64, ctypes.c_void_p]
        )
        lib.corr_forward.restype = ctypes.c_int
        lib.corr_backward.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5 + [ints] * 3
            + [ctypes.c_int64, ctypes.c_void_p]
        )
        lib.corr_backward.restype = ctypes.c_int
        lib.corr_forward_launch.argtypes = [ctypes.c_int64] * 6 + [ints]
        lib.corr_forward_launch.restype = ctypes.c_int
        lib.corr_backward_launch.argtypes = [ctypes.c_int64] * 6 + [ints]
        lib.corr_backward_launch.restype = ctypes.c_int
    return lib


def kernel_forward_launch(
    shape: Sequence[int], max_disp: int, bf16: bool = False
) -> ForwardLaunch | None:
    """The launch that the built ``corr_forward`` makes, as
    ``corr_forward_launch`` in ``csrc/corr.cu`` reports it, or None where it
    refuses the shape; for holding ``forward_launch`` against the kernel."""
    out = _I64x6()
    if _library().corr_forward_launch(*shape, max_disp, int(bf16), out):
        return None
    return ForwardLaunch((out[0], out[1], out[2]), out[3], out[4], out[5])


def kernel_backward_launch(
    shape: Sequence[int], max_disp: int, copies: int = 2
) -> BackwardLaunch | None:
    """The launch that the built ``corr_backward`` makes, as
    ``corr_backward_launch`` in ``csrc/corr.cu`` reports it, or None where it
    refuses the shape; for holding ``backward_launch`` against the kernel."""
    out = _I64x5()
    if _library().corr_backward_launch(*shape, max_disp, copies, out):
        return None
    return BackwardLaunch((out[0], out[1], out[2]), out[3], out[4])


def _launch(f1: torch.Tensor, f2: torch.Tensor, md: int) -> torch.Tensor:
    b, c, h, w = f1.shape
    forward_launch(f1.shape, md, f1.dtype == torch.bfloat16)  # refuses before allocating
    out = torch.empty((b, (2 * md + 1) ** 2, h, w), dtype=f1.dtype, device=f1.device)
    fn = _library().corr_forward
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = fn(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, c, h, w, md,
            _I64x4(*f1.stride()), _I64x4(*f2.stride()),
            int(f1.dtype == torch.bfloat16), stream,
        )
    if err:
        raise RuntimeError(f"corr kernel launch failed with CUDA error {err}")
    LAUNCHES["corr"] += 1
    return out


def _launch_backward(
    f1: torch.Tensor, f2: torch.Tensor, grad_out: torch.Tensor, md: int,
    need_df1: bool = True, need_df2: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """One launch of the backward kernel: ``(df1 or None, df2 or None)``."""
    b, c, h, w = f1.shape
    if grad_out.device != f1.device or grad_out.dtype != f1.dtype:
        raise TypeError(
            f"corr backward got a gradient of {grad_out.dtype} on {grad_out.device} "
            f"for features of {f1.dtype} on {f1.device}"
        )
    if grad_out.shape != (b, (2 * md + 1) ** 2, h, w):
        raise ValueError(
            f"corr backward got a gradient {tuple(grad_out.shape)} for features "
            f"{tuple(f1.shape)} at max_disp {md}"
        )
    if not (need_df1 or need_df2):
        return None, None
    backward_launch(f1.shape, md, int(need_df1) + int(need_df2))  # refuses before allocating
    df1 = torch.empty(f1.shape, dtype=f1.dtype, device=f1.device) if need_df1 else None
    df2 = torch.empty(f2.shape, dtype=f2.dtype, device=f2.device) if need_df2 else None
    fn = _library().corr_backward
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = fn(
            f1.data_ptr(), f2.data_ptr(), grad_out.data_ptr(),
            df1.data_ptr() if need_df1 else None, df2.data_ptr() if need_df2 else None,
            b, c, h, w, md,
            _I64x4(*f1.stride()), _I64x4(*f2.stride()), _I64x4(*grad_out.stride()),
            int(f1.dtype == torch.bfloat16), stream,
        )
    if err:
        raise RuntimeError(f"corr backward kernel launch failed with CUDA error {err}")
    LAUNCHES["corr_bwd"] += 1
    return df1, df2


class _CorrKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2, md):
        ctx.save_for_backward(f1, f2)
        ctx.md = md
        return _launch(f1, f2, md)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        f1, f2 = ctx.saved_tensors
        df1, df2 = _launch_backward(f1, f2, grad_out, ctx.md, *ctx.needs_input_grad[:2])
        return df1, df2, None


def cost_volume_kernel(f1: torch.Tensor, f2: torch.Tensor, max_disp: int = 4) -> torch.Tensor:
    """Cost volume of channels-first ``f1, f2 [B, C, H, W]`` →
    ``[B, (2 * max_disp + 1)^2, H, W]`` (contiguous), in ``f1``'s dtype.

    ``out[b, dy * (2 md + 1) + dx, y, x]`` is the channel mean of
    ``f1[b, :, y, x] * f2[b, :, y + dy - md, x + dx - md]``, zero outside
    ``f2``.  On CUDA both inputs are float32 or both bfloat16, in any memory
    layout (they are read through their strides), and ``max_disp`` is 1 to 4.
    Differentiable in ``f1`` and ``f2``.
    """
    if not isinstance(max_disp, int) or max_disp < 0:
        raise ValueError(f"max_disp must be an int >= 0, got {max_disp!r}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(
            f"expected two feature maps [B,C,H,W] of one shape, got {tuple(f1.shape)} "
            f"and {tuple(f2.shape)}"
        )
    if f1.device.type == "cpu" and f2.device.type == "cpu":
        return cost_volume_plain(f1, f2, max_disp)
    if f1.device.type != "cuda":
        raise ValueError(f"cost_volume_kernel runs on cuda or cpu tensors, got {f1.device}")
    if f2.device != f1.device:
        raise ValueError(f"f1 on {f1.device} but f2 on {f2.device}")
    if f1.dtype not in _DTYPES or f2.dtype != f1.dtype:
        raise TypeError(
            f"corr kernel takes f1 and f2 both float32 or both bfloat16, got {f1.dtype} "
            f"and {f2.dtype}"
        )
    if f1.numel() == 0:
        raise ValueError(f"corr kernel got empty feature maps {tuple(f1.shape)}")
    lo, hi = _KERNEL_MAX_DISP
    if not lo <= max_disp <= hi:
        raise ValueError(f"corr kernel is built for max_disp {lo} to {hi}, got {max_disp}")
    return _CorrKernel.apply(f1, f2, max_disp)
