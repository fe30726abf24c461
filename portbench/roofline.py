"""Peaks of one NVIDIA H100 SXM and the bytes and operations of the port's
warps, copied from the bring-up smoke's formulas: each input byte read once,
each output byte written once, whatever a kernel reads again."""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores: the warps' arithmetic
BF16_FLOPS_PER_S = 989e12  # dense bfloat16 on the tensor cores: the model's peak


def warp2d_forward_work(shape, size: int, flow_size: int) -> tuple[int, int]:
    """``[B, C, H, W]``: image read, (dy, dx) read, output written; clip,
    coordinates, floors, fractions and 4 weights a pixel, 4 taps a channel."""
    b, c, h, w = shape
    px = b * h * w
    return px * (2 * size * c + 2 * flow_size), px * (24 + 7 * c)


def warp2d_backward_work(shape, size: int, flow_size: int, with_dimg: bool) -> tuple[int, int]:
    """Image, flow and incoming gradient read once, dflow (and dimg) written
    once; per channel the 4 taps' differences (and the 4 scattered products)."""
    b, c, h, w = shape
    px = b * h * w
    return (px * (2 * size * c + 4 * flow_size + (size * c if with_dimg else 0)),
            px * (30 + 16 * c + (8 * c if with_dimg else 0)))


def warp3d_forward_work(shape, size: int, flow_size: int) -> tuple[int, int]:
    """``[B, C, Z, Y, X]``: image read, (dz, dy, dx) read, output written;
    clips, coordinates and 8 weights a voxel, 8 taps a channel."""
    b, c = shape[:2]
    vox = b * math.prod(shape[2:])
    return vox * (2 * size * c + 3 * flow_size), vox * (45 + 24 + 16 * c)


def warp3d_backward_work(shape, size: int, with_dimg: bool) -> tuple[int, int]:
    """Image, flow and incoming gradient read once, dflow (and dimg) written
    once; per channel the 8 taps' differences (and the 8 scattered products)."""
    b, c = shape[:2]
    vox = b * math.prod(shape[2:])
    return (vox * size * (c + 3 + c + 3 + (c if with_dimg else 0)),
            vox * (45 + 24 + 60 * c + (16 * c if with_dimg else 0)))


def bound_s(work: tuple[int, int]) -> float:
    """The least time: bytes over the HBM rate or operations over the f32
    rate, whichever is larger."""
    nbytes, flops = work
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def warp_bound_s(calls: list[dict], size: int) -> float:
    """Seconds the warp ``calls`` (``reference.flops.count``'s records) take
    at least, forward and, where recorded, backward; elements of ``size``
    bytes (image, flow and gradients alike, as the model computes)."""
    total = 0.0
    for call in calls:
        shape = call["shape"]
        if len(shape) == 4:
            total += bound_s(warp2d_forward_work(shape, size, size))
            if call["backward"]:
                total += bound_s(warp2d_backward_work(shape, size, size, call["image_grad"]))
        else:
            total += bound_s(warp3d_forward_work(shape, size, size))
            if call["backward"]:
                total += bound_s(warp3d_backward_work(shape, size, call["image_grad"]))
    return total
