"""The warps' bytes and operations, pinned to values worked out by hand."""

import pytest

from portbench import roofline


def test_warp2d_work_by_hand():
    # [2, 1, 160, 224] bf16: 71680 pixels; forward reads image 2 B, flow 2 x 2 B,
    # writes 2 B: 8 B a pixel; 24 + 7 operations a pixel
    assert roofline.warp2d_forward_work((2, 1, 160, 224), 2, 2) == (573440, 2222080)
    # backward: image and gradient 2 x 2 B, flow read and dflow written 4 x 2 B,
    # dimg 2 B: 14 B a pixel; 30 + 16 + 8 operations
    assert roofline.warp2d_backward_work((2, 1, 160, 224), 2, 2, True) == (1003520, 3870720)
    assert roofline.warp2d_backward_work((2, 1, 160, 224), 2, 2, False) == (860160, 3297280)


def test_warp3d_work_by_hand():
    # [1, 1, 256^3] bf16: 16777216 voxels; forward 2 + 3 x 2 + 2 = 10 B, 45 + 24 + 16 ops
    assert roofline.warp3d_forward_work((1, 1, 256, 256, 256), 2, 2) == (167772160, 1426063360)
    # backward without dimg: 2 x (1 + 3 + 1 + 3) = 16 B, 45 + 24 + 60 ops
    assert roofline.warp3d_backward_work((1, 1, 256, 256, 256), 2, False) == (268435456,
                                                                             2164260864)


def test_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_s((3.35e12, 0)) == pytest.approx(1.0)
    assert roofline.bound_s((0, 67e12)) == pytest.approx(1.0)
    calls = [{"shape": (1, 1, 256, 256, 256), "padding": "border", "image_grad": False,
              "backward": True}]
    assert roofline.warp_bound_s(calls, 2) == pytest.approx(167772160 / 3.35e12
                                                           + 268435456 / 3.35e12)
