"""PyTorch port: the warp kernels' launch geometry and the validity mask, on
the CPU.

``ops.kernels.warp.launch_geometry`` decides every forward launch of
``csrc/warp2d.cu`` and ``csrc/warp3d.cu``, and every launch of the 3-D
backward, from the image's shape alone: a
grid of (x tiles, row tiles, planes), blocks of at most 256 threads that each
own 4 (2-D images) or 2 (volumes) consecutive x of one row, grid-stride loops
where the rows or planes exceed CUDA's 65535 limit, and a refusal of any plane or volume that 32-bit
offsets cannot address.  These tests hold it at the shapes the model paths
give the kernels and at the limits; the kernels themselves run in the
``cuda``-marked cases of ``tests/test_torch_kernels.py``.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
from opticalflowscivis_tpu_torch.ops.kernels import warp as kernels_warp
from opticalflowscivis_tpu_torch.ops.kernels.warp import (
    _launch3d_backward,
    launch_geometry,
    warp2d,
    warp2d_with_mask,
)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers side by side: a few threads each keep
    the many small ops of these tests from fighting over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _per_thread(shape):
    return 4 if len(shape) == 4 else 2


def _covers(shape, launch):
    """Every element of a row is some thread's, no column of blocks lies past
    the row's end, a block is at most 256 threads, and the grid is within
    CUDA's limits."""
    (gx, gy, gz), (tx, ty) = launch.grid, launch.block
    width, v = shape[-1], launch.per_thread
    return (v == _per_thread(shape) and tx * ty <= 256 and gx * tx * v >= width and (gx - 1) * tx * v < width
            and 1 <= gx < 2**31 and 1 <= gy <= 65535 and 1 <= gz <= 65535)


@pytest.mark.parametrize(
    "shape, grid, block",
    [
        ((32, 1, 160, 224), (1, 40, 32), (56, 4)),  # IFNet-2D serving
        ((64, 1, 128, 128), (1, 16, 64), (32, 8)),  # IFNet-2D training
        ((16, 32, 64, 208), (1, 16, 16), (52, 4)),  # UPFlow's finest feature warp
        ((16, 196, 4, 13), (1, 1, 16), (4, 4)),  # UPFlow's coarsest decoded level
        ((8, 3, 256, 832), (1, 256, 8), (208, 1)),  # UPFlow's photometric warp
        ((4, 1, 64, 64, 64), (1, 8, 256), (32, 8)),  # IFNet-3D at 64^3: planes B * Z
        ((1, 1, 256, 256, 256), (1, 128, 256), (128, 2)),  # train256
    ],
)
def test_launch_geometry_at_the_model_paths_shapes(shape, grid, block):
    launch = launch_geometry(shape)
    assert launch.grid == grid and launch.block == block and not launch.strided
    assert _covers(shape, launch)


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 13, 37, 53, 1023, 1024, 1025, 5000])
def test_launch_geometry_covers_ragged_rows(width):
    for shape in ((2, 1, 7, width), (2, 3, 7, width), (2, 1, 5, 7, width)):
        launch = launch_geometry(shape)
        assert _covers(shape, launch), shape
        # no block wider than the row needs
        assert launch.block[0] == min(256, -(-width // _per_thread(shape)))


@pytest.mark.parametrize(
    "shape, strided",
    [
        ((65535, 1, 1, 5), False),
        ((65536, 1, 1, 5), True),  # batch beyond the grid's z limit
        ((1, 1, 65535 * 256, 1), False),
        ((1, 1, 65535 * 256 + 1, 1), True),  # rows beyond the grid's y limit
        ((1, 1, 65535, 1, 3), False),
        ((2, 1, 40000, 2, 3), True),  # B * Z = 80000 planes
        ((1, 1, 2, 65535 * 256 + 1, 1), True),  # rows of a volume
    ],
)
def test_launch_geometry_switches_to_grid_stride_beyond_65535(shape, strided):
    launch = launch_geometry(shape)
    assert launch.strided == strided
    assert _covers(shape, launch)
    if strided:
        assert 65535 in launch.grid[1:]


@pytest.mark.parametrize(
    "shape",
    [
        (1, 1, 46341, 46341),  # 2^31 + 4633 elements in one plane
        (1, 1, 2**31, 1),
        (1, 1, 1, 2**31),
        (1, 1, 1291, 1291, 1291),  # 2^31 + 4.2 M voxels in one volume
        (1, 1, 2**11, 2**10, 2**10),
        (2**31, 1, 1, 1, 1),  # 2^31 planes
    ],
)
def test_launch_geometry_refuses_what_32_bit_offsets_cannot_address(shape):
    """By shape alone: no tensor of that size is ever made."""
    with pytest.raises(ValueError):
        launch_geometry(shape)


def test_launch_geometry_takes_the_largest_plane_and_volume():
    tall = (1, 1, 2**31 - 1, 1)
    assert launch_geometry(tall).strided and _covers(tall, launch_geometry(tall))
    for shape in ((1, 1, 1, 2**31 - 1), (1, 1, 1290, 1290, 1290)):
        assert _covers(shape, launch_geometry(shape)) and not launch_geometry(shape).strided
    with pytest.raises(ValueError):
        launch_geometry((1, 224))


@pytest.mark.parametrize("channels", [1, 2, 3, 32, 196])
def test_launch_geometry_gives_every_2d_image_four_pixels_a_thread(channels):
    """One row width for any number of channels: the grid depends on the
    plane alone."""
    launch = launch_geometry((16, channels, 64, 208))
    assert launch.per_thread == 4 and launch == launch_geometry((16, 1, 64, 208))
    assert launch_geometry((4, channels, 64, 64, 64)).per_thread == 2


def _mask_inputs(seed, b, c, h, w, dtype, flow_dtype):
    """Image and flow whose targets leave the image on every side, some by less
    than a pixel."""
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(0, 1, (b, c, h, w)).astype(np.float32)).to(dtype)
    flow = rng.standard_normal((b, 2, h, w)) * (h / 3)
    flow[:, :, ::3] = np.round(flow[:, :, ::3]) + rng.uniform(-1e-3, 1e-3, flow[:, :, ::3].shape)
    return img, torch.from_numpy(flow.astype(np.float32)).to(flow_dtype)


@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize(
    "dtype, flow_dtype",
    [("float32", "float32"), ("bfloat16", "bfloat16"), ("bfloat16", "float32")],
    ids=["f32", "bf16", "bf16_img_f32_flow"],
)
def test_warp2d_with_mask_is_the_warp_of_ones_on_cpu(dtype, flow_dtype, padding):
    """On the CPU the mask equals ``warp2d`` of an image of ones under zeros
    padding bit for bit, and the warp equals ``warp2d`` of the image, in all
    three type modes; nothing is launched."""
    dt, ft = getattr(torch, dtype), getattr(torch, flow_dtype)
    img, flow = _mask_inputs(3, 2, 5, 9, 13, dt, ft)
    before = dict(LAUNCHES)
    warped, mask = warp2d_with_mask(img, flow, padding)
    assert LAUNCHES == before
    ones = torch.ones((2, 1, 9, 13), dtype=dt)
    assert mask.dtype == dt and mask.shape == (2, 1, 9, 13)
    assert torch.equal(mask, warp2d(ones, flow, 0, "zeros"))
    assert torch.equal(warped, warp2d(img, flow, 0, padding))
    # the case has pixels fully inside, fully outside and on the edge
    values = mask.float()
    assert bool((values == 1).any() and (values == 0).any() and ((values > 0) & (values < 1)).any())


def test_warp2d_with_mask_passes_gradients_to_the_warp_only():
    img, flow = _mask_inputs(4, 1, 3, 8, 10, torch.float32, torch.float32)
    img.requires_grad_(True)
    flow.requires_grad_(True)
    warped, mask = warp2d_with_mask(img, flow)
    assert warped.requires_grad and not mask.requires_grad
    warped.sum().backward()
    ref_img = img.detach().clone().requires_grad_(True)
    ref_flow = flow.detach().clone().requires_grad_(True)
    warp2d(ref_img, ref_flow, 0, "zeros").sum().backward()
    assert torch.equal(img.grad, ref_img.grad) and torch.equal(flow.grad, ref_flow.grad)


@pytest.mark.parametrize(
    "kwargs",
    [{"padding": "reflect"}, {"flow_shape": (1, 3, 8, 10)}, {"flow_shape": (1, 2, 8, 9)}],
)
def test_warp2d_with_mask_rejects_what_warp2d_rejects(kwargs):
    img = torch.zeros(1, 2, 8, 10)
    flow = torch.zeros(kwargs.get("flow_shape", (1, 2, 8, 10)))
    with pytest.raises(ValueError):
        warp2d_with_mask(img, flow, kwargs.get("padding", "zeros"))


# -- the 3-D backward: the forward's grid -------------------------------------------


def _replay_visits(shape, launch, with_dimg):
    """How often the 3-D backward's loops visit each voxel ``[B, Z, Y, X]``,
    replayed in numpy.  Thread ``tx`` of block column ``bx`` owns two voxels
    of a row: ``x0 = 2 * (bx * TX + tx)`` and ``x0 + 1`` (``dflow`` only),
    or ``x0 = 2 * bx * TX + tx`` and ``x0 + TX`` (with ``dimg``), those below
    X; block row ``(by, ty)`` walks rows ``by * TY + ty`` in steps of
    ``gy * TY``; block plane ``bz`` walks planes ``p = bz, bz + gz, ...``
    below ``B * Z``, each split by one division into ``b = p // Z``,
    ``z = p - b * Z``.  The three loops are independent, so a voxel's visits
    are the product of its column's, row's and plane's."""
    b_, _, z_, y_, x_ = shape
    (gx, gy, gz), (tx, ty) = launch.grid, launch.block
    v = launch.per_thread
    bx, t = np.meshgrid(np.arange(gx), np.arange(tx), indexing="ij")
    if with_dimg:
        cols = np.concatenate([(v * bx * tx + t + j * tx).ravel() for j in range(v)])
    else:
        cols = np.concatenate([(v * (bx * tx + t) + j).ravel() for j in range(v)])
    x_visits = np.bincount(cols[cols < x_], minlength=x_)
    starts, step = np.arange(gy * ty), gy * ty
    ys = np.concatenate([starts + k * step for k in range(-(-y_ // step))])
    y_visits = np.bincount(ys[ys < y_], minlength=y_)
    planes = np.concatenate([np.arange(gz) + k * gz for k in range(-(-(b_ * z_) // gz))])
    planes = planes[planes < b_ * z_]
    b, z = planes // z_, planes - (planes // z_) * z_
    p_visits = np.zeros((b_, z_), np.int64)
    np.add.at(p_visits, (b, z), 1)
    return p_visits, y_visits, x_visits


# the model's volumes, ragged rows (X = 1, 5, 13, 17, 62), and the two
# grid-stride shapes: planes B * Z and rows beyond the grid's 65535 limit
BACKWARD_SHAPES = [
    (4, 1, 64, 64, 64),
    (1, 1, 256, 256, 256),
    (2, 1, 6, 7, 1),
    (1, 2, 5, 3, 5),
    (2, 3, 4, 1, 13),
    (2, 3, 11, 13, 17),
    (1, 1, 9, 10, 62),
    (2, 1, 40000, 2, 3),
    (1, 1, 1, 65535 * 256 + 1, 1),
]


@pytest.mark.parametrize("with_dimg", [False, True], ids=["dflow", "dimg"])
@pytest.mark.parametrize("shape", BACKWARD_SHAPES, ids=str)
def test_warp3d_backward_grid_visits_every_voxel_once(shape, with_dimg):
    launch = launch_geometry(shape)
    assert launch.strided == (shape[0] * shape[2] > 65535 or shape[3] > 65535 * 256)
    p_visits, y_visits, x_visits = _replay_visits(shape, launch, with_dimg)
    assert (p_visits == 1).all() and (y_visits == 1).all() and (x_visits == 1).all()
    if np.prod(shape) <= 2**21:  # the voxel grid itself, where it is small
        visits = np.einsum("bz,y,x->bzyx", p_visits, y_visits, x_visits)
        assert visits.shape == (shape[0],) + shape[2:] and (visits == 1).all()


@pytest.fixture
def _recorded_backward(monkeypatch):
    """``_launch3d_backward`` on meta tensors with the library, the device
    and the stream stood in for: returns the arguments each call hands the
    C entry ``warp3d_backward``."""
    calls = []

    def warp3d_backward(*args):
        calls.append(args)
        return 0

    lib = types.SimpleNamespace(warp3d_backward=warp3d_backward)
    monkeypatch.setattr(kernels_warp, "_library3d", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("need_dimg", [False, True], ids=["dflow", "dimg"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BACKWARD_SHAPES[:3] + BACKWARD_SHAPES[-2:], ids=str)
def test_warp3d_backward_launches_on_the_forward_grid(_recorded_backward, shape, dtype, need_dimg):
    """One launch a call, on ``launch_geometry``'s grid and block; the flow a
    slice of a 6-channel flow in the channels-last-3d layout, read through
    its strides; ``dflow`` and ``dimg`` shaped as the image."""
    dt = getattr(torch, dtype)
    b, c, z, y, x = shape
    img = torch.empty(shape, dtype=dt, device="meta")
    flow6 = torch.empty((b, 6, z, y, x), dtype=dt, device="meta").contiguous(
        memory_format=torch.channels_last_3d)
    flow, g = flow6[:, 3:], torch.empty(shape, dtype=dt, device="meta")
    before = dict(LAUNCHES)
    dimg, dflow = _launch3d_backward(img, flow, g, 8, 8, "border", need_dimg)
    assert LAUNCHES["warp3d_bwd"] == before["warp3d_bwd"] + 1
    (args,) = _recorded_backward
    launch = launch_geometry(shape)
    assert tuple(args[-6:-1]) == launch.grid + launch.block
    assert list(args[5]) == list(shape)
    assert list(args[6]) == list(flow.stride()) and list(args[7]) == list(g.stride())
    assert tuple(args[8:12]) == (8, 8, 0, int(dt == torch.bfloat16))
    assert dflow.shape == (b, 3, z, y, x) and dflow.dtype == dt
    assert (dimg is not None) == need_dimg and (args[4] is not None) == need_dimg
    if need_dimg:
        assert dimg.shape == shape and dimg.dtype == dt


@pytest.mark.parametrize("shape", [(1, 1, 1291, 1291, 1291), (1, 2, 2**11, 2**10, 2**10)],
                         ids=str)
def test_warp3d_backward_refuses_2_31_voxels_before_allocating(monkeypatch, shape):
    """A volume that 32-bit offsets cannot address raises ``ValueError``
    before any buffer is made or the library is asked for; nothing counts
    as launched."""

    def refuse(*args, **kwargs):
        raise AssertionError("allocated or built before refusing")

    b, _, z, y, x = shape
    img = torch.empty(shape, device="meta")
    flow = torch.empty((b, 3, z, y, x), device="meta")
    monkeypatch.setattr(kernels_warp, "_library3d", refuse)
    monkeypatch.setattr(torch, "empty", refuse)
    monkeypatch.setattr(torch, "zeros", refuse)
    before = dict(LAUNCHES)
    for need_dimg in (False, True):
        with pytest.raises(ValueError, match="32-bit"):
            _launch3d_backward(img, flow, img, 8, 8, "border", need_dimg)
    assert LAUNCHES == before


# -- the 2-D backward: the forward's grid, with channel groups ------------------------

from opticalflowscivis_tpu_torch.ops.kernels.warp import (  # noqa: E402
    _launch_backward,
    backward_geometry,
)


def _replay_visits2d(shape, launch, spread=False):
    """How often the 2-D backward's loops visit each pixel ``[B, H, W]`` and
    each channel, replayed in numpy from the kernel's own arithmetic.  Thread
    ``tx`` of block column ``bx`` takes the pixels ``x0 = 4 * (bx * TX + tx)``
    to ``x0 + n - 1``, ``n = min(4, W - x0)``, or with ``spread`` (``dimg``
    over several channels) ``x0 = 4 * bx * TX + tx`` and ``x0 + j * TX`` for
    ``j < n = min(4, ceil((W - x0) / TX))``, where ``x0`` is below W; block
    row ``by`` walks row tiles ``by * TY, by * TY + gy * TY, ...`` below H, its
    thread ``ty`` the row ``tile + ty`` where that is below H; block plane
    ``bz`` walks ``bz, bz + gz, ...`` below B; group ``k`` of G takes the
    channels ``[k * per, min(C, (k + 1) * per))``, ``per = ceil(C / G)``.  The
    loops are independent, so visits multiply; only the group-0 thread of a
    pixel writes its ``dflow``, so a pixel visited once is written once."""
    b_, c_, h_, w_ = shape
    (gx, gy, gz), (tx, ty), groups = launch.grid, launch.block, launch.groups
    xs = []
    for bx in range(gx):
        for t in range(tx):
            x0, step = (4 * bx * tx + t, tx) if spread else (4 * (bx * tx + t), 1)
            if x0 < w_:
                n = min(4, -(-(w_ - x0) // step))
                xs.extend(range(x0, x0 + n * step, step))
    xs = np.asarray(xs, np.int64)
    x_visits = np.bincount(xs, minlength=w_)
    tiles = np.concatenate([np.arange(by * ty, h_, gy * ty) for by in range(gy)])
    rows = (tiles[:, None] + np.arange(ty)[None]).ravel()
    y_visits = np.bincount(rows[rows < h_], minlength=h_)
    planes = np.concatenate([np.arange(bz, b_, gz) for bz in range(gz)])
    p_visits = np.bincount(planes, minlength=b_)
    per = -(-c_ // groups)
    c_visits = np.zeros(c_, np.int64)
    for k in range(groups):
        c_visits[min(c_, k * per):min(c_, (k + 1) * per)] += 1
    return p_visits, y_visits, x_visits, c_visits


# RIFE-2D's training shape, UPFlow's photometric warp, its four warped
# feature levels and its coarsest map, ragged widths (1, 3, 5, 13, 37, 53,
# 1023, 1025), channels that do not divide into the groups, and the
# grid-stride shapes: batch and rows beyond the grid's 65535 limit, with one
# channel group and with several
BACKWARD2D_SHAPES = [
    (64, 1, 128, 128),
    (8, 3, 256, 832),
    (16, 128, 8, 26),
    (16, 96, 16, 52),
    (16, 64, 32, 104),
    (16, 32, 64, 208),
    (16, 196, 4, 13),
    (2, 3, 5, 1),
    (1, 3, 1, 37),
    (3, 1, 9, 53),
    (2, 37, 3, 13),
    (1, 64, 5, 37),
    (2, 1, 7, 1023),
    (2, 9, 7, 1025),
    (3, 100, 2, 3),
    (2, 16, 1, 5),
    (70000, 1, 1, 5),
    (70000, 16, 1, 5),
    (1, 2, 65535 * 256 + 3, 1),
]


@pytest.mark.parametrize("spread", [False, True], ids=["consecutive", "spread"])
@pytest.mark.parametrize("shape", BACKWARD2D_SHAPES, ids=str)
def test_warp2d_backward_grid_visits_every_pixel_and_channel_once(shape, spread):
    launch = backward_geometry(shape)
    (gx, gy, gz), (tx, ty) = launch.grid, launch.block
    assert tx * ty * launch.groups <= 256 and 1 <= launch.groups <= 64
    assert gx * tx * 4 >= shape[3] and (gx - 1) * tx * 4 < shape[3]
    assert 1 <= gy <= 65535 and 1 <= gz <= 65535
    assert launch.strided == (shape[0] > 65535 or -(-shape[2] // ty) > 65535)
    p_visits, y_visits, x_visits, c_visits = _replay_visits2d(shape, launch, spread)
    # every pixel once (so its dflow by one group-0 thread), every channel by one group
    assert (p_visits == 1).all() and (y_visits == 1).all() and (x_visits == 1).all()
    assert (c_visits == 1).all()
    if np.prod(shape) <= 2**21:  # the (pixel, channel) grid itself, where it is small
        visits = np.einsum("b,c,y,x->bcyx", p_visits, c_visits, y_visits, x_visits)
        assert visits.shape == tuple(shape) and (visits == 1).all()


@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("plane", [(1, 1), (4, 13), (8, 26), (64, 208), (128, 128), (256, 832)],
                         ids=str)
def test_warp2d_backward_takes_one_channel_group_at_three_channels_or_fewer(plane, channels):
    """RIFE's one channel and the photometric three: the forward's launch, no
    groups, so the kernel without shared memory and barriers runs them."""
    for batch in (1, 16, 64):
        shape = (batch, channels) + plane
        launch = backward_geometry(shape)
        assert launch.groups == 1 and launch == launch_geometry(shape)


@pytest.mark.parametrize(
    "shape, groups",
    [
        ((16, 128, 8, 26), 32),  # /32
        ((16, 96, 16, 52), 16),  # /16
        ((16, 64, 32, 104), 8),  # /8
        ((16, 32, 64, 208), 4),  # /4
        ((16, 196, 4, 13), 32),  # the coarsest map
        ((64, 32, 256, 256), 1),  # pixels enough to fill the card alone
        ((16, 7, 4, 13), 1),  # fewer than 8 channels: no two groups of 4
        ((16, 8, 4, 13), 2),
    ],
)
def test_warp2d_backward_channel_groups_at_upflows_levels(shape, groups):
    """Channel groups where the pixels alone leave the card empty: doubled
    while the launch's threads stay below the 132 x 2048 the card holds at
    once, each group keeps at least 4 channels and a block at most 256
    threads."""
    launch = backward_geometry(shape)
    assert launch.groups == groups
    tx, ty = launch.block
    assert -(-shape[1] // groups) >= 4 and tx * ty * groups <= 256
    if groups > 1:  # rows fill what the groups leave of 256 threads
        assert ty == min(256 // (tx * groups), shape[2])


@pytest.fixture
def _recorded_backward2d(monkeypatch):
    """``_launch_backward`` on meta tensors with the library, the device and
    the stream stood in for: returns the arguments each call hands the C
    entry ``warp2d_backward``."""
    calls = []

    def warp2d_backward(*args):
        calls.append(args)
        return 0

    lib = types.SimpleNamespace(warp2d_backward=warp2d_backward)
    monkeypatch.setattr(kernels_warp, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("need_dimg", [False, True], ids=["dflow", "dimg"])
@pytest.mark.parametrize(
    "dtype, flow_dtype, code",
    [("float32", "float32", 0), ("bfloat16", "bfloat16", 1), ("bfloat16", "float32", 2)],
    ids=["f32", "bf16", "bf16_img_f32_flow"],
)
@pytest.mark.parametrize("shape", [BACKWARD2D_SHAPES[i] for i in (0, 2, 5, 10, 17, 18)], ids=str)
def test_warp2d_backward_launches_on_backward_geometry(_recorded_backward2d, shape, dtype,
                                                      flow_dtype, code, need_dimg):
    """One launch a call, on ``backward_geometry``'s grid, block and groups;
    the flow a slice of a channels-last 4-channel flow and g channels-last,
    both read through their strides; ``dflow`` in the flow's type, ``dimg``
    in the image's."""
    dt, ft = getattr(torch, dtype), getattr(torch, flow_dtype)
    b, c, h, w = shape
    img = torch.empty(shape, dtype=dt, device="meta")
    flow4 = torch.empty((b, 4, h, w), dtype=ft, device="meta").contiguous(
        memory_format=torch.channels_last)
    flow = flow4[:, 2:4]
    g = torch.empty(shape, dtype=dt, device="meta").contiguous(memory_format=torch.channels_last)
    before = dict(LAUNCHES)
    dimg, dflow = _launch_backward(img, flow, g, 0, "zeros", need_dimg)
    assert LAUNCHES["warp2d_bwd"] == before["warp2d_bwd"] + 1
    (args,) = _recorded_backward2d
    launch = backward_geometry(shape)
    assert tuple(args[-7:-1]) == launch.grid + launch.block + (launch.groups,)
    assert tuple(args[5:9]) == shape
    assert tuple(args[9:13]) == flow.stride() and tuple(args[13:17]) == g.stride()
    assert tuple(args[17:20]) == (0, 1, code)
    assert dflow.shape == (b, 2, h, w) and dflow.dtype == ft
    assert (dimg is not None) == need_dimg and (args[4] is not None) == need_dimg
    if need_dimg:
        assert dimg.shape == shape and dimg.dtype == dt


@pytest.mark.parametrize("shape", [(1, 1, 46341, 46341), (1, 2, 2**31, 1), (1, 1, 1, 2**31)],
                         ids=str)
def test_warp2d_backward_refuses_2_31_elements_a_plane_before_allocating(monkeypatch, shape):
    """A plane that 32-bit offsets cannot address raises ``ValueError``
    before any buffer is made or the library is asked for; nothing counts
    as launched."""

    def refuse(*args, **kwargs):
        raise AssertionError("allocated or built before refusing")

    b, _, h, w = shape
    img = torch.empty(shape, device="meta")
    flow = torch.empty((b, 2, h, w), device="meta")
    monkeypatch.setattr(kernels_warp, "_library", refuse)
    monkeypatch.setattr(torch, "empty", refuse)
    monkeypatch.setattr(torch, "zeros", refuse)
    before = dict(LAUNCHES)
    for need_dimg in (False, True):
        with pytest.raises(ValueError, match="32-bit"):
            _launch_backward(img, flow, img, 0, "zeros", need_dimg)
    assert LAUNCHES == before
