"""PyTorch port: the cost-volume kernels' launch geometry and their tiled
algorithms, on the CPU.

``ops.kernels.correlation.forward_launch`` decides every launch of
``corr_forward``: a grid of (x tiles of 32 columns, row tiles of 16 rows, or
of 1 row where 16-row tiles would give fewer than 66 blocks, samples x
groups of 3 row offsets), 128 threads, and a ring of 3 channel stages in
shared memory.  The tests below hold it at UPFlow's five levels, at odd
shapes and at the limits, and replay the forward block by block in numpy
(the staged tile and window, the 16 channel groups of a 1-row tile added in
order) against ``cost_volume_plain``.

``ops.kernels.correlation.backward_launch`` decides every launch of
``corr_backward`` (``csrc/corr.cu``) from the features' shape, ``max_disp``
and the number of gradients asked for: a grid of (x tiles of 16 columns, row
tiles of 8 rows, gradients x samples x slabs of 32 channels), 128 threads,
and dynamic shared memory that depends on ``max_disp`` alone.  These tests
hold it at the shapes UPFlow gives the kernel, at odd ones and at the limits,
and replay the kernel's algorithm block by block in numpy (the window staged
once, the coefficient planes of one row offset at a time, ``df2``'s through
the flip ``k = D - 1 - e`` and the shift applied at staging) against autograd
through ``cost_volume_plain``.  The kernel itself runs in the ``cuda``-marked
cases of ``tests/test_torch_kernels.py`` and in ``chip_smoke.py``, which also
holds ``backward_launch`` against the launch the built kernel reports.
"""

import numpy as np
import pytest
import torch

from opticalflowscivis_tpu_torch.ops.correlation import cost_volume_plain
from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
from opticalflowscivis_tpu_torch.ops.kernels.correlation import (
    _launch,
    _launch_backward,
    backward_launch,
    backward_shared_bytes,
    forward_launch,
    forward_shared_bytes,
)

ROWS, COLS, SLAB, THREADS = 8, 16, 32, 128
SHARED_LIMIT = 227 * 1024  # bytes one block may hold on Hopper
# [B, C, H, W] of UPFlow's five cost volumes at 256 x 832, batch 8, both directions
UPFLOW_SHAPES = [(16, 196, 4, 13), (16, 128, 8, 26), (16, 96, 16, 52), (16, 64, 32, 104),
                 (16, 32, 64, 208)]
ODD_SHAPES = [(1, 1, 1, 1), (2, 7, 11, 13), (3, 45, 11, 13), (1, 33, 9, 17), (2, 8, 17, 31),
              (1, 200, 3, 250), (5, 64, 65, 16), (1, 3, 129, 5)]
# feature widths of UPFlow's pyramid (16 .. 196): every C its cost volumes take
MODEL_CHANNELS = (16, 32, 64, 96, 128, 196)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers side by side: a few threads each keep
    the many small ops of these tests from fighting over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _covers(shape, launch, copies):
    """Every pixel, channel and gradient is some block's, no block lies wholly
    past an edge, and the grid is within CUDA's limits."""
    b, c, h, w = shape
    gx, gy, gz = launch.grid
    slabs = gz // (b * copies)
    return (gx * COLS >= w > (gx - 1) * COLS and gy * ROWS >= h > (gy - 1) * ROWS
            and gz == b * copies * slabs and slabs * SLAB >= c > (slabs - 1) * SLAB
            and launch.threads == THREADS and gx < 2**31 and gy <= 65535 and gz <= 65535)


@pytest.mark.parametrize(
    "shape, grid",
    [
        ((16, 196, 4, 13), (1, 1, 224)),  # coarsest level: 7 slabs of 32 channels
        ((16, 128, 8, 26), (2, 1, 128)),
        ((16, 96, 16, 52), (4, 2, 96)),
        ((16, 64, 32, 104), (7, 4, 64)),
        ((16, 32, 64, 208), (13, 8, 32)),  # finest level: one slab
    ],
)
def test_backward_launch_at_upflows_five_levels(shape, grid):
    launch = backward_launch(shape, 4)
    assert launch.grid == grid and launch.threads == THREADS
    assert launch.shared_bytes == backward_shared_bytes(4) == 60416
    assert _covers(shape, launch, 2)
    one = backward_launch(shape, 4, copies=1)
    assert one.grid == grid[:2] + (grid[2] // 2,) and _covers(shape, one, 1)


def test_backward_launch_covers_every_pixel_channel_and_gradient():
    for shape in ODD_SHAPES + UPFLOW_SHAPES:
        for copies in (1, 2):
            for md in (1, 2, 3, 4):
                launch = backward_launch(shape, md, copies)
                assert _covers(shape, launch, copies), (shape, md, copies)
                assert launch.shared_bytes == backward_shared_bytes(md)


@pytest.mark.parametrize("md", [1, 2, 3, 4])
def test_backward_shared_memory_stays_within_the_budget(md):
    """The slab is 32 channels whatever C is, so the budget depends on md
    alone; every C of the model and md 1-4 fit, with room for three blocks
    an SM at md 4."""
    nbytes = backward_shared_bytes(md)
    assert nbytes <= SHARED_LIMIT and 3 * nbytes <= 228 * 1024 - 3 * 1024
    for c in MODEL_CHANNELS:
        assert backward_launch((16, c, 64, 208), md).shared_bytes == nbytes
    # the window's rows and the channel stride keep float4 loads aligned and
    # neighbouring channels 16 banks apart
    wh, ww4 = ROWS + 2 * md, -(-(COLS + 2 * md) // 4) * 4
    window_floats = nbytes // 4 - 2 * (2 * md + 1) * ROWS * COLS
    stride = window_floats // SLAB
    assert window_floats == SLAB * stride and stride >= wh * ww4
    assert stride % 4 == 0 and stride % 32 == 16


@pytest.mark.parametrize(
    "shape, md, copies",
    [
        ((1, 1, 65535 * 8 + 1, 4), 4, 2),  # row tiles beyond the grid's y limit
        ((32768, 32, 8, 16), 4, 2),  # 32768 samples x 2 gradients: z beyond 65535
        ((65536, 32, 8, 16), 4, 1),
        ((2, 65535 * 32, 2, 2), 2, 1),  # 65535 slabs x 2 samples
        ((1, 4, 8, 8), 15, 2),  # the window of md 15 exceeds 227 KB
        ((1, 4, 8, 8), 5, 2),  # within the budget, but not a built max_disp
        ((1, 4, 8, 8), 0, 2),
        ((1, 4, 8, 8), 4, 3),
        ((1, 0, 8, 8), 4, 2),
        ((4, 8, 8), 4, 2),
    ],
)
def test_backward_launch_refuses_what_the_kernel_cannot_take(shape, md, copies):
    """By shape alone: no tensor of that size is made."""
    with pytest.raises(ValueError):
        backward_launch(shape, md, copies)


def test_backward_launch_takes_the_largest_grid():
    launch = backward_launch((1, 1, 65535 * 8, 4), 4, 2)
    assert launch.grid == (1, 65535, 2)
    assert backward_launch((32767, 32, 8, 16), 4, 2).grid[2] == 65534
    assert backward_shared_bytes(14) == 232448  # the largest md whose window fits


@pytest.mark.parametrize(
    "shape, need", [((1, 1, 65535 * 8 + 1, 4), (True, True)), ((40000, 32, 8, 16), (True, True)),
                    ((70000, 32, 8, 16), (False, True))],
)
def test_wrapper_refuses_before_allocating_or_launching(shape, need):
    """``_launch_backward`` asks ``backward_launch`` first: on meta tensors
    (no memory, no device) a shape beyond the grid raises ``ValueError`` and
    counts no launch."""
    b, _, h, w = shape
    f1 = torch.empty(shape, device="meta")
    g = torch.empty((b, 81, h, w), device="meta")
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="grid"):
        _launch_backward(f1, f1, g, 4, *need)
    assert LAUNCHES == before


def _replay_backward(f1, f2, g, md, need):
    """The kernel's algorithm, block by block, in float64: per block the
    slab's window of the other map (zero outside the plane), then for each
    row offset ey the coefficient planes a[ey, ex] over the tile (df1: g at
    the tile's pixels; df2: g[D-1-e] shifted by (ey-md, ex-md), zero outside),
    summed against the window row shifted by ex.  Returns each gradient and
    how often each of its elements was written."""
    b_, c_, h, w = f1.shape
    nd = 2 * md + 1
    copies = [which for which, n in enumerate(need) if n]
    launch = backward_launch(f1.shape, md, len(copies))
    gx, gy, gz = launch.grid
    slabs = gz // (b_ * len(copies))
    out = {which: np.zeros(f1.shape) for which in copies}
    writes = {which: np.zeros(f1.shape, dtype=int) for which in copies}

    def window(src, c0, y0, x0):
        buf = np.zeros((SLAB, ROWS + 2 * md, COLS + 2 * md))
        cs = np.arange(c0, c0 + SLAB)[:, None, None]
        ys = np.arange(y0 - md, y0 + ROWS + md)[None, :, None]
        xs = np.arange(x0 - md, x0 + COLS + md)[None, None, :]
        ok = (cs < c_) & (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        cs, ys, xs = np.broadcast_arrays(cs, ys, xs)
        buf[ok] = src[cs[ok], ys[ok], xs[ok]]
        return buf

    rows = np.arange(ROWS)[:, None]
    cols = np.arange(COLS)[None, :]
    for z in range(gz):
        r = z // slabs
        b, c0, which = r % b_, (z % slabs) * SLAB, copies[0] + r // b_
        src = (f2 if which == 0 else f1)[b]
        for by in range(gy):
            for bx in range(gx):
                y0, x0 = by * ROWS, bx * COLS
                win = window(src, c0, y0, x0)
                acc = np.zeros((SLAB, ROWS, COLS))
                for ey in range(nd):
                    for ex in range(nd):
                        if which == 0:
                            k, yy, xx = ey * nd + ex, y0 + rows, x0 + cols
                        else:
                            k, yy, xx = nd * nd - 1 - (ey * nd + ex), y0 + rows + ey - md, x0 + cols + ex - md
                        yy, xx = np.broadcast_arrays(yy, xx)
                        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                        a = np.zeros((ROWS, COLS))
                        a[ok] = g[b, k][yy[ok], xx[ok]]
                        acc += a[None] * win[:, ey:ey + ROWS, ex:ex + COLS]
                nc, nh, nw = min(SLAB, c_ - c0), min(ROWS, h - y0), min(COLS, w - x0)
                out[which][b, c0:c0 + nc, y0:y0 + nh, x0:x0 + nw] = acc[:nc, :nh, :nw] / c_
                writes[which][b, c0:c0 + nc, y0:y0 + nh, x0:x0 + nw] += 1
    return out, writes


def _plain_grads(f1, f2, g, md, need):
    a = torch.from_numpy(f1).requires_grad_(need[0])
    b = torch.from_numpy(f2).requires_grad_(need[1])
    cost_volume_plain(a, b, md).backward(torch.from_numpy(g))
    return {0: a.grad, 1: b.grad}


def test_replayed_tiles_match_autograd_through_the_plain_version():
    """Tiles cut on both axes, channels beyond one slab and not a multiple of
    8, planes narrower than the window, md 1-4: each element written once,
    both gradients equal to autograd's to float64 rounding.  Then each
    gradient alone: the grid holds one copy, and ``first`` picks which."""
    cases = [(shape, md, (True, True)) for shape in ((2, 7, 11, 13), (1, 45, 9, 19), (2, 33, 17, 5))
             for md in (1, 2, 3, 4)]
    cases += [((2, 40, 10, 21), 3, (True, False)), ((2, 40, 10, 21), 3, (False, True))]
    for shape, md, need in cases:
        rng = np.random.default_rng(17 * md + shape[1])
        f1, f2 = rng.standard_normal(shape), rng.standard_normal(shape)
        g = rng.standard_normal((shape[0], (2 * md + 1) ** 2) + shape[2:])
        got, writes = _replay_backward(f1, f2, g, md, need)
        want = _plain_grads(f1, f2, g, md, need)
        assert list(got) == [which for which in (0, 1) if need[which]], (shape, md, need)
        for which in got:
            ref = want[which].numpy()
            assert (writes[which] == 1).all(), (shape, md, need)
            np.testing.assert_allclose(got[which], ref, rtol=0, atol=1e-12 * np.abs(ref).max(),
                                       err_msg=str((shape, md, need, which)))


# -- forward ------------------------------------------------------------------------

FWD_COLS, FWD_DY, FWD_THREADS = 32, 3, 128
SM_SHARED = 228 * 1024  # shared memory of one SM; each block reserves 1 KB more


def _fwd_covers(shape, md, launch):
    """Every pixel and every row offset is some block's, no block lies wholly
    past an edge, and the grid is within CUDA's limits."""
    b, _, h, w = shape
    gx, gy, gz = launch.grid
    rows, groups = launch.tile_rows, gz // b
    return (gx * FWD_COLS >= w > (gx - 1) * FWD_COLS and gy * rows >= h > (gy - 1) * rows
            and gz == b * groups and groups * FWD_DY >= 2 * md + 1 > (groups - 1) * FWD_DY
            and launch.threads == FWD_THREADS and gx < 2**31 and gy <= 65535 and gz <= 65535)


@pytest.mark.parametrize(
    "shape, grid, rows",
    [
        ((16, 196, 4, 13), (1, 4, 48), 1),  # 16-row tiles would give 48 blocks: 192 of 1 row
        ((16, 128, 8, 26), (1, 8, 48), 1),
        ((16, 96, 16, 52), (2, 1, 48), 16),  # 96 blocks of 16 rows
        ((16, 64, 32, 104), (4, 2, 48), 16),
        ((16, 32, 64, 208), (7, 4, 48), 16),  # finest level: 1344 blocks
    ],
)
def test_forward_launch_at_upflows_five_levels(shape, grid, rows):
    for bf16, elem in ((False, 4), (True, 2)):
        launch = forward_launch(shape, 4, bf16)
        assert launch.grid == grid and launch.tile_rows == rows and launch.threads == FWD_THREADS
        assert launch.shared_bytes == forward_shared_bytes(4, rows, elem)
        assert _fwd_covers(shape, 4, launch)
        # 16-row tiles busy at least half of the 132 SMs; else one block a row
        blocks = grid[0] * grid[1] * grid[2]
        assert blocks >= 66 if rows == 16 else grid[1] == shape[2] and blocks >= 132


def test_forward_launch_covers_every_pixel_and_displacement():
    for shape in ODD_SHAPES + UPFLOW_SHAPES + [(22, 3, 16, 32), (21, 3, 16, 32)]:
        for md in (1, 2, 3, 4):
            for bf16 in (False, True):
                launch = forward_launch(shape, md, bf16)
                assert _fwd_covers(shape, md, launch), (shape, md, bf16)
                assert launch.shared_bytes == forward_shared_bytes(
                    md, launch.tile_rows, 2 if bf16 else 4)
    # the tile's rows switch at exactly 66 blocks of 16 rows
    assert forward_launch((22, 3, 16, 32), 4).tile_rows == 16
    assert forward_launch((21, 3, 16, 32), 4).tile_rows == 1


@pytest.mark.parametrize("md", [1, 2, 3, 4])
def test_forward_shared_memory_stays_within_the_budget(md):
    """The ring depends on md, the tile and the element size, never on C or
    the plane: every case fits three blocks an SM (the registers' limit),
    and a 1-row tile holds its 16 groups' sums."""
    for rows in (16, 1):
        for elem in (4, 2):
            nbytes = forward_shared_bytes(md, rows, elem)
            assert nbytes <= SHARED_LIMIT and 3 * (nbytes + 1024) <= SM_SHARED, (rows, elem)
            if rows == 1:
                assert nbytes >= FWD_THREADS * FWD_DY * (2 * md + 1) * 16
    assert forward_shared_bytes(4, 16, 4) == 59136 and forward_shared_bytes(4, 16, 2) == 29568
    for c in MODEL_CHANNELS:
        assert forward_launch((16, c, 64, 208), md).shared_bytes == forward_shared_bytes(md, 16, 4)


@pytest.mark.parametrize(
    "shape, md",
    [
        ((1, 1, 65535 * 16 + 1, 4), 4),  # row tiles of 16 beyond the grid's y limit
        ((21846, 32, 8, 16), 4),  # 21846 samples x 3 dy groups: z beyond 65535
        ((65536, 4, 8, 8), 1),
        ((1, 4, 8, 8), 5),  # not a built max_disp
        ((1, 4, 8, 8), 0),
        ((1, 0, 8, 8), 4),
        ((4, 8, 8), 4),
    ],
)
def test_forward_launch_refuses_what_the_kernel_cannot_take(shape, md):
    """By shape alone: no tensor of that size is made."""
    with pytest.raises(ValueError):
        forward_launch(shape, md)


def test_forward_launch_takes_the_largest_grid():
    assert forward_launch((21845, 32, 8, 16), 4).grid == (1, 1, 65535)
    assert forward_launch((1, 1, 65535 * 16, 4), 4).grid == (1, 65535, 3)
    # 1-row tiles only where 16-row tiles give few blocks: far inside the limits
    assert forward_launch((1, 1, 65535, 4), 4).tile_rows == 16


@pytest.mark.parametrize("shape", [(1, 1, 65535 * 16 + 1, 4), (21846, 32, 8, 16)])
def test_forward_wrapper_refuses_before_allocating_or_launching(shape):
    """``_launch`` asks ``forward_launch`` first: on meta tensors (no memory,
    no device) a shape beyond the grid raises ``ValueError`` and counts no
    launch."""
    f1 = torch.empty(shape, device="meta")
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="grid"):
        _launch(f1, f1, 4)
    assert LAUNCHES == before


def _replay_forward(f1, f2, md, rows):
    """The forward's algorithm, block by block, in float64, with tiles of
    ``rows`` rows: per block f1's tile and f2's window (zero outside the
    plane and beyond C) staged a stage of channels at a time, each channel
    group summing its share of every stage for the block's 3 row offsets,
    the groups added in order.  Returns the volume and how often each of its
    elements was written."""
    b_, c_, h, w = f1.shape
    nd = 2 * md + 1
    groups_dy = -(-nd // FWD_DY)
    k = FWD_THREADS // (FWD_COLS // 4 * rows)  # channel groups
    cs = 4 if rows == 16 else 32  # channels a stage
    cpg = cs // k
    nst = -(-c_ // cs)
    cpad = nst * cs
    out = np.zeros((b_, nd * nd, h, w))
    writes = np.zeros(out.shape, dtype=int)
    pad = np.zeros((b_, cpad, h + 2 * (rows + nd), w + 2 * (FWD_COLS + md)))
    oy, ox = rows + nd, FWD_COLS + md  # where the plane starts inside `pad`
    p1, p2 = pad.copy(), pad.copy()
    p1[:, :c_, oy:oy + h, ox:ox + w] = f1
    p2[:, :c_, oy:oy + h, ox:ox + w] = f2
    for z in range(b_ * groups_dy):
        b, d0 = z // groups_dy, (z % groups_dy) * FWD_DY
        for y0 in range(0, h, rows):
            for x0 in range(0, w, FWD_COLS):
                tile = p1[b, :, oy + y0:oy + y0 + rows, ox + x0:ox + x0 + FWD_COLS]
                wy, wx = oy + y0 + d0 - md, ox + x0 - md
                win = p2[b, :, wy:wy + rows + FWD_DY - 1, wx:wx + FWD_COLS + 2 * md]
                acc = np.zeros((k, FWD_DY, nd, rows, FWD_COLS))
                for st in range(nst):
                    for g in range(k):
                        for i in range(cpg):
                            c = st * cs + g * cpg + i
                            for j in range(FWD_DY):
                                for dx in range(nd):
                                    acc[g, j, dx] += tile[c] * win[c, j:j + rows, dx:dx + FWD_COLS]
                total = acc[0]
                for g in range(1, k):
                    total = total + acc[g]
                nh, nw = min(rows, h - y0), min(FWD_COLS, w - x0)
                for j in range(FWD_DY):
                    if d0 + j >= nd:
                        continue
                    for dx in range(nd):
                        ch = (d0 + j) * nd + dx
                        out[b, ch, y0:y0 + nh, x0:x0 + nw] = total[j, dx, :nh, :nw] / c_
                        writes[b, ch, y0:y0 + nh, x0:x0 + nw] += 1
    return out, writes


def test_replayed_forward_tiles_match_the_plain_version():
    """Tiles cut on both axes, channels beyond one stage and not a multiple
    of it, planes narrower than the window, md 1-4 (row-offset groups cut at
    md 2 and 3), both tile heights: each element written once, equal to
    ``cost_volume_plain`` to float64 rounding."""
    cases = [((2, 7, 11, 13), md, rows) for md in (1, 2, 3, 4) for rows in (16, 1)]
    cases += [((1, 45, 19, 37), 4, 16), ((1, 45, 3, 37), 3, 1), ((2, 33, 17, 5), 2, 16)]
    for shape, md, rows in cases:
        rng = np.random.default_rng(31 * md + shape[1] + rows)
        f1, f2 = rng.standard_normal(shape), rng.standard_normal(shape)
        got, writes = _replay_forward(f1, f2, md, rows)
        want = cost_volume_plain(torch.from_numpy(f1), torch.from_numpy(f2), md).numpy()
        assert (writes == 1).all(), (shape, md, rows)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max(),
                                   err_msg=str((shape, md, rows)))
