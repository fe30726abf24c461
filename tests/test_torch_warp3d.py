"""PyTorch port: the plain trilinear warp (the plain version of the Hopper
``warp3d`` kernels) against the JAX package's slab warp and gather warp,
values and gradients, and the trilinear resize and the 3-D Laplacian loss.

Volumes 12x16x20, ``r_z = 4`` (the slab scans 2*r_z+3 taps, which is what
makes these the slow cases on the CPU).  Inputs are drawn with numpy from
fixed seeds.  On the CPU the JAX slab warp clips ``flow_z`` only; where a
case bounds the in-plane flow too, the test clips (dy, dx) itself before it
hands the flow to the slab.

Tolerances: values 1e-5 (8 corner terms against 2*r_z+3 taps of 4, float32,
in other orders); gradients 1e-4 absolute on sum(out²) with out in [0, 1]
(the image gradient sums a few dozen contributions per source voxel in
another order).  Gradient cases keep the flows off integers and off the
bounds: the slab's hat weight ``max(0, 1-|fz-s|)`` and ``jnp.clip`` pick
other subgradients at those points than a floor-based gather.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowscivis_tpu.ops import pyramid as jp
from opticalflowscivis_tpu.ops import resize as jresize
from opticalflowscivis_tpu.ops.warp import backward_warp as jax_backward_warp
from opticalflowscivis_tpu.ops.warp import backward_warp3d_slab
from opticalflowscivis_tpu_torch.ops import pyramid as tp
from opticalflowscivis_tpu_torch.ops import resize as tresize
from opticalflowscivis_tpu_torch.ops import warp as tw
from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
from opticalflowscivis_tpu_torch.ops.kernels.warp import warp3d

VAL_TOL = 1e-5
GRAD_TOL = 1e-4
R_Z = 4
SHAPE = (2, 12, 16, 20)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small torch ops; with several test workers on one
    machine the intra-op thread pools oversubscribe the cores and such loops
    slow down a hundredfold.  One thread per worker is the fastest setting."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, c, scale=3.0, off_integer=False):
    """Volume in [0, 1] and a (dz, dy, dx) flow, a good share of it beyond ±R_Z."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, SHAPE + (c,)).astype(np.float32)
    flow = rng.standard_normal(SHAPE + (3,)) * scale
    if off_integer:  # multiples of 1/2 plus 0.21: never an integer, never ±R_Z
        flow = np.round(flow * 2) / 2 + 0.21
    return img, flow.astype(np.float32)


def _cf(x):
    """Channels-last numpy → channels-first tensor."""
    return torch.from_numpy(x).movedim(-1, 1).contiguous()


def _cl(t):
    return t.detach().movedim(1, -1).numpy()


@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_warp3d_plain_matches_the_slab_warp(padding, c):
    img, flow = _inputs(1 + c, c)
    assert (np.abs(flow[..., 0]) > R_Z).any()
    ref = backward_warp3d_slab(jnp.asarray(img), jnp.asarray(flow), r_z=R_Z, padding=padding)
    out = tw.warp3d_plain(_cf(img), _cf(flow), R_Z, 0, padding)
    np.testing.assert_allclose(_cl(out), np.asarray(ref), atol=VAL_TOL)


@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_warp3d_plain_matches_the_gather_warp_on_a_preclipped_flow(padding):
    """The function of the slab warp: clip ``flow_z``, then one 8-corner gather."""
    img, flow = _inputs(5, 2)
    clipped = flow.copy()
    clipped[..., 0] = np.clip(flow[..., 0], -R_Z, R_Z)
    ref = jax_backward_warp(jnp.asarray(img), jnp.asarray(clipped), padding=padding)
    out = tw.warp3d_plain(_cf(img), _cf(flow), R_Z, 0, padding)
    np.testing.assert_allclose(_cl(out), np.asarray(ref), atol=VAL_TOL)
    # and unbounded, through the channels-last public functions
    free = jax_backward_warp(jnp.asarray(img), jnp.asarray(flow), padding=padding)
    out = tw.backward_warp(torch.from_numpy(img), torch.from_numpy(flow), padding)
    np.testing.assert_allclose(out.numpy(), np.asarray(free), atol=VAL_TOL)
    out = tw.warp3d_plain(_cf(img), _cf(flow), 0, 0, padding)
    np.testing.assert_allclose(_cl(out), np.asarray(free), atol=VAL_TOL)


@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_warp3d_plain_in_plane_clip_matches_the_slab_on_a_clipped_flow(padding):
    """``r_yx`` is the bounded 2-D kernel's clip of each z-tap on the TPU path."""
    r_yx = 2
    img, flow = _inputs(6, 1)
    assert (np.abs(flow[..., 1:]) > r_yx).any()
    clipped = flow.copy()
    clipped[..., 1:] = np.clip(flow[..., 1:], -r_yx, r_yx)
    ref = backward_warp3d_slab(jnp.asarray(img), jnp.asarray(clipped), r_z=R_Z, padding=padding)
    out = tw.warp3d_plain(_cf(img), _cf(flow), R_Z, r_yx, padding)
    np.testing.assert_allclose(_cl(out), np.asarray(ref), atol=VAL_TOL)
    assert np.abs(_cl(tw.warp3d_plain(_cf(img), _cf(flow), R_Z, 0, padding))
                  - np.asarray(ref)).max() > 1e-2  # the in-plane clip is not a no-op


def test_multilinear_sample_mask_matches_jax_in_3d():
    img, flow = _inputs(7, 1)
    ref, ref_mask = jax_backward_warp(jnp.asarray(img), jnp.asarray(flow), padding="zeros",
                                      return_mask=True)
    out, mask = tw.backward_warp(torch.from_numpy(img), torch.from_numpy(flow), "zeros",
                                 return_mask=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=VAL_TOL)
    np.testing.assert_allclose(mask.numpy(), np.asarray(ref_mask), atol=VAL_TOL)
    assert mask.shape == SHAPE + (1,)


def _torch_grads(fn, img, flow):
    ti = _cf(img).requires_grad_()
    tf = _cf(flow).requires_grad_()
    (fn(ti, tf) ** 2).sum().backward()
    return _cl(ti.grad), _cl(tf.grad)


@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_warp3d_plain_grads_match_the_slab_warp(padding, c):
    img, flow = _inputs(10 + c, c, off_integer=True)
    assert (np.abs(flow[..., 0]) > R_Z).any()
    gi_ref, gf_ref = jax.grad(
        lambda v, f: jnp.sum(backward_warp3d_slab(v, f, r_z=R_Z, padding=padding) ** 2), (0, 1)
    )(jnp.asarray(img), jnp.asarray(flow))
    gi, gf = _torch_grads(lambda i, f: tw.warp3d_plain(i, f, R_Z, 0, padding), img, flow)
    np.testing.assert_allclose(gi, np.asarray(gi_ref), atol=GRAD_TOL)
    np.testing.assert_allclose(gf, np.asarray(gf_ref), atol=GRAD_TOL)
    clamped = np.abs(flow[..., 0]) >= R_Z
    assert (gf[..., 0][clamped] == 0).all() and (gf[..., 0][~clamped] != 0).any()


def test_flow_exactly_on_a_bound_gets_no_gradient():
    """The port's rule: a component on ±r is clamped, and carries no gradient
    just as beyond it (each component by its own radius)."""
    img, flow = _inputs(14, 1, off_integer=True)
    flow[:, :4, :, :, 0] = R_Z
    flow[:, 4:8, :, :, 1] = -2.0
    flow[:, 8:, :, :, 2] = 2.0
    _, gf = _torch_grads(lambda i, f: tw.warp3d_plain(i, f, R_Z, 2, "border"), img, flow)
    assert (gf[:, :4, :, :, 0] == 0).all()
    assert (gf[:, 4:8, :, :, 1] == 0).all()
    assert (gf[:, 8:, :, :, 2] == 0).all()
    inside = (np.abs(flow[..., 0]) < R_Z)
    assert (gf[..., 0][inside] != 0).any()
    # with the radii at 0 the same flows do carry gradients
    _, free = _torch_grads(lambda i, f: tw.warp3d_plain(i, f, 0, 0, "border"), img, flow)
    assert (free[:, 4:8, :, :, 1] != 0).any()


@pytest.mark.parametrize("layout", ["slice", "channels_last_3d"])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_warp3d_on_cpu_runs_the_plain_version_on_strided_flows(padding, layout):
    """On CPU tensors the wrapper launches nothing, reads a channel slice of a
    6-channel flow in either memory layout, and backpropagates through the
    plain version."""
    img, flow = _inputs(15, 2, off_integer=True)
    flow6 = _cf(np.concatenate([flow * 0.5, flow], axis=-1))
    if layout == "channels_last_3d":
        flow6 = flow6.contiguous(memory_format=torch.channels_last_3d)
    flow6.requires_grad_()
    ti = _cf(img).requires_grad_()
    before = dict(LAUNCHES)
    out = warp3d(ti, flow6[:, 3:], R_Z, 2, padding)
    (out ** 2).sum().backward()
    assert LAUNCHES == before
    ref = tw.warp3d_plain(_cf(img), _cf(flow), R_Z, 2, padding)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), atol=0)
    gi, gf = _torch_grads(lambda i, f: tw.warp3d_plain(i, f, R_Z, 2, padding), img, flow)
    np.testing.assert_allclose(_cl(ti.grad), gi, atol=0)
    np.testing.assert_allclose(_cl(flow6.grad[:, 3:]), gf, atol=1e-7)
    assert (flow6.grad[:, :3] == 0).all()


@pytest.mark.parametrize(
    "kwargs, error",
    [
        ({"padding": "reflect"}, ValueError),
        ({"r_z": -1}, ValueError),
        ({"r_yx": 1.5}, ValueError),
        ({"flow_shape": (2, 2, 4, 5, 6)}, ValueError),
        ({"flow_shape": (2, 3, 4, 5, 7)}, ValueError),
        ({"img_shape": (2, 1, 5, 6)}, ValueError),
        ({"img_device": "meta"}, ValueError),
    ],
    ids=["padding", "negative_r_z", "float_r_yx", "flow_channels", "flow_size", "rank", "device"],
)
def test_warp3d_rejects_what_it_does_not_take(kwargs, error):
    img = torch.zeros(kwargs.get("img_shape", (2, 1, 4, 5, 6)),
                      device=kwargs.get("img_device", "cpu"))
    flow = torch.zeros(kwargs.get("flow_shape", (2, 3, 4, 5, 6)), device=img.device)
    with pytest.raises(error):
        warp3d(img, flow, kwargs.get("r_z", 4), kwargs.get("r_yx", 4),
               kwargs.get("padding", "border"))


def test_warp3d_kernel_argument_checks_refuse_mixed_types_and_layouts():
    """What the CUDA path checks before a launch, on tensors that need no card."""
    from opticalflowscivis_tpu_torch.ops.kernels.warp import _check_cuda_args

    img = torch.zeros(1, 1, 4, 4, 4)
    with pytest.raises(TypeError, match="warp3d"):
        _check_cuda_args(img, torch.zeros(1, 3, 4, 4, 4, dtype=torch.bfloat16), "warp3d")
    with pytest.raises(TypeError):
        _check_cuda_args(img.double(), torch.zeros(1, 3, 4, 4, 4).double(), "warp3d")
    with pytest.raises(ValueError, match="contiguous"):
        _check_cuda_args(torch.zeros(1, 4, 4, 4, 2).movedim(-1, 1), torch.zeros(1, 3, 4, 4, 4),
                         "warp3d")
    with pytest.raises(ValueError, match="empty"):
        _check_cuda_args(torch.zeros(0, 1, 4, 4, 4), torch.zeros(0, 3, 4, 4, 4), "warp3d")


# -- resize and pyramid on volumes ------------------------------------------------

SIZES_3D = {"down4": (4, 4, 5), "down_odd": (5, 7, 9), "up4": (64, 64, 80), "up_odd": (19, 21, 33)}


@pytest.mark.parametrize("target", sorted(SIZES_3D))
def test_trilinear_resize_matches_jax(target):
    """1e-6: both sides interpolate between 2 taps per axis in float32."""
    x = np.random.default_rng(20).uniform(0, 1, (2, 16, 16, 20, 2)).astype(np.float32)
    ref = jresize.resize_spatial(jnp.asarray(x), SIZES_3D[target])
    out = tresize.resize_spatial(torch.from_numpy(x), SIZES_3D[target])
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    out = tresize.resize_nchw(torch.from_numpy(x).movedim(-1, 1), SIZES_3D[target])
    np.testing.assert_allclose(out.movedim(1, -1).numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("target", sorted(SIZES_3D))
def test_trilinear_resize_flow_matches_jax(target):
    """Three ratios, tiled over the 6 channels of a stacked flow (1e-5: the
    values are scaled by up to 4 after the resize)."""
    f = np.random.default_rng(21).standard_normal((2, 16, 16, 20, 6)).astype(np.float32)
    ref = jresize.resize_flow(jnp.asarray(f), SIZES_3D[target])
    out = tresize.resize_flow(torch.from_numpy(f), SIZES_3D[target])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    out = tresize.resize_flow_nchw(torch.from_numpy(f).movedim(-1, 1), SIZES_3D[target])
    np.testing.assert_allclose(out.movedim(1, -1).numpy(), np.asarray(ref), atol=1e-5)


def test_resize_rejects_mismatched_ranks():
    with pytest.raises(ValueError):
        tresize.resize_nchw(torch.zeros(1, 1, 8, 8, 8), (4, 4))
    with pytest.raises(ValueError):
        tresize.resize_flow_nchw(torch.zeros(1, 4, 8, 8, 8), (4, 4, 4))


@pytest.mark.parametrize("shape", [(2, 16, 16, 16, 1), (1, 9, 12, 11, 2)], ids=["even", "odd"])
def test_lap_loss_matches_jax_in_3d(shape):
    """Value (rtol 1e-5) and input gradients (1e-5 of the largest) of the
    Laplacian-pyramid loss on volumes: the upsample gain is 8."""
    rng = np.random.default_rng(22)
    a, b = (rng.uniform(0, 1, shape).astype(np.float32) for _ in range(2))
    ref, grads = jax.value_and_grad(jp.lap_loss, (0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    out = tp.lap_loss(ta, tb)
    assert float(out.detach()) == pytest.approx(float(ref), rel=1e-5)
    out.backward()
    for leaf, g in zip((ta, tb), grads):
        g = np.asarray(g)
        np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=1e-5, atol=1e-5 * np.abs(g).max())
    pyr = tp.laplacian_pyramid(torch.from_numpy(a), 3)
    for o, r in zip(pyr, jp.laplacian_pyramid(jnp.asarray(a), 3)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)
    np.testing.assert_allclose(tp.gaussian_blur(torch.from_numpy(a), 2.0).numpy(),
                               np.asarray(jp.gaussian_blur(jnp.asarray(a), 2.0)), atol=1e-6)
