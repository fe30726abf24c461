"""PyTorch port: the ops UPFlow adds, against the JAX package.

Align-corners and nearest resize, ``upsample_flow_as``, the occlusion check,
the census transform and loss, ``boundary_dilated_warp``, and the route of the
public 2-D warp through the ``warp2d`` wrapper (on the CPU: its plain
version), with the validity mask as a warp of ones.

Tolerances: 1e-5 on values (float32 sums in another order), 1e-4 of the
largest gradient; masks are {0, 1} and must be equal.  The align-corners
resize gets 5e-5: the two packages compute the sampling position in float32
by other formulas (``i * (s - 1) / (d - 1)`` against ``(i + 0.5) / scale +
offset``), positions up to 200 differ by some 1e-5 px, and neighbouring
N(0, 1) samples differ by up to 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowscivis_tpu.ops import census as jcensus
from opticalflowscivis_tpu.ops import resize as jresize
from opticalflowscivis_tpu.ops import warp as jwarp
from opticalflowscivis_tpu.models.upflow import warp_with_mask as jax_warp_with_mask
from opticalflowscivis_tpu.ops.occlusion import occ_check as jax_occ_check
from opticalflowscivis_tpu_torch.ops import census as tcensus
from opticalflowscivis_tpu_torch.ops import resize as tresize
from opticalflowscivis_tpu_torch.ops import warp as twarp
from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d, warp2d_with_mask
from opticalflowscivis_tpu_torch.models.upflow import warp_with_mask
from opticalflowscivis_tpu_torch.ops.occlusion import occ_check

TOL = 1e-5
RESIZE_TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers side by side: a few threads each keep
    the many small ops of these tests from fighting over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- resize ---------------------------------------------------------------------


@pytest.mark.parametrize("src, dst", [
    ((4, 13), (8, 26)), ((16, 52), (64, 208)), ((3, 4), (5, 7)), ((64, 64), (16, 16)),
    ((7, 9), (7, 9)), ((1, 1), (2, 2)), ((1, 2), (3, 2)), ((2, 1), (4, 2)), ((3, 4), (1, 1)),
], ids=["x2", "x4", "odd", "down", "same", "from_1x1", "from_one_row", "from_one_col",
        "to_1x1"])
def test_align_corners_resize_matches_jax(src, dst):
    """Also where an axis has size 1: the reference puts the value at index 0
    and zero beyond (source of size 1) or zero (target of size 1), where
    ``F.interpolate`` repeats the value; the port follows the reference."""
    x = np.random.default_rng(0).standard_normal((2,) + src + (3,)).astype(np.float32)
    ref = np.asarray(jresize.resize_spatial(jnp.asarray(x), dst, align_corners=True))
    out = tresize.resize_spatial(_t(x), dst, align_corners=True)
    np.testing.assert_allclose(out.numpy(), ref, atol=RESIZE_TOL)
    ref_like = np.asarray(jresize.resize_like(jnp.asarray(x), jnp.zeros((2,) + dst + (1,)),
                                              align_corners=True))
    np.testing.assert_allclose(
        tresize.resize_like(_t(x), torch.zeros((2,) + dst + (1,)), align_corners=True).numpy(),
        ref_like, atol=RESIZE_TOL)


@pytest.mark.parametrize("src, dst", [((1, 1), (2, 2)), ((4, 13), (8, 26)), ((64, 64), (16, 20))],
                         ids=["from_1x1", "x2", "down"])
def test_upsample_flow_as_matches_jax_with_its_value_rescale(src, dst):
    """Values scale by target / source size per axis, also from a 1 x 1 plane
    (the coarsest level of a 64 x 64 input)."""
    flow = np.random.default_rng(1).standard_normal((2,) + src + (2,)).astype(np.float32)
    ref = np.asarray(jresize.upsample_flow_as(jnp.asarray(flow), jnp.zeros((2,) + dst + (5,))))
    out = tresize.upsample_flow_as(_t(flow), torch.zeros((2,) + dst + (5,)))
    np.testing.assert_allclose(out.numpy(), ref, atol=RESIZE_TOL)
    nchw = tresize.upsample_flow_as_nchw(_t(flow).movedim(-1, 1), torch.zeros((2, 5) + dst))
    assert torch.equal(nchw.movedim(1, -1), out)
    if src != (1, 1):
        ratio = np.asarray(dst, np.float32) / np.asarray(src, np.float32)
        np.testing.assert_allclose(out.numpy()[:, 0, 0], flow[:, 0, 0] * ratio, atol=RESIZE_TOL)


@pytest.mark.parametrize("src, dst", [((64, 64), (16, 16)), ((12, 8), (3, 4)), ((3, 4), (6, 6)),
                                      ((9, 7), (4, 5))], ids=["down4", "down", "up", "ragged"])
def test_nearest_resize_matches_jax(src, dst):
    x = np.random.default_rng(2).standard_normal((1,) + src + (2,)).astype(np.float32)
    ref = np.asarray(jresize.resize_spatial(jnp.asarray(x), dst, method="nearest"))
    out = tresize.resize_spatial(_t(x), dst, method="nearest")
    np.testing.assert_array_equal(out.numpy(), ref)


def test_resize_rejects_unknown_methods():
    x = torch.zeros(1, 4, 4, 1)
    with pytest.raises(ValueError, match="method"):
        tresize.resize_spatial(x, (8, 8), method="cubic")
    with pytest.raises(ValueError, match="linear"):
        tresize.resize_spatial(x, (8, 8), method="nearest", align_corners=True)


# -- occlusion --------------------------------------------------------------------


@pytest.mark.parametrize("bound_check", [False, True])
def test_occ_check_matches_jax(bound_check):
    """Smooth flows, a consistent pair in the middle (bw = -fw) with an
    inconsistent patch, and flows that leave the image at the rim."""
    rng = np.random.default_rng(3)
    h, w = 20, 24
    fw = np.zeros((2, h, w, 2), np.float32)
    fw[..., 0], fw[..., 1] = 1.5, -2.25
    bw = -fw.copy()
    bw[:, 5:9, 6:12] += 3.0  # breaks the forward-backward cycle there
    fw[1] += rng.standard_normal((h, w, 2)).astype(np.float32) * 0.2
    ref = jax_occ_check(jnp.asarray(fw), jnp.asarray(bw), bound_check=bound_check)
    out = occ_check(_t(fw), _t(bw), bound_check=bound_check)
    for got, want in zip(out, ref):
        want = np.asarray(want)
        assert got.shape == (2, h, w, 1)
        assert 0.05 < want.mean() < 0.95
        np.testing.assert_array_equal(got.numpy(), want)
    zero = occ_check(torch.zeros(1, 8, 8, 2), torch.zeros(1, 8, 8, 2))
    assert bool((zero[0] == 1).all()) and bool((zero[1] == 1).all())


# -- census -------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 12, 14, 1), (1, 10, 9, 3), (1, 6, 7, 8, 1)],
                         ids=["gray", "rgb", "volume"])
def test_census_transform_matches_jax(shape):
    img = np.random.default_rng(4).uniform(0, 1, shape).astype(np.float32)
    patch = 7 if len(shape) == 4 else 3
    ref = np.asarray(jcensus.census_transform(jnp.asarray(img), patch))
    out = tcensus.census_transform(_t(img), patch)
    assert out.shape == shape[:-1] + (patch ** (len(shape) - 2),)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL)


@pytest.mark.parametrize("robust, masked", [(False, False), (True, False), (True, True)],
                         ids=["ternary", "robust", "robust_masked"])
def test_census_loss_matches_jax_values_and_gradient(robust, masked):
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1, (2, 16, 18, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (2, 16, 18, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, 16, 18, 1)) > 0.3).astype(np.float32) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    ref, dref = jax.value_and_grad(
        lambda y: jcensus.census_loss(jnp.asarray(a), y, mask=jmask, robust=robust))(
            jnp.asarray(b))
    tb = _t(b).requires_grad_(True)
    out = tcensus.census_loss(_t(a), tb, mask=None if mask is None else _t(mask), robust=robust)
    out.backward()
    assert float(out.detach()) == pytest.approx(float(ref), rel=1e-5)
    dref = np.asarray(dref)
    np.testing.assert_allclose(tb.grad.numpy(), dref, atol=1e-4 * np.abs(dref).max())


# -- warps ----------------------------------------------------------------------------


def test_boundary_dilated_warp_matches_jax_values_and_gradient():
    """A 12 x 14 crop at offsets (3, 5) and (0, 2) inside a 20 x 24 raw image;
    flows that leave the crop but stay inside the raw image hit real pixels."""
    rng = np.random.default_rng(6)
    raw = rng.uniform(0, 1, (2, 20, 24, 3)).astype(np.float32)
    flow = (rng.standard_normal((2, 12, 14, 2)) * 3).astype(np.float32) + 0.13
    start = np.asarray([[3, 5], [0, 2]], np.float32)
    ref, dref = jax.value_and_grad(
        lambda f: jnp.sum(jwarp.boundary_dilated_warp(jnp.asarray(raw), f, jnp.asarray(start))
                          ** 2))(jnp.asarray(flow))
    tf = _t(flow).requires_grad_(True)
    out = twarp.boundary_dilated_warp(_t(raw), tf, _t(start))
    assert out.shape == (2, 12, 14, 3)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jwarp.boundary_dilated_warp(jnp.asarray(raw), jnp.asarray(flow),
                                               jnp.asarray(start))), atol=TOL)
    (out**2).sum().backward()
    assert float((out.detach() ** 2).sum()) == pytest.approx(float(ref), rel=1e-5)
    dref = np.asarray(dref)
    np.testing.assert_allclose(tf.grad.numpy(), dref, atol=1e-4 * np.abs(dref).max())
    # zero offset and a crop as large as the image: the border-padded warp
    same = twarp.boundary_dilated_warp(_t(raw), _t(flow[:, :1, :1].repeat(20, 1).repeat(24, 2)),
                                       torch.zeros(2, 2))
    np.testing.assert_allclose(
        same.numpy(),
        twarp.backward_warp(_t(raw), _t(flow[:, :1, :1].repeat(20, 1).repeat(24, 2))).numpy(),
        atol=1e-6)
    with pytest.raises(ValueError, match="start"):
        twarp.boundary_dilated_warp(_t(raw), _t(flow), torch.zeros(2, 3))


@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_kernel_route_of_backward_warp_equals_the_plain_gather(padding):
    """On CUDA tensors ``backward_warp`` goes through ``warp2d(r=0)`` and takes
    its mask from a warp of ones; on the CPU that wrapper runs its plain
    version, so the route itself is checked here against the JAX warp."""
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, (2, 10, 12, 3)).astype(np.float32)
    flow = (rng.standard_normal((2, 10, 12, 2)) * 4).astype(np.float32)
    ref, ref_mask = jwarp.backward_warp(jnp.asarray(img), jnp.asarray(flow), padding=padding,
                                        return_mask=True)
    before = dict(LAUNCHES)
    out, mask = twarp._backward_warp_kernel(_t(img), _t(flow), padding, True)
    assert LAUNCHES == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)
    np.testing.assert_allclose(mask.numpy(), np.asarray(ref_mask), atol=TOL)
    assert mask.shape == (2, 10, 12, 1) and not mask.requires_grad
    alone = twarp._backward_warp_kernel(_t(img), _t(flow), padding, False)
    assert torch.equal(alone, out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_validity_mask_threshold_at_the_image_edge(dtype):
    """``warp_with_mask`` where the target leaves the image by 0, 5e-5, 1e-3,
    1e-2 and 0.5 px.  In float32 a pixel stays valid up to 1e-4 px (mask >
    0.9999) and the port equals the reference.  In bfloat16 the mask is rounded
    to bf16 first, so 1e-3 px (0.999, which rounds to 1) still counts as valid.  There the
    reference is at fault: it compares in bf16, where 0.9999 is 1.0, and
    zeroes every pixel of every warped feature map; the port compares in
    float32 and is held to the float32 reference on the pixels whose rounded
    mask is exact."""
    dt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    h, w = 6, 8
    leave = np.asarray([0.0, 5e-5, 1e-3, 1e-2, 0.5], np.float32)
    flow = np.zeros((len(leave), h, w, 2), np.float32)
    flow[:, :, :, 1] = leave[:, None, None]  # the last column leaves by `leave`
    feat = np.random.default_rng(8).uniform(0.5, 1, (len(leave), h, w, 2)).astype(np.float32)
    ref = np.asarray(jax_warp_with_mask(jnp.asarray(feat, jdt), jnp.asarray(flow))
                     .astype(jnp.float32))
    feat_t = _t(feat).movedim(-1, 1).to(dt).contiguous()
    _, mask = warp2d_with_mask(feat_t, _t(flow).movedim(-1, 1), "zeros")
    assert mask.dtype == dt and not mask.requires_grad
    out = warp_with_mask(feat_t, _t(flow).movedim(-1, 1)).float().movedim(1, -1).numpy()
    valid = (out != 0).all(axis=-1)
    assert valid[:, :, :-1].all()  # every other column stays inside
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=TOL)
        assert valid[:, 0, -1].tolist() == [True, True, False, False, False]
    else:
        assert not ref.any()  # the reference's bf16 comparison drops everything
        assert valid[:, 0, -1].tolist() == [True, True, True, False, False]
        ref32 = np.asarray(jax_warp_with_mask(jnp.asarray(feat), jnp.asarray(flow)))
        np.testing.assert_allclose(out[:, :, :-1], ref32[:, :, :-1], atol=1e-2)


def test_warp2d_takes_a_bf16_image_with_a_float32_flow():
    """UPFlow's feature warps: bf16 features, float32 flow.  The coordinates
    stay float32 (a 40.3 px flow is not rounded to 40.25), the result is bf16,
    and the flow's gradient comes back float32."""
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 1, (1, 4, 8, 64)).astype(np.float32)
    flow = np.zeros((1, 2, 8, 64), np.float32)
    flow[:, 1] = -40.3
    im16 = _t(img).bfloat16()
    fl = _t(flow).requires_grad_(True)
    out = warp2d(im16, fl, 0, "border")
    assert out.dtype == torch.bfloat16
    ref = jwarp.backward_warp(jnp.asarray(np.moveaxis(img, 1, -1), jnp.bfloat16),
                              jnp.asarray(np.moveaxis(flow, 1, -1)))
    np.testing.assert_allclose(out.float().movedim(1, -1).detach().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=1e-2)
    rounded = warp2d(im16, _t(flow).bfloat16(), 0, "border")
    assert float((rounded.float() - out.float()).abs().max()) > 1e-2  # what rounding would cost
    out.float().sum().backward()
    assert fl.grad.dtype == torch.float32 and float(fl.grad.abs().max()) > 0
