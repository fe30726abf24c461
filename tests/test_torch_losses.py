"""PyTorch port: the Laplacian pyramid and the RIFE losses against the JAX
package, values and gradients with respect to the inputs.

Inputs are drawn with numpy from fixed seeds, float32.  Tolerances:
- values: rtol 1e-5 (means and sums of a few thousand float32 terms in other
  orders);
- gradients: rtol 1e-5 plus 1e-5 of the largest reference gradient (small
  entries are sums of cancelling terms).  The Charbonnier-based terms
  (photometric, smoothness) get 1e-4: ``(x² + ε²)^0.25`` has a gradient
  ~ x^-0.5 whose relative error is that of ``x``, and a warped-minus-target
  difference of 1e-3 carries 6e-8 of float32 rounding, i.e. 6e-5.

The photometric loss warps unbounded on both sides (``fast_warp_r=0``): on the
CPU the JAX package never bounds its warps.  Flows stay off integers, where the
zeros-mode weight has a kink.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowscivis_tpu.losses import basic as jb
from opticalflowscivis_tpu.losses.rife import RIFELossWeights as JaxWeights
from opticalflowscivis_tpu.losses.rife import rife_losses as jax_rife_losses
from opticalflowscivis_tpu.ops import pyramid as jp
from opticalflowscivis_tpu_torch.losses import basic as tb
from opticalflowscivis_tpu_torch.losses.rife import RIFELossWeights, rife_losses
from opticalflowscivis_tpu_torch.ops import pyramid as tp

RTOL = 1e-5
CHARB_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small torch ops; with several test workers on one
    machine the intra-op thread pools oversubscribe the cores and such loops
    slow down a hundredfold.  One thread per worker is the fastest setting."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(out, ref, rtol=RTOL, err_msg=""):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    atol = rtol * float(np.abs(ref).max()) if ref.ndim else 0.0
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol, err_msg=err_msg)


def _check(torch_fn, jax_fn, arrays, rtol=RTOL, grad_rtol=None):
    """Value and gradient w.r.t. every array of ``arrays`` (a scalar function)."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = torch_fn(*leaves)
    ref, grads = jax.value_and_grad(jax_fn, tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays]
    )
    _close(out, ref, rtol)
    out.backward()
    for i, (leaf, g) in enumerate(zip(leaves, grads)):
        _close(leaf.grad, g, grad_rtol or rtol, err_msg=f"gradient of input {i}")


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _unit(seed, *shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _flow(seed, *shape, scale=2.0):
    """Off-integer flows (multiples of 1/4 plus 0.11)."""
    rng = np.random.default_rng(seed)
    return (np.round(rng.standard_normal(shape) * scale * 4) / 4 + 0.11).astype(np.float32)


# -- pyramid ------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 32, 32, 1), (2, 37, 53, 2), (1, 8, 6, 1)],
                         ids=["even", "odd", "tiny"])
def test_lap_loss_matches_jax(shape):
    _check(tp.lap_loss, jp.lap_loss, [_unit(1, *shape), _unit(2, *shape)])


@pytest.mark.parametrize("shape", [(2, 32, 32, 1), (1, 37, 53, 2)], ids=["even", "odd"])
def test_laplacian_pyramid_and_blur_match_jax(shape):
    x = _unit(3, *shape)
    _close(tp.gaussian_blur(torch.from_numpy(x)), jp.gaussian_blur(jnp.asarray(x)))
    _close(tp.gaussian_blur(torch.from_numpy(x), 2.0), jp.gaussian_blur(jnp.asarray(x), 2.0))
    out = tp.laplacian_pyramid(torch.from_numpy(x))
    ref = jp.laplacian_pyramid(jnp.asarray(x))
    assert len(out) == len(ref) == 5
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


def test_pyramid_takes_volumes_and_refuses_other_ranks():
    """Volumes go through ``conv3d`` (held against the JAX package in
    ``test_torch_warp3d.py``); a rank with no convolution raises."""
    x = torch.from_numpy(_unit(3, 1, 8, 8, 8, 1))
    assert float(tp.lap_loss(x, x)) == 0 and float(tp.lap_loss(x, 1 - x)) > 0
    with pytest.raises(ValueError, match="volumes"):
        tp.lap_loss(torch.zeros(1, 8, 1), torch.zeros(1, 8, 1))


# -- losses/basic.py ------------------------------------------------------------


def test_l1_charbonnier_epe_match_jax():
    a, b = _rand(4, 2, 9, 11, 2), _rand(5, 2, 9, 11, 2)
    _check(tb.l1_loss, jb.l1_loss, [a, b])
    _check(lambda x: tb.charbonnier(x).sum(), lambda x: jnp.sum(jb.charbonnier(x)), [a],
           grad_rtol=CHARB_RTOL)
    _check(lambda x: tb.charbonnier(x, 0.45, 1e-3).sum(),
           lambda x: jnp.sum(jb.charbonnier(x, 0.45, 1e-3)), [a], grad_rtol=CHARB_RTOL)
    _check(tb.epe, jb.epe, [a, b])
    _close(tb.epe(torch.from_numpy(a), torch.from_numpy(b), mean=False),
           jb.epe(jnp.asarray(a), jnp.asarray(b), mean=False))


def test_sobel_loss_matches_jax():
    _check(tb.sobel_loss, jb.sobel_loss, [_rand(6, 2, 12, 14, 2), _rand(7, 2, 12, 14, 2)])


@pytest.mark.parametrize("c", [1, 3])
def test_photometric_loss_matches_jax(c):
    """Zeros-padded warps of the prediction by both flow halves; the B*3
    normalization does not depend on C."""
    merged, img0, img1 = (_unit(s, 2, 16, 20, c) for s in (8, 9, 10))
    flow = _flow(11, 2, 16, 20, 4)
    _check(
        lambda m, f, a, b: tb.photometric_loss(m, f, a, b, 2, fast_warp_r=0),
        lambda m, f, a, b: jb.photometric_loss(m, f, a, b, 2, fast_warp_r=0),
        [merged, flow, img0, img1], grad_rtol=CHARB_RTOL,
    )
    ref = float(jb.photometric_loss(*map(jnp.asarray, (merged, flow, img0, img1)), 2))
    bounded = float(tb.photometric_loss(*map(torch.from_numpy, (merged, flow, img0, img1)), 2,
                                        fast_warp_r=16))
    assert np.abs(flow).max() < 16  # inside the bound the clip changes nothing
    assert bounded == pytest.approx(ref, rel=RTOL)


def test_smoothness_loss_matches_jax():
    _check(tb.smoothness_loss, jb.smoothness_loss, [_rand(12, 2, 10, 12, 4)],
           grad_rtol=CHARB_RTOL)


@pytest.mark.parametrize("with_teacher", [True, False])
def test_flow_supervision_matches_jax(with_teacher):
    flows = [_rand(s, 2, 8, 10, 4) for s in (13, 14, 15)]
    tea, gt = _rand(16, 2, 8, 10, 4), _rand(17, 2, 8, 10, 2)

    def torch_fn(f0, f1, f2, t, g):
        return tb.flow_supervision([f0, f1, f2], t if with_teacher else None, g, 2)

    def jax_fn(f0, f1, f2, t, g):
        return jb.flow_supervision([f0, f1, f2], t if with_teacher else None, g, 2)

    if with_teacher:
        _check(torch_fn, jax_fn, flows + [tea, gt])
    else:  # the teacher gets no gradient: leave it out of the differentiated inputs
        _check(lambda *a: torch_fn(*a[:3], None, a[3]), lambda *a: jax_fn(*a[:3], None, a[3]),
               flows + [gt])


def test_photometric_loss_matches_jax_in_3d():
    """Volumes: an unbounded zeros-padded trilinear warp on both sides
    (``fast_warp_r`` plays no part in 3-D, as in the reference)."""
    merged, img0, img1 = (_unit(s, 2, 8, 10, 12, 1) for s in (50, 51, 52))
    flow = _flow(53, 2, 8, 10, 12, 6)
    _check(
        lambda m, f, a, b: tb.photometric_loss(m, f, a, b, 3, fast_warp_r=8),
        lambda m, f, a, b: jb.photometric_loss(m, f, a, b, 3, fast_warp_r=8),
        [merged, flow, img0, img1], grad_rtol=CHARB_RTOL,
    )
    x = torch.zeros(1, 4, 4, 4, 1)
    with pytest.raises(ValueError, match="ndim"):
        tb.photometric_loss(x, x, x, x, 2)


# -- losses/rife.py -------------------------------------------------------------

SHAPE = (2, 32, 32)
PARAM_SHAPES = {
    ("block0", "Conv_0", "kernel"): (3, 3, 2, 4),
    ("block2", "Conv_0", "kernel"): (3, 3, 4, 4),
    ("block2", "Conv_0", "bias"): (4,),
    ("block2", "PReLU_0", "slope"): (4,),
    ("block_tea", "ConvTranspose_0", "kernel"): (4, 4, 4, 2),
}


def _rife_inputs(distill=0.3, flow_scale=2.0):
    """Flat list of arrays: 3 flows, 3 masks, 3 merged, teacher flow, teacher
    merged, distill, img0, img1, gt, gt_flow, then the parameter leaves."""
    flows = [_flow(20 + i, *SHAPE, 4, scale=flow_scale) for i in range(3)]
    masks = [_unit(23 + i, *SHAPE, 1) for i in range(3)]
    merged = [_unit(26 + i, *SHAPE, 1) for i in range(3)]
    rest = [_flow(29, *SHAPE, 4, scale=flow_scale), _unit(30, *SHAPE, 1),
            np.float32(distill), _unit(31, *SHAPE, 1), _unit(32, *SHAPE, 1),
            _unit(33, *SHAPE, 1), _rand(34, *SHAPE, 2)]
    params = [_rand(40 + i, *s, scale=0.1) for i, s in enumerate(PARAM_SHAPES.values())]
    return flows + masks + merged + rest + params


def _unpack(arrays, teacher):
    outputs = {
        "flow_list": list(arrays[0:3]), "mask_list": list(arrays[3:6]),
        "merged": list(arrays[6:9]),
        "flow_teacher": arrays[9] if teacher else None,
        "merged_teacher": arrays[10] if teacher else None,
        "loss_distill": arrays[11],
    }
    img0, img1, gt, gt_flow = arrays[12:16]
    return outputs, img0, img1, gt, gt_flow, arrays[16:]


def _both_rife(arrays, weights_kw, teacher=True, with_gt_flow=True):
    """(torch parts, torch input grads, jax parts, jax input grads) of loss_G."""
    def torch_side():
        leaves = [torch.tensor(a).requires_grad_() for a in arrays]
        outputs, img0, img1, gt, gt_flow, params = _unpack(leaves, teacher)
        named = {".".join(k): p for k, p in zip(PARAM_SHAPES, params)}
        loss, parts = rife_losses(outputs, img0, img1, gt, named, RIFELossWeights(**weights_kw),
                                  2, gt_flow=gt_flow if with_gt_flow else None, fast_warp_r=0)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return parts, grads

    def jax_loss(*leaves):
        outputs, img0, img1, gt, gt_flow, params = _unpack(leaves, teacher)
        tree = {}
        for (block, module, leaf), p in zip(PARAM_SHAPES, params):
            tree.setdefault(block, {}).setdefault(module, {})[leaf] = p
        return jax_rife_losses(outputs, img0, img1, gt, {"params": tree},
                               JaxWeights(**weights_kw), 2,
                               gt_flow=gt_flow if with_gt_flow else None, fast_warp_r=0)

    (_, jparts), jgrads = jax.value_and_grad(jax_loss, tuple(range(len(arrays))), has_aux=True)(
        *[jnp.asarray(a) for a in arrays]
    )
    tparts, tgrads = torch_side()
    return tparts, tgrads, jparts, jgrads


def _compare_rife(arrays, weights_kw, **kw):
    tparts, tgrads, jparts, jgrads = _both_rife(arrays, weights_kw, **kw)
    assert set(tparts) == set(jparts)
    for key, ref in jparts.items():
        assert float(tparts[key].detach()) == pytest.approx(float(ref), rel=RTOL, abs=1e-12), key
    for i, (g, ref) in enumerate(zip(tgrads, jgrads)):
        ref = np.asarray(ref)
        if g is None:  # an input no term reads
            assert not ref.any(), f"input {i}"
            continue
        # the photometric term reaches merged[-1], flow_list[-1], img0, img1
        rtol = CHARB_RTOL if i in (2, 8, 12, 13) else RTOL
        _close(g, ref, rtol, err_msg=f"gradient of input {i}")
    return {k: v.detach() for k, v in tparts.items()}


SUPERVISED = dataclasses.asdict(RIFELossWeights.preset_2d(flow_supervised=True))


def test_rife_losses_preset_2d_match_jax_part_by_part():
    parts = _compare_rife(_rife_inputs(), SUPERVISED)
    assert set(parts) == {"loss_l1", "loss_tea", "loss_distill", "l1_reg", "loss_photo",
                          "loss_smooth", "loss_flow", "loss_G"}
    assert all(float(parts[k]) > 0 for k in parts if k != "loss_smooth")


def test_rife_losses_without_gt_flow_and_teacher_match_jax():
    parts = _compare_rife(_rife_inputs(), SUPERVISED, teacher=False, with_gt_flow=False)
    assert float(parts["loss_flow"]) == 0 and float(parts["loss_tea"]) == 0


def test_rife_losses_leash_and_smoothness_match_jax():
    kw = dict(SUPERVISED, smooth=0.1, flow_leash=0.5, flow_leash_radius=4.0)
    parts = _compare_rife(_rife_inputs(flow_scale=3.0), kw)
    assert float(parts["loss_leash"]) > 0 and float(parts["loss_smooth"]) > 0
    assert "loss_leash" not in _compare_rife(_rife_inputs(), dict(kw, flow_leash=0.0))


def test_rife_losses_plain_l1_preset_3d_weights_match_jax():
    _compare_rife(_rife_inputs(), dataclasses.asdict(RIFELossWeights.preset_3d(distill=0.1)))


@pytest.mark.parametrize("distill", [float("nan"), 10.5, 9.5])
def test_rife_losses_distill_guard_matches_jax(distill):
    """A NaN or > 10 distill value is dropped, and loss_G stays finite."""
    parts = _compare_rife(_rife_inputs(distill=distill), SUPERVISED)
    assert (float(parts["loss_distill"]) == 0) == (not distill < 10)
    assert np.isfinite(float(parts["loss_G"]))


def test_weights_presets_equal_the_jax_ones():
    for ours, theirs in (
        (RIFELossWeights(), JaxWeights()),
        (RIFELossWeights.preset_2d(True), JaxWeights.preset_2d(True)),
        (RIFELossWeights.preset_3d(), JaxWeights.preset_3d()),
        (RIFELossWeights.preset_3d(0.1), JaxWeights.preset_3d(0.1)),
    ):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
