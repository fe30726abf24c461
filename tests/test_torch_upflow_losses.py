"""PyTorch port: the UPFlow and self-supervised losses against the JAX package.

The same numpy-drawn frames, flows and pyramid go through
``opticalflowscivis_tpu.losses.upflow_losses`` and the port's, part by part,
with the gradient with respect to the flows; then ``apply_affine``,
``transform_flow``, ``eq_loss`` and ``oi_loss`` with affine parameters and
noise drawn by numpy and handed to both packages, and the twins of
``tests/test_selfsup.py``.  ``evalsuite/flow_eval.py`` is pinned to its
original by equality.

Tolerances: parts rel 2e-5 (float32 means over up to 1e4 terms in another
order); gradients 1e-4 of the largest gradient.  The frames are textured and
the flows are continuous draws: no two neighbouring flow values are equal and
no coordinate is an integer.  At such kinks the packages pick other
subgradients (``|x|`` at exactly 0 has gradient +1 in JAX and 0 in PyTorch),
which says nothing about either implementation.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowscivis_tpu.evalsuite import flow_eval as jflow_eval
from opticalflowscivis_tpu.losses import selfsup as jselfsup
from opticalflowscivis_tpu.losses import upflow as jlosses
from opticalflowscivis_tpu_torch.evalsuite import flow_eval
from opticalflowscivis_tpu_torch.losses import selfsup, upflow as tlosses

REL = 2e-5
GRAD = 1e-4


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


def _case(seed, b=2, h=32, w=48):
    """Textured frames, continuous flows of a few pixels and a 3-level pyramid."""
    rng = np.random.default_rng(seed)
    im1 = rng.uniform(0.05, 1, (b, h, w, 3)).astype(np.float32)
    im2 = rng.uniform(0.05, 1, (b, h, w, 3)).astype(np.float32)

    def flow(hh, ww, scale):
        return (rng.standard_normal((b, hh, ww, 2)) * scale).astype(np.float32)

    out = {"flow_f": flow(h, w, 2.0), "flow_b": flow(h, w, 2.0),
           "flows": [(flow(h // s, w // s, 2.0 / s), flow(h // s, w // s, 2.0 / s))
                     for s in (4, 8, 16)]}
    return im1, im2, out


def _both(cfg_kw, seed=0, raw=False):
    """(total, parts, d total / d flow_f) of both packages on one case."""
    im1, im2, out = _case(seed)
    jraw = traw = None
    if raw:
        rng = np.random.default_rng(seed + 100)
        raws = [rng.uniform(0.05, 1, (2, 40, 60, 3)).astype(np.float32) for _ in range(2)]
        start = np.asarray([[4, 6], [2, 9]], np.float32)
        jraw = tuple(jnp.asarray(r) for r in raws) + (jnp.asarray(start),)
        traw = tuple(_t(r) for r in raws) + (_t(start),)

    jcfg = jlosses.UPFlowLossConfig(**cfg_kw)

    def jloss(flow_f):
        o = dict(out, flow_f=flow_f)
        total, parts = jlosses.upflow_losses(o, jnp.asarray(im1), jnp.asarray(im2), jcfg,
                                             raw=jraw)
        return total, parts

    (jtotal, jparts), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(out["flow_f"]))

    tcfg = tlosses.UPFlowLossConfig(**cfg_kw)
    tout = {"flow_f": _t(out["flow_f"]).requires_grad_(True), "flow_b": _t(out["flow_b"]),
            "flows": [(_t(f), _t(bw)) for f, bw in out["flows"]]}
    total, parts = tlosses.upflow_losses(tout, _t(im1), _t(im2), tcfg, raw=traw)
    total.backward()
    return (total, parts, tout["flow_f"].grad), (jtotal, jparts, jgrad)


def _assert_same(ours, theirs):
    (total, parts, grad), (jtotal, jparts, jgrad) = ours, theirs
    assert set(parts) == set(jparts)
    for key, ref in jparts.items():
        assert float(parts[key].detach()) == pytest.approx(float(ref), rel=REL, abs=1e-7), key
    assert float(total.detach()) == pytest.approx(float(jtotal), rel=REL)
    jgrad = np.asarray(jgrad)
    assert np.abs(jgrad).max() > 0
    np.testing.assert_allclose(grad.numpy(), jgrad, atol=GRAD * np.abs(jgrad).max())


def test_loss_config_defaults_equal_the_reference():
    ours = dataclasses.asdict(tlosses.UPFlowLossConfig())
    assert ours == dataclasses.asdict(jlosses.UPFlowLossConfig())
    assert dataclasses.asdict(selfsup.SPTransformConfig()) == dataclasses.asdict(
        jselfsup.SPTransformConfig())


@pytest.mark.parametrize("photo_loss_type", ["abs_robust", "charbonnier", "L1", "SSIM"])
@pytest.mark.parametrize("use_occ", [False, True], ids=["mean", "occ"])
def test_upflow_losses_match_for_each_photo_loss_type(photo_loss_type, use_occ):
    _assert_same(*_both(dict(photo_loss_type=photo_loss_type, photo_loss_use_occ=use_occ)))


@pytest.mark.parametrize("smooth_type", ["edge", "delta"])
@pytest.mark.parametrize("smooth_level", ["final", "1/4"])
def test_upflow_losses_match_for_each_smoothness(smooth_type, smooth_level):
    """Both orders on: first order at weight 1, second at 0.5.  At level '1/4'
    the smoothness reads the pyramid, so the gradient with respect to the
    final flow comes from the photometric term alone."""
    _assert_same(*_both(dict(smooth_type=smooth_type, smooth_level=smooth_level,
                             smooth_order_1_weight=1.0, smooth_order_2_weight=0.5), seed=1))


@pytest.mark.parametrize("msd_style", ["upup", "down"])
@pytest.mark.parametrize("msd_use_occ", [True, False], ids=["occ", "mean"])
def test_upflow_losses_match_with_census_and_distillation(msd_style, msd_use_occ):
    _assert_same(*_both(dict(census_weight=0.5, msd_weight=0.01, msd_style=msd_style,
                             msd_use_occ=msd_use_occ, photo_loss_use_occ=True,
                             stop_occ_gradient=True), seed=2))


def test_upflow_losses_match_with_boundary_dilated_warp():
    _assert_same(*_both(dict(census_weight=0.3), seed=3, raw=True))


def test_losses_finite_and_composed():
    """Twin of ``tests/test_upflow.py``: the total is the sum of its parts."""
    (total, parts, _), _ = _both(dict(census_weight=0.5, msd_weight=0.01,
                                      photo_loss_use_occ=True, stop_occ_gradient=True), seed=4)
    assert all(np.isfinite(float(v.detach())) for v in parts.values())
    summed = parts["photo_loss"] + parts["smooth_loss"] + parts["census_loss"] + parts["msd_loss"]
    assert float(total.detach()) == pytest.approx(float(summed.detach()), rel=1e-6)
    assert float(parts["loss_total"].detach()) == float(total.detach())


def test_unknown_photo_loss_type_raises():
    x = torch.zeros(1, 4, 4, 1)
    with pytest.raises(ValueError, match="photo_loss"):
        tlosses.photo_loss_multi_type(x, x, x, "huber")


@pytest.mark.parametrize("c1, c2", [(float("inf"), 9e-6), (1e-4, float("inf")), (1e-4, 9e-4)],
                         ids=["structure", "luminance", "both"])
def test_weighted_ssim_matches_jax(c1, c2):
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (2, 12, 14, 3)).astype(np.float32)
    y = rng.uniform(0, 1, (2, 12, 14, 3)).astype(np.float32)
    wgt = (rng.uniform(size=(2, 12, 14, 1)) > 0.3).astype(np.float32)
    ref, ref_w = jlosses.weighted_ssim(jnp.asarray(x), jnp.asarray(y), jnp.asarray(wgt), c1, c2)
    out, out_w = tlosses.weighted_ssim(_t(x), _t(y), _t(wgt), c1, c2)
    assert out.shape == (2, 10, 12, 3) and out_w.shape == (2, 10, 12, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(out_w.numpy(), np.asarray(ref_w), atol=1e-6)


# -- self-supervised transform losses ---------------------------------------------


def _affine(seed, b):
    rng = np.random.default_rng(seed)
    theta = (rng.uniform(-10, 10, b) * np.pi / 180).astype(np.float32)
    zoom = rng.uniform(0.9, 1.1, b).astype(np.float32)
    trans = rng.uniform(-0.1, 0.1, (b, 2)).astype(np.float32)
    return theta, zoom, trans


def test_apply_affine_and_transform_flow_match_jax():
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 1, (3, 20, 28, 3)).astype(np.float32)
    flow = rng.standard_normal((3, 20, 28, 2)).astype(np.float32)
    params = _affine(7, 3)
    jp, tp = tuple(jnp.asarray(p) for p in params), tuple(_t(p) for p in params)
    np.testing.assert_allclose(selfsup.apply_affine(_t(img), *tp).numpy(),
                               np.asarray(jselfsup.apply_affine(jnp.asarray(img), *jp)),
                               atol=2e-5)
    np.testing.assert_allclose(selfsup.transform_flow(_t(flow), *tp).numpy(),
                               np.asarray(jselfsup.transform_flow(jnp.asarray(flow), *jp)),
                               atol=2e-5)


@pytest.mark.parametrize("with_mask", [False, True], ids=["mean", "occ"])
def test_eq_loss_matches_jax_value_and_gradient(with_mask):
    rng = np.random.default_rng(8)
    student = rng.standard_normal((2, 16, 24, 2)).astype(np.float32)
    teacher = rng.standard_normal((2, 16, 24, 2)).astype(np.float32)
    mask = (rng.uniform(size=(2, 16, 24, 1)) > 0.3).astype(np.float32) if with_mask else None
    params = _affine(9, 2)
    jp, tp = tuple(jnp.asarray(p) for p in params), tuple(_t(p) for p in params)
    ref, dref = jax.value_and_grad(lambda s: jselfsup.eq_loss(
        s, jnp.asarray(teacher), jp, None if mask is None else jnp.asarray(mask)))(
            jnp.asarray(student))
    s = _t(student).requires_grad_(True)
    tea = _t(teacher).requires_grad_(True)
    out = selfsup.eq_loss(s, tea, tp, None if mask is None else _t(mask))
    out.backward()
    assert float(out.detach()) == pytest.approx(float(ref), rel=REL)
    dref = np.asarray(dref)
    np.testing.assert_allclose(s.grad.numpy(), dref, atol=GRAD * np.abs(dref).max())
    assert tea.grad is None  # the teacher is detached


def test_oi_loss_matches_jax_value_and_gradient():
    im1, im2, out = _case(10)
    ref, dref = jax.value_and_grad(lambda f: jselfsup.oi_loss(
        jnp.asarray(im1), jnp.asarray(im2), f, jnp.asarray(out["flow_b"])))(
            jnp.asarray(out["flow_f"]))
    f = _t(out["flow_f"]).requires_grad_(True)
    val = selfsup.oi_loss(_t(im1), _t(im2), f, _t(out["flow_b"]))
    val.backward()
    assert float(val.detach()) == pytest.approx(float(ref), rel=REL)
    dref = np.asarray(dref)
    np.testing.assert_allclose(f.grad.numpy(), dref, atol=GRAD * np.abs(dref).max())


def test_identity_affine_is_noop():
    img = torch.rand(2, 16, 16, 3)
    out = selfsup.apply_affine(img, torch.zeros(2), torch.ones(2), torch.zeros(2, 2))
    np.testing.assert_allclose(out.numpy(), img.numpy(), atol=1e-5)


def test_translation_shifts_content():
    img = torch.zeros(1, 16, 16, 1)
    img[:, 4, 4] = 1.0
    out = selfsup.apply_affine(img, torch.zeros(1), torch.ones(1),
                               torch.tensor([[2 / 16, 0.0]]))  # ty = 2 px
    # pull-back: output pixel p samples the input at p + t, the peak moves to row 2
    assert float(out[0, 2, 4, 0]) > 0.9


def test_flow_equivariance_zero_flow():
    theta, zoom, _ = _affine(11, 2)
    out = selfsup.transform_flow(torch.zeros(2, 16, 16, 2), _t(theta), _t(zoom),
                                 torch.zeros(2, 2))
    np.testing.assert_allclose(out.numpy(), 0.0, atol=1e-5)


def test_eq_loss_zero_for_consistent_flows():
    teacher = torch.randn(1, 16, 16, 2, generator=torch.Generator().manual_seed(2))
    params = (torch.tensor([0.2]), torch.tensor([1.05]), torch.zeros(1, 2))
    student = selfsup.transform_flow(teacher, *params)
    # abs_robust has a floor of 0.01**0.4 at zero error
    assert float(selfsup.eq_loss(student, teacher, params)) <= 0.01**0.4 + 1e-4


def test_sp_transform_pair_shapes_ranges_and_determinism():
    cfg = selfsup.SPTransformConfig()
    im = torch.rand(64, 16, 16, 3)
    gen = torch.Generator().manual_seed(3)
    t1, t2, (theta, zoom, trans) = selfsup.sp_transform_pair(gen, im, im, cfg)
    assert t1.shape == im.shape and t2.shape == im.shape and theta.shape == (64,)
    assert float(theta.abs().max()) <= cfg.max_rotate_deg * np.pi / 180
    assert cfg.min_zoom <= float(zoom.min()) and float(zoom.max()) <= cfg.max_zoom
    assert trans.shape == (64, 2) and float(trans.abs().max()) <= cfg.max_translate
    assert float((t1 - t2).abs().max()) > 0  # each frame gets its own noise
    noise = t1 - selfsup.apply_affine(im, theta, zoom, trans)
    assert float(noise.std()) == pytest.approx(cfg.noise_std, rel=0.05)
    again = selfsup.sp_transform_pair(torch.Generator().manual_seed(3), im, im, cfg)
    assert torch.equal(again[0], t1)
    quiet = selfsup.sp_transform_pair(torch.Generator().manual_seed(3), im, im,
                                      dataclasses.replace(cfg, add_noise=False))
    assert torch.equal(quiet[0], quiet[1])


# -- flow metrics ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_flow_eval_copy_equals_the_original(seed):
    rng = np.random.default_rng(seed)
    gt = (rng.standard_normal((2, 12, 16, 2)) * 20).astype(np.float32)
    pred = gt + rng.standard_normal(gt.shape).astype(np.float32) * 4
    occ = (rng.uniform(size=(2, 12, 16, 1)) > 0.2).astype(np.float32)
    noc = occ * (rng.uniform(size=occ.shape) > 0.3)
    assert flow_eval.flow_epe(pred, gt) == jflow_eval.flow_epe(pred, gt)
    assert flow_eval.flow_epe(pred, gt, occ) == jflow_eval.flow_epe(pred, gt, occ)
    for rel in (0.05, None):
        assert flow_eval.flow_outlier_pct(gt, pred, occ, relative=rel) == \
            jflow_eval.flow_outlier_pct(gt, pred, occ, relative=rel)
    assert flow_eval.evaluate_flow(pred, gt, occ, gt, noc) == jflow_eval.evaluate_flow(
        pred, gt, occ, gt, noc)
    assert flow_eval.evaluate_flow(gt, gt, occ)["epe_all"] == 0.0  # predict GT: EPE 0
