"""PyTorch port: ``UPFlowNet`` with bridged weights against the JAX ``UPFlowNet``.

The ``TINY`` widths of ``tests/test_upflow.py`` at [2, 64, 64, 3] (the coarsest
plane is 1 x 1) and at [1, 64, 128, 3], float32, weights drawn with numpy on
``jax.eval_shape`` and carried over by ``bridge.upflow_params_from_flax``.
Every output key is compared: ``flow_f``, ``flow_b`` and each level of
``flows``.  Tolerance: 2e-5 of the largest flow of the case plus 2e-5 absolute
(float32 convolutions summed in other orders through five decode levels, each
of which doubles the flow it takes over).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowscivis_tpu.models import UPFlowConfig as JaxUPFlowConfig
from opticalflowscivis_tpu.models import UPFlowNet as JaxUPFlowNet
from opticalflowscivis_tpu.models import upflow as jupflow
from opticalflowscivis_tpu_torch.bridge import upflow_params_from_flax
from opticalflowscivis_tpu_torch.models import UPFlowConfig, UPFlowNet
from opticalflowscivis_tpu_torch.models import upflow as tupflow
from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES

TINY = dict(
    num_chs=(3, 4, 8, 8, 12, 16, 16),
    estimator_f_channels=(16, 16, 12, 8, 8),
    context_f_channels=(16, 16, 16, 12, 8, 8, 2),
    search_range=2,
)
REL_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers side by side: a few threads each keep
    the many small ops of these tests from fighting over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def numpy_params(jnet, shape, seed):
    """Params of ``jnet`` drawn with numpy on its abstract shapes (no init):
    LeCun-scaled kernels and nonzero biases, so that every leaf's mapping shows."""
    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, x)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if "kernel" in jax.tree_util.keystr(path):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(kw, shape=(2, 64, 64, 3), seed=0):
    """(jitted JAX apply, numpy params, port model with the bridged weights)."""
    jcfg = JaxUPFlowConfig(**TINY, **kw)
    jnet = JaxUPFlowNet(cfg=jcfg)
    params = numpy_params(jnet, shape, seed)
    cfg = UPFlowConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    net = UPFlowNet(cfg, device="cpu")
    net.load_state_dict(upflow_params_from_flax(params), strict=True)
    return jax.jit(jnet.apply), params, net.eval()


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, shape).astype(np.float32),
            rng.uniform(0, 1, shape).astype(np.float32))


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _assert_outputs_match(out, ref):
    scale = max(float(np.abs(ref["flow_f"]).max()), float(np.abs(ref["flow_b"]).max()))
    atol = REL_TOL * scale + 2e-5
    for key in ("flow_f", "flow_b"):
        np.testing.assert_allclose(_nhwc(out[key]), np.asarray(ref[key]), atol=atol, err_msg=key)
    assert len(out["flows"]) == len(ref["flows"]) == 5
    for level, ((of, ob), (rf, rb)) in enumerate(zip(out["flows"], ref["flows"])):
        np.testing.assert_allclose(_nhwc(of), np.asarray(rf), atol=atol, err_msg=f"f{level}")
        np.testing.assert_allclose(_nhwc(ob), np.asarray(rb), atol=atol, err_msg=f"b{level}")
    return scale


@pytest.mark.parametrize("batch_directions", [True, False], ids=["stacked", "two_streams"])
@pytest.mark.parametrize("norm", ["off", "per_image", "shared"])
@pytest.mark.parametrize("sgu", [False, True], ids=["plain", "sgu"])
def test_upflownet_matches_jax_on_every_output(sgu, norm, batch_directions):
    """With and without SGU, normalisation off / per image and channel (the
    training default) / shared across channels and images, both decode forms."""
    kw = dict(if_sgu_upsample=sgu, batch_directions=batch_directions,
              if_norm_before_cost_volume=norm != "off",
              norm_moments_across_channels=norm == "shared",
              norm_moments_across_images=norm == "shared")
    shape = (2, 64, 64, 3)
    apply, params, net = _pair(kw, shape)
    im1, im2 = _frames(shape, 1)
    if norm == "shared":
        # the shared "variance" is the variance of the two variances: between
        # two frames of one brightness it is nearly 0 and the normalised
        # features (and the flows) blow up to 1e7; a darker second frame keeps
        # the two variances apart and the case well conditioned
        im2 = im2 * 0.3
    ref = apply(params, im1, im2)
    before = dict(LAUNCHES)
    with torch.no_grad():
        out = net(_nchw(im1), _nchw(im2))
    assert LAUNCHES == before  # CPU tensors: the plain versions
    assert out["flow_f"].shape == (2, 2, 64, 64) and out["flow_f"].dtype == torch.float32
    assert out["flows"][0][0].shape == (2, 2, 16, 16)  # finest first: 1/4 resolution
    assert out["flows"][-1][0].shape == (2, 2, 1, 1)
    scale = _assert_outputs_match(out, ref)
    assert np.isfinite(scale) and scale > 1e-3


def test_upflownet_matches_jax_on_a_wide_plane():
    """[1, 64, 128, 3]: planes 1 x 2 .. 16 x 32, training-default normalisation."""
    kw = dict(if_norm_before_cost_volume=True, norm_moments_across_channels=False,
              norm_moments_across_images=False)
    shape = (1, 64, 128, 3)
    apply, params, net = _pair(kw, shape, seed=2)
    im1, im2 = _frames(shape, 3)
    with torch.no_grad():
        out = net(_nchw(im1), _nchw(im2))
    _assert_outputs_match(out, apply(params, im1, im2))


@pytest.mark.parametrize("sgu", [False, True], ids=["plain", "sgu"])
def test_bridge_maps_every_leaf_once(sgu):
    _, params, net = _pair(dict(if_sgu_upsample=sgu))
    leaves = jax.tree_util.tree_leaves_with_path(params)
    state = upflow_params_from_flax(params)
    assert len(state) == len(leaves) == len(net.state_dict())
    assert set(state) == set(net.state_dict())
    for key, value in net.state_dict().items():
        assert state[key].shape == value.shape, key
    names = {jax.tree_util.keystr(p) for p, _ in leaves}
    assert any("FeatureExtractor_0" in n for n in names)
    assert any("conv_1x1_4" in n for n in names)
    assert any("sgi_model" in n for n in names) == sgu


def test_bridge_full_width_matches_the_training_default():
    """The full-width JAX params (abstract init: no weights computed) bridge
    onto the port's full-width model key for key and shape."""
    jcfg = JaxUPFlowConfig(if_sgu_upsample=True)
    x = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(JaxUPFlowNet(cfg=jcfg).init, jax.random.PRNGKey(0), x, x)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    net = UPFlowNet(UPFlowConfig(if_sgu_upsample=True), device="cpu")
    net.load_state_dict(upflow_params_from_flax(zeros), strict=True)
    assert net.flow_estimators.convs[0].conv.in_channels == 81 + 32 + 2
    assert net.context_networks.convs[0].conv.in_channels == 115 + 448 + 2
    assert [c.conv.dilation[0] for c in net.context_networks.convs] == [1, 2, 4, 8, 16, 1, 1]
    assert [c.conv.padding[0] for c in net.context_networks.convs] == [1, 2, 4, 8, 16, 1, 1]
    assert [c.conv.in_channels for c in net.conv_1x1] == [196, 128, 96, 64, 32]


def test_bridge_rejects_unknown_and_colliding_leaves():
    with pytest.raises(KeyError, match="unmapped"):
        upflow_params_from_flax({"params": {"mystery": {"Conv_0": {"kernel": np.zeros((1, 1, 2, 2))}}}})
    with pytest.raises(KeyError, match="unmapped"):
        upflow_params_from_flax({"conv_1x1_0": {"Conv_0": {"scale": np.zeros(2)}}})


@pytest.mark.parametrize("across_channels, across_images", [(True, True), (False, False),
                                                             (True, False), (False, True)])
def test_normalize_features_matches_jax(across_channels, across_images):
    """Population variance, epsilon 1e-16 inside the sqrt, and with
    ``across_images`` the variance of the two variances (the reference's own)."""
    rng = np.random.default_rng(4)
    f1 = (rng.standard_normal((2, 6, 7, 5)) * 2 + 1).astype(np.float32)
    f2 = (rng.standard_normal((2, 6, 7, 5)) * 0.5 - 1).astype(np.float32)
    ref = jupflow.normalize_features(jnp.asarray(f1), jnp.asarray(f2), across_channels,
                                     across_images)
    out = tupflow.normalize_features(_nchw(f1), _nchw(f2), across_channels, across_images)
    for got, want in zip(out, ref):
        want = np.asarray(want)
        np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_warp_with_mask_matches_jax_values_and_gradients():
    """Features of 6 channels warped by flows of which a third leave the
    plane: values, the feature gradient (``dimg``) and the flow gradient."""
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((2, 9, 11, 6)).astype(np.float32)
    flow = (np.round(rng.standard_normal((2, 9, 11, 2)) * 12) / 4 + 0.11).astype(np.float32)
    g = rng.standard_normal(feat.shape).astype(np.float32)
    ref = jupflow.warp_with_mask(jnp.asarray(feat), jnp.asarray(flow))
    dref = jax.grad(lambda a, b: jnp.sum(jupflow.warp_with_mask(a, b) * g), argnums=(0, 1))(
        jnp.asarray(feat), jnp.asarray(flow))
    a, b = _nchw(feat).contiguous().requires_grad_(True), _nchw(flow).requires_grad_(True)
    out = tupflow.warp_with_mask(a, b)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-5)
    assert 0.2 < float((out == 0).all(dim=1).float().mean()) < 0.8
    (out * _nchw(g)).sum().backward()
    for got, want in zip((a.grad, b.grad), dref):
        want = np.asarray(want)
        np.testing.assert_allclose(_nhwc(got), want, atol=1e-4 * np.abs(want).max())


def test_batch_directions_equivalent_and_param_compatible():
    """Twin of ``tests/test_upflow.py``: the stacked decode gives the same
    flows as the two-stream one from the same ``state_dict``."""
    im1, im2 = _frames((2, 64, 64, 3), 6)
    for across in (True, False):
        for sgu in (False, True):
            kw = dict(**TINY, if_norm_before_cost_volume=True, if_sgu_upsample=sgu,
                      norm_moments_across_channels=across, norm_moments_across_images=across)
            stacked = UPFlowNet(UPFlowConfig(batch_directions=True, **kw), device="cpu", seed=2)
            streams = UPFlowNet(UPFlowConfig(batch_directions=False, **kw), device="cpu", seed=3)
            streams.load_state_dict(stacked.state_dict(), strict=True)
            with torch.no_grad():
                a = stacked(_nchw(im1), _nchw(im2))
                b = streams(_nchw(im1), _nchw(im2))
            for key in ("flow_f", "flow_b"):
                x, y = a[key].numpy(), b[key].numpy()
                np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-3 + 1e-4 * np.abs(x).max())


def test_forward_shapes_and_input_checks():
    """Twin of ``test_forward_shapes`` and ``test_sgu_variant_runs``."""
    net = UPFlowNet(UPFlowConfig(**TINY, if_sgu_upsample=True, if_norm_before_cost_volume=True),
                    device="cpu")
    im = torch.rand(1, 3, 64, 64)
    with torch.no_grad():
        out = net(im, im)
    assert out["flow_f"].shape == (1, 2, 64, 64) and out["flow_b"].shape == (1, 2, 64, 64)
    assert len(out["flows"]) == 5 and bool(torch.isfinite(out["flow_f"]).all())
    with pytest.raises(ValueError, match="one shape"):
        net(im, torch.rand(1, 3, 64, 128))
    # a channels-last view is taken as it is (the trainer passes such views)
    nhwc = torch.rand(1, 64, 64, 3)
    with torch.no_grad():
        a = net(nhwc.movedim(-1, 1), nhwc.movedim(-1, 1))["flow_f"]
        b = net(nhwc.movedim(-1, 1).contiguous(), nhwc.movedim(-1, 1).contiguous())["flow_f"]
    assert torch.equal(a, b)


def test_bf16_compute_keeps_float32_flows_and_tracks_float32():
    """bf16 features, float32 parameters and flows.  Unlike the reference's
    bf16 model, whose validity mask drops every warped feature map (see
    ``tests/test_torch_upflow_ops.py``), the warped features take part: the
    bf16 flow stays within 15 % of the float32 flow's magnitude."""
    kw = dict(**TINY, if_norm_before_cost_volume=True, norm_moments_across_channels=False,
              norm_moments_across_images=False)
    net32 = UPFlowNet(UPFlowConfig(**kw), device="cpu", seed=1)
    net16 = UPFlowNet(UPFlowConfig(**kw), dtype=torch.bfloat16, device="cpu", seed=1)
    im1, im2 = _frames((1, 64, 128, 3), 7)
    with torch.no_grad():
        f32 = net32(_nchw(im1), _nchw(im2))
        f16 = net16(_nchw(im1), _nchw(im2))
    assert f16["flow_f"].dtype == torch.float32
    assert all(f.dtype == torch.float32 for pair in f16["flows"] for f in pair)
    assert next(net16.parameters()).dtype == torch.float32
    scale = float(f32["flow_f"].abs().max())
    assert float((f16["flow_f"] - f32["flow_f"]).abs().max()) < 0.15 * scale


def test_sgu_sharpens_misplaced_motion_boundary():
    """Twin of the reference's semantic SGU test: trained alone for 120 Adam
    steps, the warp-and-blend upsampler must pull a blurred, misplaced motion
    boundary onto the edge its guidance features carry, and beat the bilinear
    upsample's error by a wide margin (a module that returned its input
    unchanged scores 1.0).  Whether it gets there depends on the drawn weights
    (of four seeds two reach an error of 0 within 50 steps, one stalls at 0.86
    of the baseline for 300); the seed is fixed to one that does."""
    torch.manual_seed(0)
    h = w = 32
    edge = 13
    col = torch.arange(w, dtype=torch.float32).view(1, 1, 1, w)
    sharp = torch.where(col < edge, 2.0, 0.0).expand(1, 1, h, w)
    gt = torch.cat([sharp, torch.zeros_like(sharp)], dim=1)  # dy only
    ramp = (((20.0 - col) / 8.0).clamp(0, 1) * 2.0).expand(1, 1, h, w)
    flow_init = torch.cat([ramp, torch.zeros_like(ramp)], dim=1)
    g = torch.where(col < edge, 1.0, -1.0).expand(1, 4, h, w).contiguous()
    sgu = tupflow.SGUModel(torch.Generator().manual_seed(0), feat_channels=4)
    baseline = float((flow_init - gt).abs().mean())
    opt = torch.optim.Adam(sgu.parameters(), lr=1e-2)
    for _ in range(120):
        opt.zero_grad()
        loss = (sgu(flow_init, g, g) - gt).abs().mean()
        loss.backward()
        opt.step()
    with torch.no_grad():
        final = float((sgu(flow_init, g, g) - gt).abs().mean())
        full = gt.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        out_full = sgu(gt, g, g, output_level_flow=full)
    assert final < 0.5 * baseline, f"{final:.4f} vs bilinear {baseline:.4f}"
    assert out_full.shape == full.shape and bool(torch.isfinite(out_full).all())


def test_bf16_model_matches_jax_bf16_with_a_float32_mask(monkeypatch):
    """The training default's numerics against the reference: bf16 features,
    float32 flows, bridged weights, a smooth texture moved by (2, -3) px.

    The reference's bf16 validity mask is compared after a cast to bf16 (0.998
    rounds to 1.0, and no bf16 value lies between 0.9999 and 1, so ``> 0.9999``
    drops every warped feature map); here the reference's ``warp_with_mask``
    is replaced, for this test only, by the same function with the mask kept
    in float32, which is what the port computes.

    Either side rounds each feature map to bf16 after sums in its own order,
    and the differences pass through five decode levels, so the bounds are
    those of bf16 itself: on every output the mean difference within 2 % of the
    reference's mean flow component (measured at most 1.1 %) and the largest
    within 25 % of its largest (measured 14 % at the finest level: single
    pixels where a validity mask on the threshold falls the other way; the
    reference's own bf16 model lies as far from its float32 model)."""
    from opticalflowscivis_tpu.ops.warp import backward_warp

    def warp_with_float32_mask(feature, flow, fast_r=0):
        warped = backward_warp(feature, flow, padding="zeros")
        ones = jnp.ones(feature.shape[:-1] + (1,), jnp.float32)
        _, mask = backward_warp(ones, flow, padding="zeros", return_mask=True)
        return warped * (mask > 0.9999).astype(warped.dtype)

    shape = (2, 64, 128, 3)
    jcfg = JaxUPFlowConfig(**TINY, if_norm_before_cost_volume=True,
                           norm_moments_across_channels=False, norm_moments_across_images=False)
    jnet = JaxUPFlowNet(cfg=jcfg, dtype=jnp.bfloat16)
    params = numpy_params(jnet, shape, 11)
    cfg = UPFlowConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    net = UPFlowNet(cfg, dtype=torch.bfloat16, device="cpu")
    net.load_state_dict(upflow_params_from_flax(params), strict=True)
    coarse = torch.from_numpy(
        np.random.default_rng(11).uniform(0.05, 1, (2, 3, 8, 16)).astype(np.float32))
    im1 = torch.nn.functional.interpolate(coarse, size=shape[1:3], mode="bicubic",
                                          align_corners=True).clamp(0, 1)
    im1 = im1.permute(0, 2, 3, 1).numpy()
    im2 = np.roll(im1, (2, -3), axis=(1, 2))

    def both(p, a, b):
        """The reference as it stands and with the float32 mask, in one
        compiled function (the replacement acts while it is traced)."""
        unpatched = jnet.apply(p, a, b)
        with monkeypatch.context() as m:
            m.setattr(jupflow, "warp_with_mask", warp_with_float32_mask)
            return unpatched, jnet.apply(p, a, b)

    unpatched, ref = jax.jit(both)(params, im1, im2)
    with torch.no_grad():
        out = net.eval()(_nchw(im1), _nchw(im2))

    def distance(got, want):
        want = np.asarray(want, np.float32)
        diff = np.abs(_nhwc(got) - want)
        return diff.mean() / np.abs(want).mean(), diff.max() / np.abs(want).max()

    for key in ("flow_f", "flow_b"):
        assert out[key].dtype == torch.float32
        mean, top = distance(out[key], ref[key])
        assert mean <= 0.02 and top <= 0.25, (key, mean, top)
    for level, ((of, ob), (rf, rb)) in enumerate(zip(out["flows"], ref["flows"])):
        for got, want in ((of, rf), (ob, rb)):
            mean, top = distance(got, want)
            assert mean <= 0.02 and top <= 0.25, (level, mean, top)
    # the replaced mask matters: the reference as it stands, with every warped
    # feature map dropped, lies several times further from the port
    mean, _ = distance(out["flow_f"], unpatched["flow_f"])
    assert mean > 0.05, mean
