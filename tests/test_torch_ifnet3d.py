"""PyTorch port: IFNet-3D with bridged weights against the JAX ``IFNet(ndim=3)``,
and the 3-D ``Interpolator`` against the JAX one.

Narrow blocks (12, 8, 8), teacher 8, on 16^3 volumes, float32, ``r_z = 4``
(the JAX slab warp scans 2*r_z+3 taps).  On the CPU the JAX model clips
``flow_z`` only, while the port also clips the in-plane flow to ``±r_yx`` (the
TPU path's semantics), so every case asserts max |flow| < r first: only then
does the comparison mean something.  The numpy-drawn kernels are scaled down
for that.

Tolerance 1e-4: float32 convolutions summed in other orders through four
blocks, carried by the warps from the flows into the merged volumes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowscivis_tpu import inference as jinf
from opticalflowscivis_tpu.models import IFNet as JaxIFNet
from opticalflowscivis_tpu.models import ifnet_3d as jax_ifnet_3d
from opticalflowscivis_tpu_torch import inference as tinf
from opticalflowscivis_tpu_torch.bridge import ifnet_params_from_flax
from opticalflowscivis_tpu_torch.models import IFNet, ifnet_3d
from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES

NARROW = {"block_channels": (12, 8, 8), "teacher_channels": 8}
SHAPE = (2, 16, 16, 16, 1)
R = 4
TOL = 1e-4

CONFIGS = {
    "k4_teacher1": {"conv0_kernel": 4, "teacher_scale": 1, "scales": (4, 2, 1),
                    "bounded_warp_rz": R},
    "k3_teacher1": {"conv0_kernel": 3, "teacher_scale": 1, "scales": (4, 2, 1),
                    "bounded_warp_rz": R},
    "k3_teacher2": {"conv0_kernel": 3, "teacher_scale": 2, "scales": (4, 2, 2),
                    "bounded_warp_rz": R},
    "k4_teacher2": {"conv0_kernel": 4, "teacher_scale": 2, "scales": (4, 2, 2),
                    "bounded_warp_rz": R},
    "k4_unbounded": {"conv0_kernel": 4, "teacher_scale": 2, "scales": (4, 2, 2),
                     "bounded_warp_rz": 0},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small torch ops; with several test workers on one
    machine the intra-op thread pools oversubscribe the cores and such loops
    slow down a hundredfold.  One thread per worker is the fastest setting."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _volumes(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(3)]


def _cf(x):
    return torch.from_numpy(x).movedim(-1, 1)


def _cl(t):
    return t.detach().movedim(1, -1).numpy()


def numpy_params(jnet, seed, gain=0.7):
    """Params of ``jnet`` (teacher included) drawn with numpy on its abstract
    shapes: LeCun-scaled kernels times ``gain``, nonzero biases and slopes, so
    that every leaf's mapping shows."""
    x = jax.ShapeDtypeStruct(SHAPE, jnp.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, x, x)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (gain * rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "slope" in name:
            return rng.uniform(0.1, 0.4, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port_model(kw, params, **more):
    net = IFNet(ndim=3, fast_warp_r=R if kw["bounded_warp_rz"] else 0, device="cpu",
                **NARROW, **kw, **more)
    net.load_state_dict(ifnet_params_from_flax(params), strict=True)
    return net.eval()


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair_of_models(request):
    """(jitted JAX apply, its numpy params, port model with the bridged weights)."""
    kw = CONFIGS[request.param]
    jnet = JaxIFNet(ndim=3, **NARROW, **kw)
    params = numpy_params(jnet, seed=len(request.param))
    return jax.jit(jnet.apply), params, _port_model(kw, params)


def test_bridge_maps_every_3d_leaf_once(pair_of_models):
    _, params, net = pair_of_models
    leaves = jax.tree_util.tree_leaves_with_path(params)
    state = ifnet_params_from_flax(params)
    assert len(state) == len(leaves) == len(net.state_dict())
    for key, value in net.state_dict().items():
        assert state[key].shape == value.shape, key
    k = net.block0.conv0[0].conv.kernel_size
    assert k in ((3, 3, 3), (4, 4, 4)) and net.block0.conv0[1].conv.kernel_size == k
    # conv0_kernel reaches the two stride-2 convs only
    assert net.block0.convblock[0].convs[0].conv.kernel_size == (3, 3, 3)
    assert net.block0.conv0[0].conv.padding == ((k[0] - 1) // 2,) * 3


@pytest.mark.parametrize("with_gt", [False, True], ids=["student", "teacher"])
def test_ifnet3d_matches_jax(pair_of_models, with_gt):
    apply, params, net = pair_of_models
    a, b, g = _volumes(1)
    ref = apply(params, a, b, g if with_gt else None)
    before = dict(LAUNCHES)
    with torch.no_grad():
        out = net(_cf(a), _cf(b), _cf(g) if with_gt else None)
    assert LAUNCHES == before  # CPU tensors: the plain version, no launch

    flows = list(ref["flow_list"]) + ([ref["flow_teacher"]] if with_gt else [])
    largest = max(float(jnp.abs(f).max()) for f in flows)
    assert 0.05 < largest < R  # real flows, inside every clip
    for key in ("flow_list", "mask_list", "merged"):
        assert len(out[key]) == 3
        for r_i, o_i in zip(ref[key], out[key]):
            np.testing.assert_allclose(_cl(o_i), np.asarray(r_i), atol=TOL, err_msg=key)
    assert out["flow_list"][-1].shape == (2, 6, 16, 16, 16)
    if with_gt:
        for key in ("flow_teacher", "merged_teacher"):
            np.testing.assert_allclose(_cl(out[key]), np.asarray(ref[key]), atol=TOL,
                                       err_msg=key)
    else:
        assert out["flow_teacher"] is None and out["merged_teacher"] is None
    assert float(out["loss_distill"]) == pytest.approx(float(ref["loss_distill"]), abs=TOL)


def test_ifnet3d_timestep_channel_matches_jax():
    kw = CONFIGS["k4_teacher1"]
    jnet = JaxIFNet(ndim=3, arbitrary_timestep=True, **NARROW, **kw)
    params = numpy_params(jnet, seed=3)
    net = _port_model(kw, params, arbitrary_timestep=True)
    a, b, _ = _volumes(2)
    ref = jax.jit(jnet.apply)(params, a, b, None, timestep=0.3)
    with torch.no_grad():
        out = net(_cf(a), _cf(b), None, timestep=0.3)
    assert float(jnp.abs(ref["flow_list"][-1]).max()) < R
    np.testing.assert_allclose(_cl(out["merged"][-1]), np.asarray(ref["merged"][-1]), atol=TOL)
    np.testing.assert_allclose(_cl(out["flow_list"][-1]), np.asarray(ref["flow_list"][-1]),
                               atol=TOL)


def test_remat_gives_the_same_outputs_and_gradients():
    """``remat=True`` recomputes each IFBlock in the backward pass; values and
    parameter gradients stay those of the plain forward (the same arithmetic
    on the CPU: 1e-6 of the largest gradient)."""
    kw = CONFIGS["k3_teacher2"]
    plain = IFNet(ndim=3, fast_warp_r=R, device="cpu", seed=5, **NARROW, **kw)
    remat = IFNet(ndim=3, fast_warp_r=R, device="cpu", seed=5, remat=True, **NARROW, **kw)
    remat.load_state_dict(plain.state_dict())
    a, b, g = (_cf(v) for v in _volumes(4))
    grads = {}
    for name, net in (("plain", plain), ("remat", remat)):
        out = net(a, b, g)
        loss = (out["merged"][-1] - g).abs().mean() + (out["merged_teacher"] - g).abs().mean() \
            + out["loss_distill"]
        loss.backward()
        grads[name] = (float(loss.detach()), {n: p.grad for n, p in net.named_parameters()})
    assert grads["remat"][0] == pytest.approx(grads["plain"][0], rel=1e-6)
    largest = max(float(v.abs().max()) for v in grads["plain"][1].values())
    assert largest > 0
    for n, ref in grads["plain"][1].items():
        assert float((grads["remat"][1][n] - ref).abs().max()) <= 1e-6 * largest, n
    with torch.no_grad():  # without gradients there is nothing to recompute
        out = remat(a, b)
        np.testing.assert_allclose(out["merged"][-1].numpy(), plain(a, b)["merged"][-1].numpy(),
                                   atol=0)


def test_bridge_full_width_matches_ifnet_3d():
    """The full-width JAX ``ifnet_3d`` params bridge onto the port's
    ``ifnet_3d`` key for key and shape (abstract init: no weights computed),
    and both carry the same warp radii."""
    x = jax.ShapeDtypeStruct((1, 32, 32, 32, 1), jnp.float32)
    jnet = jax_ifnet_3d()
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, x, x)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    net = ifnet_3d(device="cpu")
    net.load_state_dict(ifnet_params_from_flax(zeros), strict=True)
    assert [net.get_submodule(f"block{i}").conv0[1].conv.out_channels for i in range(3)] == [
        128, 64, 64,
    ]
    assert net.block_tea.conv0[0].conv.kernel_size == (4, 4, 4)
    assert (net.bounded_warp_rz, net.fast_warp_r) == (jnet.bounded_warp_rz, jnet.fast_warp_r)
    assert net.ndim == 3 and not net.remat and net.teacher_scale == 1


def test_bridge_flips_every_axis_of_a_3d_transposed_kernel():
    """A missed axis would still give plausible outputs: pin the layout."""
    k = np.arange(4 * 4 * 4 * 2 * 3, dtype=np.float32).reshape(4, 4, 4, 2, 3)
    state = ifnet_params_from_flax({"block0": {"ConvTranspose_0": {"kernel": k},
                                               "ConvPReLU_0": {"Conv_0": {"kernel": k}}}})
    deconv = state["block0.flow_head.out.weight"].numpy()
    assert deconv.shape == (2, 3, 4, 4, 4)
    assert deconv[1, 2, 0, 1, 3] == k[3, 2, 0, 1, 2]
    conv = state["block0.conv0.0.conv.weight"].numpy()
    assert conv.shape == (3, 2, 4, 4, 4) and conv[2, 1, 0, 1, 3] == k[0, 1, 3, 1, 2]


def test_ifnet3d_bf16_compute_tracks_f32():
    """fp32 params with bf16 compute stay near the f32 forward (5e-2 on [0, 1]
    volumes, as in 2-D)."""
    kw = CONFIGS["k4_teacher1"]
    net = IFNet(ndim=3, fast_warp_r=R, device="cpu", seed=1, **NARROW, **kw).eval()
    net16 = IFNet(ndim=3, fast_warp_r=R, dtype=torch.bfloat16, device="cpu", **NARROW, **kw)
    net16.load_state_dict(net.state_dict())
    a, b, _ = _volumes(5)
    with torch.no_grad():
        m32 = net(_cf(a), _cf(b))["merged"][-1]
        m16 = net16.eval()(_cf(a), _cf(b))["merged"][-1]
    assert m16.dtype == torch.bfloat16
    assert next(net16.parameters()).dtype == torch.float32
    np.testing.assert_allclose(m16.float().numpy(), m32.numpy(), atol=5e-2)


# -- Interpolator on volumes --------------------------------------------------------


@pytest.fixture(scope="module")
def interps():
    """{tta: (JAX Interpolator, port Interpolator)} over the same weights."""
    kw = CONFIGS["k4_teacher1"]
    jnet = JaxIFNet(ndim=3, **NARROW, **kw)
    params = numpy_params(jnet, seed=7)
    net = _port_model(kw, params)
    return {
        tta: (jinf.Interpolator(jnet, params, pad_multiple=32, tta=tta),
              tinf.Interpolator(net, pad_multiple=32, tta=tta, device="cpu"))
        for tta in (False, True)
    }


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_interpolator_pair_matches_jax_on_volumes(interps, tta):
    """A 20x24x28 pair: edge pad to 32^3, crop back, flips over all three axes."""
    jint, tint = interps[tta]
    a, b, _ = _volumes(8, (1, 20, 24, 28, 1))
    ref = jint.pair(a, b)
    out = tint.pair(a, b)
    assert np.abs(ref[1]).max() < R
    for name, o, r, shape in zip(("merged", "flow", "mask"), out, ref,
                                 ((1, 20, 24, 28, 1), (1, 20, 24, 28, 6), (1, 20, 24, 28, 1))):
        assert o.shape == r.shape == shape, name
        np.testing.assert_allclose(o, r, atol=TOL, err_msg=name)


def test_interpolate_series_and_batched_pairs_on_volumes(interps):
    """The device-resident bisection path and ``batched_pair_inference`` take
    volumes: shapes, kept frames and the equality of both paths."""
    _, tint = interps[False]
    rng = np.random.default_rng(9)
    series = rng.uniform(0, 1, (5, 12, 16, 16, 1)).astype(np.float32)
    recon, flows = tinf.interpolate_series(tint, series, 2, collect_flow=True)
    assert recon.shape == (5, 12, 16, 16, 1) and flows.shape == (2, 12, 16, 16, 6)
    np.testing.assert_array_equal(recon[::2], series[::2])
    mid, _, _ = tint.pair(series[0:1], series[2:3])
    np.testing.assert_allclose(recon[1], mid[0], atol=1e-6)
    tuples = np.stack([series[[0, 2, 1]], series[[2, 4, 3]]])
    res = tinf.batched_pair_inference(tint, tuples, batch_size=1)
    assert res["pred"].shape == res["gt"].shape == (2, 12, 16, 16, 1)
    np.testing.assert_allclose(res["pred"], recon[[1, 3]], atol=1e-6)
    np.testing.assert_array_equal(res["gt"], series[[1, 3]])
