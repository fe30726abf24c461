"""PyTorch port: IFNet-2D with bridged weights against the JAX ``IFNet``.

Narrow blocks (16, 12, 8), teacher 8, at [2, 64, 96, 1], float32.  The JAX
model warps unbounded on the CPU while the port clips to ±16, so every case
asserts max |flow| < 16 first: only then does the comparison mean something.
Tolerance 2e-5: float32 convolutions summed in other orders, carried by the
warps from the flows into the merged frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowscivis_tpu.models import IFNet as JaxIFNet
from opticalflowscivis_tpu.models import ifnet_2d as jax_ifnet_2d
from opticalflowscivis_tpu_torch.bridge import ifnet_params_from_flax
from opticalflowscivis_tpu_torch.models import IFNet, ifnet_2d

NARROW = {"block_channels": (16, 12, 8), "teacher_channels": 8}
SHAPE = (2, 64, 96, 1)
R = 16
TOL = 2e-5


def _frames(seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, SHAPE).astype(np.float32) for _ in range(3)]


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def numpy_params(jnet, seed):
    """Params of ``jnet`` (teacher included) drawn with numpy: LeCun-scaled
    kernels, nonzero biases and slopes, so that every leaf's mapping shows."""
    x = jax.ShapeDtypeStruct(SHAPE, jnp.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, x, x)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "slope" in name:
            return rng.uniform(0.1, 0.4, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "timestep"])
def pair_of_models(request):
    """(jitted JAX apply, its numpy params, port model with the bridged weights)."""
    ts = request.param
    jnet = JaxIFNet(ndim=2, arbitrary_timestep=ts, **NARROW)
    params = numpy_params(jnet, seed=int(ts))
    net = IFNet(arbitrary_timestep=ts, fast_warp_r=R, device="cpu", **NARROW)
    net.load_state_dict(ifnet_params_from_flax(params), strict=True)
    return jax.jit(jnet.apply), params, net.eval()


def test_bridge_maps_every_leaf_once(pair_of_models):
    _, params, net = pair_of_models
    leaves = jax.tree_util.tree_leaves_with_path(params)
    state = ifnet_params_from_flax(params)
    assert len(state) == len(leaves) == len(net.state_dict())
    assert set(state) == set(net.state_dict())
    for key, value in net.state_dict().items():
        assert state[key].shape == value.shape, key


def test_bridge_full_width_matches_ifnet_2d():
    """The full-width JAX ``ifnet_2d`` params bridge onto the port's
    ``ifnet_2d`` key for key and shape (abstract init: no weights computed)."""
    x = jax.ShapeDtypeStruct((1, 32, 32, 1), jnp.float32)
    shapes = jax.eval_shape(jax_ifnet_2d().init, jax.random.PRNGKey(0), x, x, x)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    net = ifnet_2d(device="cpu")
    net.load_state_dict(ifnet_params_from_flax(zeros), strict=True)
    assert [net.get_submodule(f"block{i}").conv0[1].conv.out_channels for i in range(3)] == [
        128, 96, 64,
    ]


def test_bridge_rejects_unknown_leaf():
    tree = {"params": {"block0": {"Mystery_0": {"kernel": np.zeros((3, 3, 1, 1))}}}}
    with pytest.raises(KeyError):
        ifnet_params_from_flax(tree)


@pytest.mark.parametrize("with_gt", [False, True], ids=["student", "teacher"])
def test_ifnet_matches_jax(pair_of_models, with_gt):
    apply, params, net = pair_of_models
    a, b, g = _frames(1)
    ref = apply(params, a, b, g if with_gt else None, timestep=0.3)
    with torch.no_grad():
        out = net(_nchw(a), _nchw(b), _nchw(g) if with_gt else None, timestep=0.3)

    flows = list(ref["flow_list"]) + ([ref["flow_teacher"]] if with_gt else [])
    assert max(float(jnp.abs(f).max()) for f in flows) < R
    for key in ("flow_list", "mask_list", "merged"):
        assert len(out[key]) == 3
        for r_i, o_i in zip(ref[key], out[key]):
            np.testing.assert_allclose(_nhwc(o_i), np.asarray(r_i), atol=TOL, err_msg=key)
    if with_gt:
        for key in ("flow_teacher", "merged_teacher"):
            np.testing.assert_allclose(_nhwc(out[key]), np.asarray(ref[key]), atol=TOL,
                                       err_msg=key)
        assert float(out["loss_distill"]) > 0
    else:
        assert out["flow_teacher"] is None and out["merged_teacher"] is None
    assert float(out["loss_distill"]) == pytest.approx(float(ref["loss_distill"]), abs=TOL)


def test_ifnet_bf16_compute_tracks_f32(pair_of_models):
    """fp32 params with bf16 compute stay near the f32 forward (bf16 keeps
    ~3 significant digits through 39 layers; 5e-2 on [0, 1] frames)."""
    _, params, net = pair_of_models
    net16 = IFNet(arbitrary_timestep=net.arbitrary_timestep, fast_warp_r=R,
                  dtype=torch.bfloat16, device="cpu", **NARROW)
    net16.load_state_dict(net.state_dict())
    a, b, _ = _frames(2)
    with torch.no_grad():
        m32 = net(_nchw(a), _nchw(b))["merged"][-1]
        m16 = net16(_nchw(a), _nchw(b))["merged"][-1]
    assert m16.dtype == torch.bfloat16
    assert next(net16.parameters()).dtype == torch.float32
    np.testing.assert_allclose(m16.float().numpy(), m32.numpy(), atol=5e-2)


@pytest.mark.parametrize("kw, error, match", [
    ({"ndim": 4}, ValueError, "ndim"),
    ({"scales": (4, 2)}, ValueError, "scale"),
])
def test_unported_variants_raise(kw, error, match):
    with pytest.raises(error, match=match):
        IFNet(device="cpu", **NARROW, **kw)


def test_2d_model_refuses_volumes():
    net = IFNet(device="cpu", **NARROW)
    with pytest.raises(ValueError, match="2 spatial axes"):
        net(torch.zeros(1, 1, 8, 8, 8), torch.zeros(1, 1, 8, 8, 8))
