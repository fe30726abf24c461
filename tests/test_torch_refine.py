"""PyTorch port: the Contextnet/Unet refinement of ``IFNet(refine=True)``
against the JAX package, values and gradients, with weights carried over
by ``bridge.ifnet_params_from_flax``.

Narrow IFNet blocks (16, 12, 8), teacher 8; the refinement keeps the
reference's own width (Contextnet and Unet at c = 16).  Both sides warp
unbounded (``fast_warp_r=0``; on the CPU the JAX model never bounds its
warps), float32 on the CPU.  Tolerances are stated at each comparison.
"""

import dataclasses
import os
import pickle

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowscivis_tpu.losses import rife_losses as jax_rife_losses
from opticalflowscivis_tpu.models import IFNet as JaxIFNet
from opticalflowscivis_tpu.models.refine import Contextnet as JaxContextnet
from opticalflowscivis_tpu.models.refine import Unet as JaxUnet
from opticalflowscivis_tpu.training import TrainConfig as JaxTrainConfig
from opticalflowscivis_tpu.training import build_model as jax_build_model
from opticalflowscivis_tpu.training.trainer import split_batch as jax_split_batch
from opticalflowscivis_tpu_torch.bridge import ifnet_params_from_flax
from opticalflowscivis_tpu_torch.cli.__main__ import main as cli
from opticalflowscivis_tpu_torch.data import group_tuples, rectangle_2d
from opticalflowscivis_tpu_torch.losses import RIFELossWeights
from opticalflowscivis_tpu_torch.models import Contextnet, IFNet, Unet
from opticalflowscivis_tpu_torch.ops.kernels import warp as kernels_warp
from opticalflowscivis_tpu_torch.training import ModelConfig, OptimConfig, TrainConfig, Trainer

NARROW = {"block_channels": (16, 12, 8), "teacher_channels": 8}
SHAPE_2D = (2, 32, 48, 1)
SHAPE_3D = (1, 16, 16, 16, 1)
# forward values: float32 convolutions summed in other orders, carried by the
# warps from the flows into the merged frames (tests/test_torch_ifnet.py's)
TOL = 2e-5
# gradients, relative to the largest element of each reference gradient:
# float32 sums of a few thousand products in other orders
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers side by side: a few threads each keep
    the many small ops of these tests from fighting over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _draw(seed):
    """A numpy draw for a flax param leaf: LeCun-scaled kernels, nonzero
    biases and slopes, so that every leaf's mapping shows."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "slope" in name:
            return rng.uniform(0.1, 0.4, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    return draw


def numpy_params(init, args, seed):
    """Params of a flax ``init`` drawn with numpy on its abstract shapes."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map_with_path(_draw(seed), shapes)


def _cf(x):
    return torch.from_numpy(np.array(x)).movedim(-1, 1)


def _cl(t):
    return t.detach().movedim(1, -1).numpy()


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0, err_msg=what)


# -- Contextnet and Unet alone, 2-D and 3-D ----------------------------------------


class _JaxRefine(fnn.Module):
    """The reference's refinement step as ``IFNet`` wires it: one Contextnet
    for both frames, then the Unet."""

    ndim: int

    @fnn.compact
    def __call__(self, img0, img1, warped0, warped1, mask, flow):
        nd = self.ndim
        ctx = JaxContextnet(nd, name="contextnet")
        c0 = ctx(img0, flow[..., :nd])
        c1 = ctx(img1, flow[..., nd:])
        res = JaxUnet(nd, out_channels=img0.shape[-1], name="unet")(
            img0, img1, warped0, warped1, mask, flow, c0, c1)
        return c0, c1, res


def _refine_inputs(shape, seed):
    nd = len(shape) - 2
    rng = np.random.default_rng(seed)
    imgs = [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(4)]
    mask = rng.standard_normal(shape[:-1] + (1,)).astype(np.float32)
    # continuous flows, some beyond the coarse levels' extent
    flow = (rng.standard_normal(shape[:-1] + (2 * nd,)) * 3).astype(np.float32)
    return imgs + [mask, flow]


def _port_refine(params, nd, in_ch):
    state = ifnet_params_from_flax(params)
    gen = torch.Generator().manual_seed(0)
    ctx = Contextnet(in_ch, gen, nd)
    unet = Unet(4 * in_ch + 1 + 2 * nd, gen, nd, out_channels=in_ch)
    for name, module in (("contextnet", ctx), ("unet", unet)):
        module.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()
                                if k.startswith(name + ".")}, strict=True)
    return ctx, unet


@pytest.mark.parametrize("shape", [SHAPE_2D, SHAPE_3D], ids=["2d", "3d"])
def test_contextnet_and_unet_match_jax(shape):
    """Values and every gradient (inputs and weights) of the refinement step
    against the reference's, through a weighted sum of all its outputs."""
    nd = len(shape) - 2
    jmod = _JaxRefine(nd)
    inputs = _refine_inputs(shape, seed=nd)
    params = numpy_params(jmod.init, inputs, seed=10 + nd)
    c0_s, c1_s, res_s = jax.eval_shape(jmod.apply, params, *inputs)
    rng = np.random.default_rng(20 + nd)
    weights = [rng.standard_normal(t.shape).astype(np.float32)
               for t in list(c0_s) + list(c1_s) + [res_s]]

    def objective(p, *xs):
        c0, c1, res = jmod.apply(p, *xs)
        return sum(jnp.sum(t * w) for t, w in zip(list(c0) + list(c1) + [res], weights)), (
            c0, c1, res)

    # the outputs and every gradient in one compiled function
    jgrads, (ref_c0, ref_c1, ref_res) = jax.jit(
        jax.grad(objective, argnums=tuple(range(7)), has_aux=True))(params, *inputs)

    ctx, unet = _port_refine(params, nd, shape[-1])
    xs = [_cf(x).clone().requires_grad_(True) for x in inputs]
    img0, img1, w0, w1, mask, flow = xs
    c0 = ctx(img0, flow[:, :nd])
    c1 = ctx(img1, flow[:, nd:])
    res = unet(img0, img1, w0, w1, mask, flow, c0, c1)
    outs = list(c0) + list(c1) + [res]
    for i, (o, r) in enumerate(zip(outs, list(ref_c0) + list(ref_c1) + [ref_res])):
        assert o.shape == _cf(r).shape
        _close(_cl(o), r, TOL, f"output {i}")
    sum((o * _cf(w)).sum() for o, w in zip(outs, weights)).backward()

    for name, x, g in zip(("img0", "img1", "warped0", "warped1", "mask", "flow"), xs, jgrads[1:]):
        _close(_cl(x.grad), g, GRAD_TOL * float(np.abs(g).max()), f"d{name}")
    ref_state = ifnet_params_from_flax(jax.tree.map(np.asarray, jgrads[0]))
    named = {**{f"contextnet.{k}": p for k, p in ctx.named_parameters()},
             **{f"unet.{k}": p for k, p in unet.named_parameters()}}
    assert set(named) == set(ref_state)
    for key, p in named.items():
        want = ref_state[key].numpy()
        _close(p.grad.numpy(), want, GRAD_TOL * float(np.abs(want).max()), f"d{key}")


def test_contextnet_resizes_each_stage_from_the_previous_flow():
    """Stage i warps by the flow resized from stage i-1's, not from the input
    flow: on a linear ramp both agree, on a random flow they do not."""
    gen = torch.Generator().manual_seed(0)
    ctx = Contextnet(1, gen, 2)
    x = torch.rand(1, 1, 32, 32, generator=gen)
    flow = torch.randn(1, 2, 32, 32, generator=gen) * 3
    seen = []
    original = kernels_warp.warp2d_plain

    def spy(img, fl, r, padding):
        seen.append((fl.clone(), r, padding))
        return original(img, fl, r, padding)

    kernels_warp.warp2d_plain = spy
    try:
        feats = ctx(x, flow)
    finally:
        kernels_warp.warp2d_plain = original
    assert [tuple(f.shape) for f in feats] == [(1, 16, 16, 16), (1, 32, 8, 8), (1, 64, 4, 4),
                                               (1, 128, 2, 2)]
    assert [(r, p) for _, r, p in seen] == [(0, "border")] * 4
    from opticalflowscivis_tpu_torch.ops.resize import resize_flow_nchw

    chained = flow
    for (fl, _, _), size in zip(seen, (16, 8, 4, 2)):
        chained = resize_flow_nchw(chained, (size, size))
        assert torch.equal(fl, chained)
    direct = resize_flow_nchw(flow, (2, 2))
    assert not torch.allclose(seen[-1][0], direct)


# -- IFNet(refine=True) ---------------------------------------------------------


@pytest.fixture(scope="module")
def refine_models():
    """(jitted JAX apply, its numpy params, port model with the bridged weights)."""
    jnet = JaxIFNet(ndim=2, refine=True, **NARROW)
    x = jax.ShapeDtypeStruct(SHAPE_2D, jnp.float32)
    params = numpy_params(jnet.init, (x, x, x), seed=3)
    net = IFNet(refine=True, fast_warp_r=0, device="cpu", **NARROW)
    net.load_state_dict(ifnet_params_from_flax(params), strict=True)
    return jax.jit(jnet.apply), params, net.eval()


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(3)]


def test_bridge_maps_every_refine_leaf_once(refine_models):
    _, params, net = refine_models
    leaves = jax.tree_util.tree_leaves_with_path(params)
    state = ifnet_params_from_flax(params)
    assert len(state) == len(leaves) == len(net.state_dict())
    assert set(state) == set(net.state_dict())
    for key, value in net.state_dict().items():
        assert state[key].shape == value.shape, key
    refine_keys = [k for k in state if k.startswith(("contextnet.", "unet."))]
    # Contextnet: 4 Conv2 x 2 ConvPReLU x (kernel, bias, slope); Unet: 4 Conv2
    # as many, 4 DeconvPReLU x 3, the last conv's kernel and bias
    assert len(refine_keys) == 24 + 24 + 12 + 2
    # the transposed convs are flipped on every spatial axis, the convs are not
    p = params["params"]["unet"]
    np.testing.assert_array_equal(
        state["unet.up0.deconv.weight"].numpy(),
        np.flip(np.asarray(p["DeconvPReLU_0"]["ConvTranspose_0"]["kernel"]).transpose(2, 3, 0, 1),
                axis=(2, 3)))
    np.testing.assert_array_equal(state["unet.conv.weight"].numpy(),
                                  np.asarray(p["Conv_0"]["kernel"]).transpose(3, 2, 0, 1))


def test_bridge_rejects_unknown_refine_leaf():
    tree = {"params": {"contextnet": {"Conv2_0": {"Mystery_0": {"kernel": np.zeros((3, 3, 1, 1))}}}}}
    with pytest.raises(KeyError, match="unmapped"):
        ifnet_params_from_flax(tree)


@pytest.mark.parametrize("with_gt", [False, True], ids=["student", "teacher"])
def test_ifnet_refine_matches_jax(refine_models, with_gt):
    apply, params, net = refine_models
    a, b, g = _frames(SHAPE_2D, 1)
    ref = apply(params, a, b, g if with_gt else None)
    with torch.no_grad():
        out = net(_cf(a), _cf(b), _cf(g) if with_gt else None)
    for key in ("flow_list", "mask_list", "merged"):
        assert len(out[key]) == 3
        for r_i, o_i in zip(ref[key], out[key]):
            _close(_cl(o_i), r_i, TOL, key)
    if with_gt:
        for key in ("flow_teacher", "merged_teacher"):
            _close(_cl(out[key]), ref[key], TOL, key)
    assert float(out["loss_distill"]) == pytest.approx(float(ref["loss_distill"]), abs=TOL)

    # only the last merged frame is refined, and the refinement moved it (two
    # forwards of the same weights agree to float32 rounding: the CPU's
    # convolutions may sum in another order from call to call)
    net.refine = False
    try:
        with torch.no_grad():
            plain = net(_cf(a), _cf(b), _cf(g) if with_gt else None)
    finally:
        net.refine = True
    for i in range(2):
        torch.testing.assert_close(plain["merged"][i], out["merged"][i], rtol=0, atol=1e-6)
    assert float((plain["merged"][-1] - out["merged"][-1]).abs().max()) > 1e-2
    # the distillation sees the unrefined merges
    torch.testing.assert_close(plain["loss_distill"], out["loss_distill"], rtol=0, atol=1e-6)


def test_ifnet_3d_refine_matches_jax():
    """3-D, unbounded on both sides (``bounded_warp_rz=0``), teacher included."""
    kw = {"block_channels": (8, 8, 8), "teacher_channels": 8, "conv0_kernel": 4}
    jnet = JaxIFNet(ndim=3, refine=True, **kw)
    x = jax.ShapeDtypeStruct(SHAPE_3D, jnp.float32)
    params = numpy_params(jnet.init, (x, x, x), seed=4)
    net = IFNet(ndim=3, refine=True, device="cpu", **kw).eval()
    net.load_state_dict(ifnet_params_from_flax(params), strict=True)
    a, b, g = _frames(SHAPE_3D, 2)
    ref = jax.jit(jnet.apply)(params, a, b, g)
    with torch.no_grad():
        out = net(_cf(a), _cf(b), _cf(g))
    for key in ("flow_list", "merged"):
        for r_i, o_i in zip(ref[key], out[key]):
            _close(_cl(o_i), r_i, TOL, key)
    _close(_cl(out["merged_teacher"]), ref["merged_teacher"], TOL, "merged_teacher")


def test_refine_forward_counts_its_warps(refine_models, monkeypatch):
    """The warps a refine forward hands ``warp2d`` (the kernel's launches on
    the card): 6 for the student, 4 more with the teacher, 8 for the two
    context pyramids, those at 16-128 channels and r = 0; under training
    every context warp's image carries a gradient (the kernel's ``dimg``)."""
    _, _, net = refine_models
    calls = []
    original = kernels_warp.warp2d_plain

    def spy(img, flow, r, padding):
        calls.append((img.shape[1], r, img.requires_grad))
        return original(img, flow, r, padding)

    monkeypatch.setattr(kernels_warp, "warp2d_plain", spy)
    a, b, g = (_cf(x) for x in _frames(SHAPE_2D, 5))
    with torch.no_grad():
        net(a, b)
    assert len(calls) == 14
    assert sorted(c for c, _, _ in calls[6:]) == [16, 16, 32, 32, 64, 64, 128, 128]
    calls.clear()
    net(a, b, g)["merged"][-1].sum().backward()
    assert len(calls) == 16
    assert [grad for c, _, grad in calls if c > 1] == [True] * 8
    assert not any(grad for c, _, grad in calls if c == 1)
    net.zero_grad(set_to_none=True)


# -- training -------------------------------------------------------------------


def _train_config(tmp, **kw):
    kw.setdefault("epochs", 1)
    return TrainConfig(
        dataset="rectangle2d", batch_size=4,
        model=ModelConfig(block_channels=(16, 12, 8), teacher_channels=8, bfloat16=False,
                          refine=True, fast_warp_r=0),
        loss=RIFELossWeights.preset_2d(flow_supervised=True),
        data_dir=os.path.join(tmp, "d"), log_dir=os.path.join(tmp, "l"),
        results_dir=os.path.join(tmp, "r"),
        optim=OptimConfig(lr_max=1e-3, warmup_steps=2), **kw,
    )


def _textured_tuples(n_frames, seed):
    """Box tuples with a random texture: on the box data's exactly flat
    background the photometric term's gradient is float32 rounding
    (tests/test_torch_training.py)."""
    tuples = group_tuples(rectangle_2d(n_frames=n_frames, grid=(32, 32), box=(10, 14),
                                       seed=seed), 1).astype(np.float32)
    tuples[..., 0] += np.random.default_rng(seed).uniform(0.05, 0.3, tuples.shape[:-1]).astype(
        np.float32)
    return tuples


def test_refine_train_step_matches_jax(tmp_path):
    """One train step from bridged weights: the loss parts (rtol 2e-5) and
    every parameter's gradient (``GRAD_TOL`` of its largest element) against
    the reference's loss under ``jax.value_and_grad``."""
    cfg = _train_config(str(tmp_path))
    jcfg = JaxTrainConfig.from_json(cfg.to_json())
    jmodel = jax_build_model(jcfg)
    assert jmodel.refine
    x = jax.ShapeDtypeStruct((1, 32, 32, 1), jnp.float32)
    params = numpy_params(jmodel.init, (x, x, x), seed=7)
    batch = _textured_tuples(12, seed=1)[:4]

    def loss_fn(p, batch):
        img0, img1, gt, gt_flow = jax_split_batch(batch, 2, True)
        outputs = jmodel.apply(p, img0, img1, gt)
        return jax_rife_losses(outputs, img0, img1, gt, p, jcfg.loss, 2, gt_flow=gt_flow,
                               fast_warp_r=0)

    (_, jparts), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, batch)

    tr = Trainer(cfg, device="cpu")
    tr.model.load_state_dict(ifnet_params_from_flax(params), strict=True)
    tr.init_state(total_steps=4)
    parts = tr.train_step(tr.upload(batch))
    assert set(parts) == set(jparts)
    for key, ref in jparts.items():
        assert float(parts[key]) == pytest.approx(float(ref), rel=2e-5, abs=1e-9), key
    ref_grads = ifnet_params_from_flax(jax.tree.map(np.asarray, jgrads))
    named = dict(tr.model.named_parameters())
    assert set(named) == set(ref_grads)
    # float32 rounding of the loss terms reaches every gradient as an
    # absolute error: within 1e-5 of the model's largest gradient, and each
    # tensor within 1e-2 of its own largest element (its smallest tensors,
    # the first Contextnet and Unet stages, sit 1e-3 below the largest)
    largest = max(float(g.abs().max()) for g in ref_grads.values())
    for key in sorted(named):
        want = ref_grads[key].numpy()
        got = named[key].grad.numpy()
        _close(got, want, 1e-5 * largest, key)
        _close(got, want, 1e-2 * float(np.abs(want).max()), key)
    assert float(named["unet.conv.weight"].grad.abs().max()) > 0


def test_refine_fit_checkpoint_round_trip(tmp_path):
    """``Trainer.fit`` with refinement lowers the loss and writes
    ``loss.json``; its checkpoint carries ``contextnet`` and ``unet`` and a
    fresh trainer restores them and evaluates the same."""
    cfg = dataclasses.replace(_train_config(str(tmp_path), epochs=3), batch_size=8)
    tuples = group_tuples(rectangle_2d(n_frames=99, grid=(32, 32), box=(10, 14), seed=5), 1)
    tr = Trainer(cfg, device="cpu")
    hist = tr.fit(tuples[:24], tuples[24:32], epochs=3, log_every=0)
    assert len(hist) == 3 and all(np.isfinite(h["loss_G"]) for h in hist)
    assert hist[-1]["loss_G"] < hist[0]["loss_G"]
    assert os.path.isfile(os.path.join(tr.results_dir, "loss.json"))
    keys = set(torch.load(tr.checkpoint_path(), map_location="cpu", weights_only=True)["model"])
    assert any(k.startswith("contextnet.") for k in keys)
    assert any(k.startswith("unet.") for k in keys)

    fresh = Trainer(cfg, device="cpu")
    fresh.init_state(total_steps=9)
    assert fresh.load_checkpoint() and fresh.state.step == tr.state.step
    restored = fresh.model.state_dict()
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, restored[k]), k
    ours, theirs = tr.evaluate(tuples[24:32], 8), fresh.evaluate(tuples[24:32], 8)
    assert theirs == pytest.approx(ours, rel=1e-6, abs=1e-9)


def test_cli_train_and_serve_with_refine_from_config_json(tmp_path, capsys):
    """``train --config_json`` with ``"model": {"refine": true}``, then
    ``inference_video`` on the checkpoint it wrote."""
    cfg = _train_config(str(tmp_path))
    # a written 32 x 32 series in place of generate's 128 x 128 one
    os.makedirs(cfg.data_dir)
    with open(os.path.join(cfg.data_dir, "rectangle2d.pkl"), "wb") as f:
        pickle.dump(rectangle_2d(n_frames=30, grid=(32, 32), box=(10, 14), seed=0), f, protocol=4)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(dataclasses.replace(cfg, batch_size=8).to_json())
    common = ["--cpu", "--config_json", str(cfg_path)]
    cli(["train", *common])
    ckpt = os.path.join(cfg.log_dir, "rectangle2d", "flownet.ckpt")
    assert os.path.isfile(ckpt)
    cli(["inference_video", *common, "--factors", "2", "--max_frames", "5"])
    out = capsys.readouterr().out
    assert "No checkpoint" not in out
    assert "factor 2x" in out
