"""PyTorch port: the Hopper kernels' wrappers, and each kernel against its
plain version on the card.

This file imports no JAX, so it also runs on a GPU host without JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tests marked ``cuda`` skip without a CUDA device: a CUDA kernel has no CPU
mode.  Tolerances: f32 1e-5 (the same 4 taps summed in another order), bf16
one ulp of the output (the f32 sums may round to neighbouring bf16 values);
the cost volume's sums cancel, so its bf16 cases get the f32 tolerance on top.
The backward is held against autograd through the plain version: float32
within 1e-4 of the largest gradient (``dimg`` sums up to a few dozen
contributions per source pixel with atomics, in an order that changes from
run to run; ``dflow`` sums C terms), bfloat16 within 2 % of the largest
gradient (one rounding of the plain version's bf16 output path per term).
The 3-D kernels (8 taps) are held to the same tolerances.
"""

import numpy as np
import pytest
import torch

from opticalflowscivis_tpu_torch.ops import warp as tw
from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d, warp3d

VAL_TOL = 1e-5


def _inputs(seed, shape, flow_scale):
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    img = rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)
    flow = (rng.standard_normal((b, h, w, 2)) * flow_scale).astype(np.float32)
    return img, flow


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("r", [0, 4])
def test_warp2d_cpu_runs_plain_on_flow_slices(r, channels_last):
    """On CPU tensors the wrapper runs the plain version (no launch), and it
    reads a channel slice of a 4-channel flow in either memory layout."""
    img, flow = _inputs(4, (2, 9, 11, 2), 3.0)
    flow4 = torch.from_numpy(np.concatenate([flow * 0.5, flow], axis=-1)).permute(0, 3, 1, 2)
    if channels_last:
        flow4 = flow4.contiguous(memory_format=torch.channels_last)
    img_nchw = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous()
    before = LAUNCHES["warp2d"]
    out = warp2d(img_nchw, flow4[:, 2:4], r, "zeros")
    assert LAUNCHES["warp2d"] == before
    ref = tw.backward_warp_bounded(torch.from_numpy(img), torch.from_numpy(flow), r, "zeros")
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref.numpy(), atol=0)


@pytest.mark.parametrize(
    "kwargs",
    [
        {"padding": "reflect"},
        {"r": -1},
        {"flow_shape": (2, 3, 9, 11)},
        {"flow_shape": (2, 2, 9, 10)},
    ],
)
def test_warp2d_rejects_what_it_does_not_take(kwargs):
    img = torch.zeros(2, 1, 9, 11)
    flow = torch.zeros(kwargs.get("flow_shape", (2, 2, 9, 11)))
    with pytest.raises(ValueError):
        warp2d(img, flow, kwargs.get("r", 16), kwargs.get("padding", "border"))


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the warp kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_kernel_matches_plain_on_card(padding, dtype):
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    img, flow = _inputs(5, (3, 37, 53, 3), 10.0)  # ragged, flows beyond ±16
    img_t = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous().cuda().to(dt)
    flow_t = torch.from_numpy(flow).permute(0, 3, 1, 2).cuda().to(dt)
    for r in (16, 0):
        before = LAUNCHES["warp2d"]
        out = warp2d(img_t, flow_t, r, padding)
        torch.cuda.synchronize()
        assert LAUNCHES["warp2d"] == before + 1
        ref = tw.warp2d_plain(img_t, flow_t, r, padding)
        diff = (out.float() - ref.float()).abs()
        if dt == torch.float32:
            assert float(diff.max()) <= VAL_TOL
        else:  # one bf16 ulp of the output
            ulp = torch.pow(2.0, torch.floor(torch.log2(ref.float().abs().clamp_min(2.0**-126))) - 7)
            assert bool((diff <= ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("img_grad", [True, False], ids=["dimg", "no_dimg"])
@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [16, 0])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_kernel_backward_matches_plain_on_card(padding, r, dtype, channels_last, img_grad):
    """``dimg`` / ``dflow`` of the backward kernel against autograd through
    the plain version; flow (a slice of a 4-channel flow) and incoming
    gradient in NCHW or channels-last layout."""
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    img, flow = _inputs(8, (3, 37, 53, 3), 10.0)  # ragged, flows beyond ±16
    g = np.random.default_rng(9).standard_normal(img.shape).astype(np.float32)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    img_t = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous().cuda().to(dt)
    flow4 = torch.from_numpy(np.concatenate([flow * 0.5, flow], -1)).permute(0, 3, 1, 2)
    flow4 = flow4.cuda().to(dt).contiguous(memory_format=fmt)
    g_t = torch.from_numpy(g).permute(0, 3, 1, 2).cuda().to(dt).contiguous(memory_format=fmt)

    def through(fn):
        leaf = flow4.detach().clone(memory_format=torch.preserve_format).requires_grad_(True)
        im = img_t.detach().clone().requires_grad_(img_grad)
        fn(im, leaf[:, 2:4], r, padding).backward(g_t)
        return im.grad, leaf.grad

    before = dict(LAUNCHES)
    dimg, dflow = through(warp2d)
    torch.cuda.synchronize()
    assert LAUNCHES["warp2d"] == before["warp2d"] + 1
    assert LAUNCHES["warp2d_bwd"] == before["warp2d_bwd"] + 1
    dimg_ref, dflow_ref = through(tw.warp2d_plain)
    assert LAUNCHES["warp2d_bwd"] == before["warp2d_bwd"] + 1  # plain launches nothing
    rel = 1e-4 if dt == torch.float32 else 2e-2
    assert bool((dflow[:, :2] == 0).all())  # the unused half of the 4-channel flow
    scale = float(dflow_ref.float().abs().max())
    assert float((dflow.float() - dflow_ref.float()).abs().max()) <= rel * scale
    if img_grad:
        assert dimg.dtype == dt
        scale = float(dimg_ref.float().abs().max())
        assert float((dimg.float() - dimg_ref.float()).abs().max()) <= rel * scale
    else:
        assert dimg is None


@pytest.mark.cuda
def test_kernel_backward_zeroes_flow_gradient_on_the_bound_on_card():
    """A flow exactly on ±r is clamped: no gradient, as beyond it."""
    _cuda_or_skip()
    img = torch.rand(1, 1, 24, 24, device="cuda")
    flow = torch.full((1, 2, 24, 24), 0.3, device="cuda")
    flow[0, 0, :, :8] = 4.0
    flow[0, 1, :, 8:16] = -4.0
    flow[0, 0, :, 16:] = 5.5
    flow.requires_grad_(True)
    warp2d(img, flow, 4, "border").square().sum().backward()
    ref = flow.detach().clone().requires_grad_(True)
    tw.warp2d_plain(img, ref, 4, "border").square().sum().backward()
    assert bool((flow.grad[0, 0, :, :8] == 0).all())
    assert bool((flow.grad[0, 1, :, 8:16] == 0).all())
    assert bool((flow.grad[0, 0, :, 16:] == 0).all())
    assert bool((flow.grad[0, 1, :, :8] != 0).any())
    assert float((flow.grad - ref.grad).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_ifnet_forward_on_card_goes_through_the_kernel():
    """A narrow IFNet on the card launches warp2d twice per block and agrees
    with the same weights on the CPU (f32 convs in other orders: 1e-4)."""
    _cuda_or_skip()
    from opticalflowscivis_tpu_torch.models import IFNet

    torch.backends.cudnn.allow_tf32 = False
    kw = {"block_channels": (16, 12, 8), "teacher_channels": 8, "fast_warp_r": 16}
    net = IFNet(device="cuda", **kw).eval()
    cpu = IFNet(device="cpu", **kw).eval()
    a, b = (torch.from_numpy(_inputs(seed, (2, 64, 96, 1), 1.0)[0]).permute(0, 3, 1, 2)
            for seed in (6, 7))
    with torch.inference_mode():
        before = LAUNCHES["warp2d"]
        out = net(a.cuda(), b.cuda())["merged"][-1]
        torch.cuda.synchronize()
        assert LAUNCHES["warp2d"] == before + 6
        ref = cpu(a, b)["merged"][-1]
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), atol=1e-4)


@pytest.mark.cuda
def test_train_step_on_card_goes_through_both_kernels():
    """One narrow train step on the card launches 10 forward and 10 backward
    kernels, and its parts agree with the same step on the CPU (1e-4: f32
    convolutions in other orders)."""
    _cuda_or_skip()
    from opticalflowscivis_tpu_torch.data import group_tuples, rectangle_2d
    from opticalflowscivis_tpu_torch.losses import RIFELossWeights
    from opticalflowscivis_tpu_torch.training import ModelConfig, OptimConfig, TrainConfig, Trainer

    torch.backends.cudnn.allow_tf32 = False
    cfg = TrainConfig(
        dataset="rectangle2d", batch_size=4,
        model=ModelConfig(block_channels=(16, 12, 8), teacher_channels=8, bfloat16=False),
        loss=RIFELossWeights.preset_2d(flow_supervised=True),
        optim=OptimConfig(lr_max=1e-3, warmup_steps=2),
    )
    tuples = group_tuples(rectangle_2d(n_frames=12, grid=(32, 32), box=(10, 14), seed=5), 1)
    parts = {}
    for device in ("cuda", "cpu"):
        tr = Trainer(cfg, device=device)
        tr.init_state(total_steps=4)
        before = dict(LAUNCHES)
        parts[device] = tr.train_step(tr.upload(tuples))
        if device == "cuda":
            torch.cuda.synchronize()
            assert LAUNCHES["warp2d"] == before["warp2d"] + 10
            assert LAUNCHES["warp2d_bwd"] == before["warp2d_bwd"] + 10
        else:
            assert LAUNCHES == before
    for key, ref in parts["cpu"].items():
        assert float(parts["cuda"][key]) == pytest.approx(float(ref), abs=1e-4), key


# -- warp3d -----------------------------------------------------------------------

RADII = [(8, 8), (4, 0), (0, 0)]


def _inputs3d(seed, shape, flow_scale, off_integer=False):
    """Contiguous image ``[B, C, Z, Y, X]`` and a 6-channel flow whose last
    three channels the warp takes, float32 on the CPU."""
    rng = np.random.default_rng(seed)
    b, c, z, y, x = shape
    img = rng.uniform(0, 1, shape).astype(np.float32)
    flow6 = rng.standard_normal((b, 6, z, y, x)) * flow_scale
    if off_integer:
        flow6 = np.round(flow6 * 4) / 4 + 0.11
    return torch.from_numpy(img), torch.from_numpy(flow6.astype(np.float32))


def _ulp_bf16(ref):
    return torch.pow(2.0, torch.floor(torch.log2(ref.float().abs().clamp_min(2.0**-126))) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "channels_last_3d"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_warp3d_kernel_matches_plain_on_card(padding, dtype, layout):
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    img, flow6 = _inputs3d(5, (2, 3, 11, 13, 17), 6.0)  # ragged, flows beyond ±8
    img_t, flow6 = img.cuda().to(dt), flow6.cuda().to(dt)
    if layout == "channels_last_3d":
        flow6 = flow6.contiguous(memory_format=torch.channels_last_3d)
    flow_t = flow6[:, 3:]
    assert bool((flow_t.float().abs() > 8).any())
    for r_z, r_yx in RADII:
        before = LAUNCHES["warp3d"]
        out = warp3d(img_t, flow_t, r_z, r_yx, padding)
        torch.cuda.synchronize()
        assert LAUNCHES["warp3d"] == before + 1
        ref = tw.warp3d_plain(img_t, flow_t, r_z, r_yx, padding)
        assert LAUNCHES["warp3d"] == before + 1  # the plain version launches nothing
        assert out.dtype == dt and out.is_contiguous()
        diff = (out.float() - ref.float()).abs()
        if dt == torch.float32:
            assert float(diff.max()) <= VAL_TOL, (r_z, r_yx)
        else:
            assert bool((diff <= _ulp_bf16(ref)).all()), (r_z, r_yx)


@pytest.mark.cuda
@pytest.mark.parametrize("img_grad", [True, False], ids=["dimg", "no_dimg"])
@pytest.mark.parametrize("layout", ["contiguous", "channels_last_3d"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("radii", RADII, ids=["r8_8", "r4_0", "r0_0"])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_warp3d_kernel_backward_matches_plain_on_card(padding, radii, dtype, layout, img_grad):
    """``dimg`` / ``dflow`` of the 3-D backward kernel against autograd through
    the plain version; flow (a slice of a 6-channel flow) and incoming
    gradient contiguous or in the channels-last-3d layout."""
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    fmt = torch.channels_last_3d if layout == "channels_last_3d" else torch.contiguous_format
    img, flow6 = _inputs3d(8, (2, 3, 11, 13, 17), 6.0, off_integer=True)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(img.shape).astype(np.float32))
    img_t = img.cuda().to(dt)
    flow6 = flow6.cuda().to(dt).contiguous(memory_format=fmt)
    g_t = g.cuda().to(dt).contiguous(memory_format=fmt)

    def through(fn):
        leaf = flow6.detach().clone(memory_format=torch.preserve_format).requires_grad_(True)
        im = img_t.detach().clone().requires_grad_(img_grad)
        fn(im, leaf[:, 3:], *radii, padding).backward(g_t)
        return im.grad, leaf.grad

    before = dict(LAUNCHES)
    dimg, dflow = through(warp3d)
    torch.cuda.synchronize()
    assert LAUNCHES["warp3d"] == before["warp3d"] + 1
    assert LAUNCHES["warp3d_bwd"] == before["warp3d_bwd"] + 1
    dimg_ref, dflow_ref = through(tw.warp3d_plain)
    assert LAUNCHES["warp3d_bwd"] == before["warp3d_bwd"] + 1
    rel = 1e-4 if dt == torch.float32 else 2e-2
    assert bool((dflow[:, :3] == 0).all())  # the unused half of the 6-channel flow
    scale = float(dflow_ref.float().abs().max())
    assert float((dflow.float() - dflow_ref.float()).abs().max()) <= rel * scale
    flow = flow6[:, 3:].float()
    for component, r in ((slice(0, 1), radii[0]), (slice(1, 3), radii[1])):
        if r:  # exactly 0 at and beyond the bound
            clamped = flow[:, component].abs() >= r
            assert bool(clamped.any()) and bool((dflow[:, 3:][:, component][clamped] == 0).all())
    if img_grad:
        assert dimg.dtype == dt
        scale = float(dimg_ref.float().abs().max())
        assert float((dimg.float() - dimg_ref.float()).abs().max()) <= rel * scale
    else:
        assert dimg is None


@pytest.mark.cuda
def test_warp3d_kernel_zeroes_flow_gradient_on_the_bound_on_card():
    """A flow component exactly on its radius is clamped: no gradient."""
    _cuda_or_skip()
    img = torch.rand(1, 1, 12, 12, 12, device="cuda")
    flow = torch.full((1, 3, 12, 12, 12), 0.3, device="cuda")
    flow[0, 0, :4] = 4.0
    flow[0, 1, 4:8] = -2.0
    flow[0, 2, 8:] = 2.0
    flow.requires_grad_(True)
    warp3d(img, flow, 4, 2, "border").square().sum().backward()
    ref = flow.detach().clone().requires_grad_(True)
    tw.warp3d_plain(img, ref, 4, 2, "border").square().sum().backward()
    assert bool((flow.grad[0, 0, :4] == 0).all())
    assert bool((flow.grad[0, 1, 4:8] == 0).all())
    assert bool((flow.grad[0, 2, 8:] == 0).all())
    assert bool((flow.grad[0, 1, :4] != 0).any())
    assert float((flow.grad - ref.grad).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_warp3d_on_card_raises_on_what_the_kernel_does_not_take():
    _cuda_or_skip()
    img = torch.zeros(1, 1, 4, 4, 4, device="cuda")
    flow = torch.zeros(1, 3, 4, 4, 4, device="cuda")
    with pytest.raises(TypeError):
        warp3d(img, flow.bfloat16())
    with pytest.raises(TypeError):
        warp3d(img.half(), flow.half())
    with pytest.raises(ValueError):
        warp3d(img, flow.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        warp3d(torch.zeros(1, 4, 4, 4, 2, device="cuda").movedim(-1, 1), flow)


@pytest.mark.cuda
def test_ifnet3d_forward_on_card_goes_through_the_kernel():
    """A narrow IFNet-3D on the card launches warp3d twice per block and agrees
    with the same weights on the CPU (f32 convs in other orders: 1e-4)."""
    _cuda_or_skip()
    from opticalflowscivis_tpu_torch.models import IFNet

    torch.backends.cudnn.allow_tf32 = False
    kw = {"ndim": 3, "block_channels": (12, 8, 8), "teacher_channels": 8, "conv0_kernel": 4,
          "bounded_warp_rz": 8, "fast_warp_r": 8}
    net = IFNet(device="cuda", **kw).eval()
    cpu = IFNet(device="cpu", **kw).eval()
    a, b = (_inputs3d(seed, (2, 1, 32, 32, 32), 1.0)[0] for seed in (6, 7))
    with torch.inference_mode():
        before = dict(LAUNCHES)
        out = net(a.cuda(), b.cuda())["merged"][-1]
        torch.cuda.synchronize()
        assert LAUNCHES["warp3d"] == before["warp3d"] + 6
        assert LAUNCHES["warp2d"] == before["warp2d"]
        ref = cpu(a, b)["merged"][-1]
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_3d_train_step_on_card_goes_through_both_kernels(remat):
    """One narrow 3-D train step on the card launches 8 forward and 8 backward
    kernels (with ``remat`` too: the warps lie outside the recomputed blocks),
    and its parts agree with the same step on the CPU (1e-4)."""
    _cuda_or_skip()
    from opticalflowscivis_tpu_torch.data import group_tuples, rectangle_3d
    from opticalflowscivis_tpu_torch.losses import RIFELossWeights
    from opticalflowscivis_tpu_torch.training import ModelConfig, OptimConfig, TrainConfig, Trainer

    torch.backends.cudnn.allow_tf32 = False
    cfg = TrainConfig(
        dataset="rectangle3d", batch_size=2,
        model=ModelConfig(ndim=3, block_channels=(12, 8, 8), teacher_channels=8, conv0_kernel=4,
                          bounded_warp_rz=8, fast_warp_r=8, bfloat16=False, remat=remat),
        loss=RIFELossWeights.preset_3d(distill=0.1),
        optim=OptimConfig(lr_max=1e-3, warmup_steps=2),
    )
    tuples = group_tuples(rectangle_3d(n_frames=6, grid=(32, 32, 32), box=(10, 14, 12), seed=5), 1)
    tuples = tuples.astype(np.float32)
    tuples[..., 0] += np.random.default_rng(0).uniform(0.05, 0.3, tuples.shape[:-1]).astype(
        np.float32)
    parts = {}
    for device in ("cuda", "cpu"):
        tr = Trainer(cfg, device=device)
        tr.init_state(total_steps=4)
        before = dict(LAUNCHES)
        parts[device] = tr.train_step(tr.upload(tuples))
        if device == "cuda":
            torch.cuda.synchronize()
            assert LAUNCHES["warp3d"] == before["warp3d"] + 8
            assert LAUNCHES["warp3d_bwd"] == before["warp3d_bwd"] + 8
            _, extras = tr.eval_step(tr.upload(tuples))
            assert LAUNCHES["warp3d"] == before["warp3d"] + 16
            assert LAUNCHES["warp3d_bwd"] == before["warp3d_bwd"] + 8
            assert extras["pred"].shape == (2, 32, 32, 32, 1)
        else:
            assert LAUNCHES == before
    for key, ref in parts["cpu"].items():
        assert float(parts["cuda"][key]) == pytest.approx(float(ref), abs=1e-4), key


# -- corr -------------------------------------------------------------------------


def test_cost_volume_wrapper_cpu_runs_plain_and_checks_its_arguments():
    """CPU tensors take the plain version (no launch); what the kernel does
    not take raises before any device is asked for."""
    from opticalflowscivis_tpu_torch.ops.correlation import cost_volume_plain
    from opticalflowscivis_tpu_torch.ops.kernels.correlation import cost_volume_kernel

    f1, f2 = torch.randn(2, 5, 7, 9), torch.randn(2, 5, 7, 9)
    before = dict(LAUNCHES)
    out = cost_volume_kernel(f1, f2, 2)
    assert LAUNCHES == before and out.shape == (2, 25, 7, 9)
    assert torch.equal(out, cost_volume_plain(f1, f2, 2))
    for bad in ((f1, f2[:, :4], 2), (f1, f2, -1), (f1[0], f2[0], 2)):
        with pytest.raises(ValueError):
            cost_volume_kernel(*bad)


def _corr_inputs(seed, shape, dt, layout):
    rng = np.random.default_rng(seed)
    fmt = torch.channels_last if layout == "nhwc" else torch.contiguous_format
    f1 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().to(dt)
    f2 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().to(dt)
    return f1.contiguous(memory_format=fmt), f2.contiguous(memory_format=fmt)


def _assert_corr_close(out, ref, dt):
    """f32 within VAL_TOL; bf16 within one ulp at the larger of the two
    magnitudes (frexp and ldexp are exact) on top of VAL_TOL: the sums
    cancel, so their float32 error is absolute and near zero exceeds any ulp."""
    assert out.dtype == dt and out.is_contiguous() and out.shape == ref.shape
    diff = (out.float() - ref.float()).abs()
    if dt == torch.float32:
        assert float(diff.max()) <= VAL_TOL
    else:
        mag = torch.maximum(out.float().abs(), ref.float().abs()).clamp_min(2.0**-126)
        ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
        assert bool((diff <= ulp + VAL_TOL).all())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("md", [1, 2, 3, 4])
def test_corr_kernel_matches_plain_on_card(md, dtype, layout):
    """Ragged shapes (tiles cut on both axes, channels not a multiple of the
    staging step), every max_disp the kernels are built for."""
    _cuda_or_skip()
    from opticalflowscivis_tpu_torch.ops.correlation import cost_volume_plain
    from opticalflowscivis_tpu_torch.ops.kernels.correlation import cost_volume_kernel

    dt = getattr(torch, dtype)
    for shape in ((2, 13, 7, 11), (3, 20, 19, 45)):
        f1, f2 = _corr_inputs(md, shape, dt, layout)
        before = dict(LAUNCHES)
        out = cost_volume_kernel(f1, f2, md)
        torch.cuda.synchronize()
        assert LAUNCHES["corr"] == before["corr"] + 1
        ref = cost_volume_plain(f1, f2, md)
        assert LAUNCHES["corr"] == before["corr"] + 1  # the plain version launches nothing
        _assert_corr_close(out, ref, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape", [(16, 196, 4, 13), (16, 128, 8, 26), (16, 96, 16, 52), (16, 64, 32, 104),
              (16, 32, 64, 208)],
)
def test_corr_kernel_at_upflows_five_levels_on_card(shape, dtype, layout):
    """``corr`` at the shapes UPFlow's cost volumes take at 256 x 832, batch 8
    (md 4; 1-row tiles at the two coarsest, 16-row tiles and the vector copies
    of NCHW rows at the others), against the plain version; one launch, and
    the launch the kernel reports is ``forward_launch``'s."""
    _cuda_or_skip()
    from opticalflowscivis_tpu_torch.ops.correlation import cost_volume_plain
    from opticalflowscivis_tpu_torch.ops.kernels.correlation import (
        cost_volume_kernel,
        forward_launch,
        kernel_forward_launch,
    )

    dt = getattr(torch, dtype)
    f1, f2 = _corr_inputs(shape[3], shape, dt, layout)
    before = dict(LAUNCHES)
    out = cost_volume_kernel(f1, f2, 4)
    torch.cuda.synchronize()
    assert LAUNCHES["corr"] == before["corr"] + 1
    _assert_corr_close(out, cost_volume_plain(f1, f2, 4), dt)
    bf16 = dt == torch.bfloat16
    assert kernel_forward_launch(shape, 4, bf16) == forward_launch(shape, 4, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 45, 11, 44), (30, 45, 19, 44)], ids=["rows1", "rows16"])
def test_corr_kernel_on_rows_of_four_on_card(shape, dtype):
    """md 4 on contiguous rows of a multiple of 4 (44 = 32 + 12 columns),
    which ``corr`` copies 4 elements at a time, on the tile's edges (11 or 19
    rows, 45 channels: not a whole stage), with 1-row and 16-row tiles."""
    _cuda_or_skip()
    from opticalflowscivis_tpu_torch.ops.correlation import cost_volume_plain
    from opticalflowscivis_tpu_torch.ops.kernels.correlation import (
        cost_volume_kernel,
        forward_launch,
    )

    dt = getattr(torch, dtype)
    assert forward_launch(shape, 4).tile_rows == (1 if shape[0] == 3 else 16)
    f1, f2 = _corr_inputs(7, shape, dt, "nchw")
    out = cost_volume_kernel(f1, f2, 4)
    torch.cuda.synchronize()
    _assert_corr_close(out, cost_volume_plain(f1, f2, 4), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corr_kernel_repeats_bit_for_bit_on_card(dtype, layout):
    """Two forward runs on the same inputs agree bit for bit (no atomics;
    the channel groups of 1-row tiles are added in a fixed order)."""
    _cuda_or_skip()
    from opticalflowscivis_tpu_torch.ops.kernels.correlation import cost_volume_kernel

    dt = getattr(torch, dtype)
    for shape in ((16, 196, 4, 13), (16, 32, 64, 208)):
        f1, f2 = _corr_inputs(5, shape, dt, layout)
        first, second = cost_volume_kernel(f1, f2, 4), cost_volume_kernel(f1, f2, 4)
        torch.cuda.synchronize()
        assert torch.equal(first, second), shape


@pytest.mark.cuda
@pytest.mark.parametrize("needs", ["both", "f1", "f2"])
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("md", [1, 2, 3, 4])
def test_corr_kernel_backward_matches_plain_on_card(md, dtype, layout, needs):
    """``df1`` / ``df2`` against autograd through the plain version, each alone
    and both (one launch each time); float32 within 1e-4 and bfloat16 within
    2e-2 of the largest gradient (sums of up to 121 terms, rounded once)."""
    _cuda_or_skip()
    from opticalflowscivis_tpu_torch.ops.correlation import cost_volume_plain
    from opticalflowscivis_tpu_torch.ops.kernels.correlation import cost_volume_kernel

    dt = getattr(torch, dtype)
    shape = (2, 20, 11, 37)
    f1, f2 = _corr_inputs(20 + md, shape, dt, layout)
    fmt = torch.channels_last if layout == "nhwc" else torch.contiguous_format
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, (2 * md + 1) ** 2, 11, 37)).astype(np.float32)).cuda().to(dt)
    g = g.contiguous(memory_format=fmt)

    def through(fn):
        a = f1.detach().clone(memory_format=torch.preserve_format).requires_grad_(needs != "f2")
        b = f2.detach().clone(memory_format=torch.preserve_format).requires_grad_(needs != "f1")
        fn(a, b, md).backward(g)
        return a.grad, b.grad

    before = dict(LAUNCHES)
    got = through(cost_volume_kernel)
    torch.cuda.synchronize()
    assert LAUNCHES["corr"] == before["corr"] + 1
    assert LAUNCHES["corr_bwd"] == before["corr_bwd"] + 1
    want = through(cost_volume_plain)
    assert LAUNCHES["corr_bwd"] == before["corr_bwd"] + 1
    rel = 1e-4 if dt == torch.float32 else 2e-2
    for name, x, y in zip(("df1", "df2"), got, want):
        if y is None:
            assert x is None, name
            continue
        assert x.dtype == dt and x.shape == shape
        assert float((x.float() - y.float()).abs().max()) <= rel * float(y.float().abs().max()), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape", [(16, 196, 4, 13), (16, 128, 8, 26), (16, 96, 16, 52), (16, 64, 32, 104),
              (16, 32, 64, 208)],
)
def test_corr_kernel_backward_at_upflows_five_levels_on_card(shape, dtype):
    """``corr_bwd`` at the shapes UPFlow's cost volumes take at 256 x 832,
    batch 8 (md 4, both gradients, one launch) against autograd through the
    plain version: float32 within 1e-4 and bfloat16 within 1e-2 of the
    largest gradient; the launch the kernel reports is ``backward_launch``'s."""
    _cuda_or_skip()
    from opticalflowscivis_tpu_torch.ops.correlation import cost_volume_plain
    from opticalflowscivis_tpu_torch.ops.kernels.correlation import (
        backward_launch,
        cost_volume_kernel,
        kernel_backward_launch,
    )

    dt, md = getattr(torch, dtype), 4
    f1, f2 = _corr_inputs(shape[1], shape, dt, "nchw")
    g = torch.from_numpy(np.random.default_rng(shape[2]).standard_normal(
        (shape[0], 81) + shape[2:]).astype(np.float32)).cuda().to(dt)

    def through(fn):
        a, b = f1.clone().requires_grad_(True), f2.clone().requires_grad_(True)
        fn(a, b, md).backward(g)
        return a.grad, b.grad

    before = dict(LAUNCHES)
    got = through(cost_volume_kernel)
    torch.cuda.synchronize()
    assert LAUNCHES["corr_bwd"] == before["corr_bwd"] + 1
    want = through(cost_volume_plain)
    rel = 1e-4 if dt == torch.float32 else 1e-2
    for name, x, y in zip(("df1", "df2"), got, want):
        assert x.dtype == dt and x.shape == shape and x.is_contiguous()
        assert float((x.float() - y.float()).abs().max()) <= rel * float(y.float().abs().max()), name
    assert kernel_backward_launch(shape, md) == backward_launch(shape, md)


@pytest.mark.cuda
@pytest.mark.parametrize("needs", ["both", "f1", "f2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corr_kernel_backward_on_rows_of_four_on_card(dtype, needs):
    """md 4 on contiguous rows of a multiple of 4 (44 = 2 x 16 + 12 columns),
    which ``corr_bwd`` reads 4 elements a load, on the tile's edges (11 rows,
    45 channels): each gradient alone and both against autograd through the
    plain version, float32 within 1e-4 and bfloat16 within 1e-2 of the
    largest gradient."""
    _cuda_or_skip()
    from opticalflowscivis_tpu_torch.ops.correlation import cost_volume_plain
    from opticalflowscivis_tpu_torch.ops.kernels.correlation import cost_volume_kernel

    dt, md, shape = getattr(torch, dtype), 4, (3, 45, 11, 44)
    f1, f2 = _corr_inputs(44, shape, dt, "nchw")
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 81, 11, 44)).astype(np.float32)).cuda().to(dt)

    def through(fn):
        a = f1.clone().requires_grad_(needs != "f2")
        b = f2.clone().requires_grad_(needs != "f1")
        fn(a, b, md).backward(g)
        return a.grad, b.grad

    before = dict(LAUNCHES)
    got = through(cost_volume_kernel)
    torch.cuda.synchronize()
    assert LAUNCHES["corr_bwd"] == before["corr_bwd"] + 1
    want = through(cost_volume_plain)
    rel = 1e-4 if dt == torch.float32 else 1e-2
    for name, x, y in zip(("df1", "df2"), got, want):
        if y is None:
            assert x is None, name
            continue
        assert x.dtype == dt and x.shape == shape and x.is_contiguous()
        assert float((x.float() - y.float()).abs().max()) <= rel * float(y.float().abs().max()), name


@pytest.mark.cuda
def test_corr_on_card_raises_on_what_the_kernel_does_not_take():
    _cuda_or_skip()
    from opticalflowscivis_tpu_torch.ops.kernels.correlation import cost_volume_kernel

    f = torch.zeros(1, 4, 8, 8, device="cuda")
    with pytest.raises(TypeError):
        cost_volume_kernel(f, f.bfloat16(), 2)
    with pytest.raises(TypeError):
        cost_volume_kernel(f.half(), f.half(), 2)
    with pytest.raises(ValueError):
        cost_volume_kernel(f, f.cpu(), 2)
    with pytest.raises(ValueError, match="empty"):
        cost_volume_kernel(f[:0], f[:0], 2)
    for md in (0, 5):  # the kernels are built for max_disp 1 to 4
        with pytest.raises(ValueError, match="max_disp"):
            cost_volume_kernel(f, f, md)


@pytest.mark.cuda
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_warp2d_bf16_image_with_float32_flow_on_card(padding):
    """UPFlow's feature warps: a bf16 image under a float32 flow of up to 40 px,
    forward within one bf16 ulp, ``dimg`` bf16 and ``dflow`` float32 within
    2e-2 of the largest gradient."""
    _cuda_or_skip()
    img, flow = _inputs(11, (2, 24, 72, 5), 20.0)
    g = np.random.default_rng(12).standard_normal(img.shape).astype(np.float32)
    img_t = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous().cuda().bfloat16()
    flow_t = torch.from_numpy(np.round(flow * 4) / 4 + 0.11).permute(0, 3, 1, 2).cuda()
    g_t = torch.from_numpy(g).permute(0, 3, 1, 2).cuda().bfloat16()

    def through(fn):
        im = img_t.detach().clone().requires_grad_(True)
        fl = flow_t.detach().clone().requires_grad_(True)
        out = fn(im, fl, 0, padding)
        out.backward(g_t)
        return out.detach(), im.grad, fl.grad

    before = dict(LAUNCHES)
    out, dimg, dflow = through(warp2d)
    torch.cuda.synchronize()
    assert LAUNCHES["warp2d"] == before["warp2d"] + 1
    assert LAUNCHES["warp2d_bwd"] == before["warp2d_bwd"] + 1
    ref, dimg_ref, dflow_ref = through(tw.warp2d_plain)
    assert out.dtype == torch.bfloat16 and dimg.dtype == torch.bfloat16
    assert dflow.dtype == torch.float32
    assert bool(((out.float() - ref.float()).abs() <= _ulp_bf16(ref)).all())
    for x, y in ((dimg, dimg_ref), (dflow, dflow_ref)):
        assert float((x.float() - y.float()).abs().max()) <= 2e-2 * float(y.float().abs().max())


TYPE_MODES = {"f32": ("float32", "float32"), "bf16": ("bfloat16", "bfloat16"),
              "bf16_img_f32_flow": ("bfloat16", "float32")}


def _flow_views(flow, layout):
    """``flow [B, 2, H, W]`` as the kernel may be handed it: a slice of a
    4-channel flow in NCHW (aligned when H * W is a multiple of 4), the slice
    ``[:, 1:3]`` (misaligned), or channels-last."""
    b, _, h, w = flow.shape
    if layout == "nhwc":
        flow4 = torch.cat([flow * 0.5, flow], 1).contiguous(memory_format=torch.channels_last)
        return flow4[:, 2:4]
    if layout == "misaligned":
        return torch.cat([flow[:, :1] * 0.5, flow, flow[:, :1]], 1)[:, 1:3]
    return torch.cat([flow * 0.5, flow], 1)[:, 2:4]


def _check_forward(out, ref, dt):
    assert out.dtype == dt and out.shape == ref.shape and out.is_contiguous()
    diff = (out.float() - ref.float()).abs()
    if dt == torch.float32:
        return float(diff.max()) <= VAL_TOL
    return bool((diff <= _ulp_bf16(ref)).all())


# ragged widths, single rows and single pixels; H * W odd in most, so that the
# [:, 1:3] slice of a 4-channel flow starts on an odd element
LAYOUT_SHAPES = [(2, 3, 5, 1), (2, 2, 7, 13), (1, 3, 1, 37), (3, 1, 9, 53), (2, 1, 1, 1),
                 (2, 2, 8, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(TYPE_MODES))
@pytest.mark.parametrize("r", [16, 0])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_warp2d_kernel_ragged_misaligned_and_channels_last_on_card(padding, r, mode):
    """The forward's vector and element paths: ragged row ends (W = 1, 13, 37,
    53), H = 1, flows as aligned and misaligned NCHW slices and channels-last,
    in all three type modes; f32 within 1e-5, bf16 within one ulp."""
    _cuda_or_skip()
    dt, ft = (getattr(torch, t) for t in TYPE_MODES[mode])
    for i, (b, c, h, w) in enumerate(LAYOUT_SHAPES):
        img, flow = _inputs(30 + i, (b, h, w, c), 10.0)
        img_t = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous().cuda().to(dt)
        flow_t = torch.from_numpy(flow).permute(0, 3, 1, 2).cuda().to(ft)
        for layout in ("nchw", "misaligned", "nhwc"):
            view = _flow_views(flow_t, layout)
            assert torch.equal(view, flow_t)
            before = LAUNCHES["warp2d"]
            out = warp2d(img_t, view, r, padding)
            torch.cuda.synchronize()
            assert LAUNCHES["warp2d"] == before + 1
            ref = tw.warp2d_plain(img_t, view, r, padding)
            assert _check_forward(out, ref, dt), ((b, c, h, w), layout)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(TYPE_MODES))
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_warp2d_fused_mask_is_the_launch_it_replaces_on_card(padding, mode):
    """``warp2d_with_mask`` makes one launch, and its mask is bit for bit the
    warp of an image of ones under zeros padding (the second launch it
    replaces), its warp bit for bit ``warp2d``; flows leave the image on every
    side, some by less than a pixel, in every layout."""
    _cuda_or_skip()
    from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d_with_mask

    dt, ft = (getattr(torch, t) for t in TYPE_MODES[mode])
    for i, (b, c, h, w) in enumerate(LAYOUT_SHAPES + [(4, 32, 16, 52)]):
        img, flow = _inputs(50 + i, (b, h, w, c), max(h, w) / 3)
        flow[:, ::3] = np.round(flow[:, ::3]) + 1e-3
        img_t = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous().cuda().to(dt)
        flow_t = torch.from_numpy(flow).permute(0, 3, 1, 2).cuda().to(ft)
        ones = torch.ones((b, 1, h, w), dtype=dt, device="cuda")
        for layout in ("nchw", "misaligned", "nhwc"):
            view = _flow_views(flow_t, layout)
            before = LAUNCHES["warp2d"]
            warped, mask = warp2d_with_mask(img_t, view, padding)
            torch.cuda.synchronize()
            assert LAUNCHES["warp2d"] == before + 1
            assert mask.dtype == dt and mask.shape == (b, 1, h, w) and not mask.requires_grad
            assert torch.equal(mask, warp2d(ones, view, 0, "zeros")), ((b, c, h, w), layout)
            assert torch.equal(warped, warp2d(img_t, view, 0, padding))
            assert _check_forward(mask, tw.warp2d_plain(ones, view, 0, "zeros"), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "channels_last_3d"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_warp3d_kernel_ragged_x_on_card(padding, dtype, layout):
    """Ragged rows (X = 1, 5, 13, 62) and a single row, radii (8, 8), (4, 0)
    and (0, 0); f32 within 1e-5, bf16 within one ulp."""
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    for i, shape in enumerate([(2, 1, 6, 7, 1), (1, 2, 5, 3, 5), (2, 3, 4, 1, 13),
                               (1, 1, 9, 10, 62)]):
        img, flow6 = _inputs3d(60 + i, shape, 6.0)
        img_t, flow6 = img.cuda().to(dt), flow6.cuda().to(dt)
        if layout == "channels_last_3d":
            flow6 = flow6.contiguous(memory_format=torch.channels_last_3d)
        for radii in RADII:
            before = LAUNCHES["warp3d"]
            out = warp3d(img_t, flow6[:, 3:], *radii, padding)
            torch.cuda.synchronize()
            assert LAUNCHES["warp3d"] == before + 1
            ref = tw.warp3d_plain(img_t, flow6[:, 3:], *radii, padding)
            assert _check_forward(out, ref, dt), (shape, radii)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_kernels_grid_stride_loops_on_card(dtype):
    """Thin shapes whose planes (B, or B * Z) or rows exceed the grid's 65535
    limit, so that the forward kernels' grid-stride loops carry the rest."""
    _cuda_or_skip()
    from opticalflowscivis_tpu_torch.ops.kernels.warp import launch_geometry

    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for shape in ((70000, 1, 1, 5), (1, 2, 65535 * 256 + 3, 1)):
        assert launch_geometry(shape).strided
        b, c, h, w = shape
        img = torch.rand(shape, generator=gen, device="cuda").to(dt)
        flow = (torch.randn((b, 2, h, w), generator=gen, device="cuda") * 3).to(dt)
        for padding in ("border", "zeros"):
            out = warp2d(img, flow, 16, padding)
            assert _check_forward(out, tw.warp2d_plain(img, flow, 16, padding), dt), shape
    for shape in ((2, 1, 40000, 2, 3), (1, 1, 1, 65535 * 256 + 1, 1)):
        assert launch_geometry(shape).strided
        img = torch.rand(shape, generator=gen, device="cuda").to(dt)
        flow = (torch.randn((shape[0], 3) + shape[2:], generator=gen, device="cuda") * 3).to(dt)
        for padding in ("border", "zeros"):
            out = warp3d(img, flow, 8, 8, padding)
            assert _check_forward(out, tw.warp3d_plain(img, flow, 8, 8, padding), dt), shape


def _warp3d_grads(fn, img, flow6, g, radii, padding, img_grad):
    """``(dimg or None, dflow)`` of ``fn`` on the last three channels of
    ``flow6``, kept in its layout."""
    leaf = flow6.detach().clone(memory_format=torch.preserve_format).requires_grad_(True)
    im = img.detach().clone().requires_grad_(img_grad)
    fn(im, leaf[:, 3:], *radii, padding).backward(g)
    return im.grad, leaf.grad[:, 3:]


def _check_warp3d_backward(img, flow6, g, radii, padding, img_grad):
    """One launch of the backward kernel against autograd through the plain
    version, at the tolerances above; ``dflow`` exactly 0 at and beyond each
    radius."""
    dt = img.dtype
    before = dict(LAUNCHES)
    dimg, dflow = _warp3d_grads(warp3d, img, flow6, g, radii, padding, img_grad)
    torch.cuda.synchronize()
    assert LAUNCHES["warp3d_bwd"] == before["warp3d_bwd"] + 1
    dimg_ref, dflow_ref = _warp3d_grads(tw.warp3d_plain, img, flow6, g, radii, padding, img_grad)
    rel = 1e-4 if dt == torch.float32 else 2e-2
    pairs = [(dflow, dflow_ref)] + ([(dimg, dimg_ref)] if img_grad else [])
    assert img_grad or dimg is None
    for got, want in pairs:
        assert got.dtype == dt and got.shape == want.shape
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= rel * scale
    flow = flow6[:, 3:].float()
    for component, r in ((slice(0, 1), radii[0]), (slice(1, 3), radii[1])):
        if r:
            clamped = flow[:, component].abs() >= r
            assert bool((dflow[:, component][clamped] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("img_grad", [False, True], ids=["no_dimg", "dimg"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp3d_backward_at_the_models_shape_on_card(dtype, img_grad):
    """[4, 1, 64, 64, 64] with radii (8, 8), border padding, the flow the
    last three channels of a 6-channel flow, as the model passes it."""
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    img, flow6 = _inputs3d(70, (4, 1, 64, 64, 64), 6.0, off_integer=True)
    g = torch.from_numpy(np.random.default_rng(71).standard_normal(img.shape).astype(np.float32))
    img, flow6, g = (t.cuda().to(dt) for t in (img, flow6, g))
    assert bool((flow6[:, 3:].float().abs() >= 8).any())
    _check_warp3d_backward(img, flow6, g, (8, 8), "border", img_grad)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "channels_last_3d"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_warp3d_backward_ragged_x_on_card(padding, dtype, layout):
    """The backward's element paths: ragged rows (X = 1, 5, 13, 62) and a
    single row, flow and incoming gradient contiguous or channels-last-3d,
    radii (8, 8), (4, 0) and (0, 0), with and without ``dimg``."""
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    fmt = torch.channels_last_3d if layout == "channels_last_3d" else torch.contiguous_format
    for i, shape in enumerate([(2, 1, 6, 7, 1), (1, 2, 5, 3, 5), (2, 3, 4, 1, 13),
                               (1, 1, 9, 10, 62)]):
        img, flow6 = _inputs3d(80 + i, shape, 6.0, off_integer=True)
        g = np.random.default_rng(90 + i).standard_normal(shape).astype(np.float32)
        img = img.cuda().to(dt)
        flow6 = flow6.cuda().to(dt).contiguous(memory_format=fmt)
        g = torch.from_numpy(g).cuda().to(dt).contiguous(memory_format=fmt)
        for radii in RADII:
            for img_grad in (False, True):
                _check_warp3d_backward(img, flow6, g, radii, padding, img_grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp3d_backward_grid_stride_loops_on_card(dtype):
    """Planes (B * Z) and rows beyond the grid's 65535 limit, so that the
    backward's grid-stride loops carry the rest."""
    _cuda_or_skip()
    from opticalflowscivis_tpu_torch.ops.kernels.warp import launch_geometry

    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(17)
    for shape in ((2, 1, 40000, 2, 3), (1, 1, 1, 65535 * 256 + 1, 1)):
        assert launch_geometry(shape).strided
        b, _, z, y, x = shape
        img = torch.rand(shape, generator=gen, device="cuda").to(dt)
        flow6 = (torch.randn((b, 6, z, y, x), generator=gen, device="cuda") * 3).to(dt)
        g = torch.randn(shape, generator=gen, device="cuda").to(dt)
        for padding in ("border", "zeros"):
            for img_grad in (False, True):
                _check_warp3d_backward(img, flow6, g, (8, 8), padding, img_grad)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "channels_last_3d"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp3d_backward_repeats_bit_for_bit_on_card(dtype, layout):
    """``dflow`` is written once per voxel with no atomics: two runs of the
    model's shape agree bit for bit."""
    _cuda_or_skip()
    from opticalflowscivis_tpu_torch.ops.kernels.warp import _launch3d_backward

    dt = getattr(torch, dtype)
    fmt = torch.channels_last_3d if layout == "channels_last_3d" else torch.contiguous_format
    img, flow6 = _inputs3d(72, (4, 1, 64, 64, 64), 6.0)
    g = torch.from_numpy(np.random.default_rng(73).standard_normal(img.shape).astype(np.float32))
    img = img.cuda().to(dt)
    flow = flow6.cuda().to(dt).contiguous(memory_format=fmt)[:, 3:]
    g = g.cuda().to(dt).contiguous(memory_format=fmt)
    first = _launch3d_backward(img, flow, g, 8, 8, "border", False)[1]
    second = _launch3d_backward(img, flow, g, 8, 8, "border", False)[1]
    assert torch.equal(first, second) and bool(first.abs().sum() > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("bfloat16", [False, True], ids=["f32", "bf16"])
def test_upflow_train_step_on_card_goes_through_the_kernels(bfloat16, tmp_path):
    """One narrow UPFlow train step on the card: 5 + 5 cost-volume launches,
    8 warps (4 feature warps, each writing its validity mask in the same
    launch, 2 occlusion, 2 photometric) and 6 warp backwards; in float32 its
    parts agree with the CPU (1e-3)."""
    _cuda_or_skip()
    from opticalflowscivis_tpu_torch.models import UPFlowConfig
    from opticalflowscivis_tpu_torch.training import UPFlowTrainConfig, UPFlowTrainer

    torch.backends.cudnn.allow_tf32 = False
    model = UPFlowConfig(num_chs=(3, 4, 8, 8, 12, 16, 16), estimator_f_channels=(16, 16, 12, 8, 8),
                         context_f_channels=(16, 16, 16, 12, 8, 8, 2), search_range=2,
                         if_norm_before_cost_volume=True, norm_moments_across_channels=False,
                         norm_moments_across_images=False)
    cfg = UPFlowTrainConfig(batch_size=2, bfloat16=bfloat16, exp_dir=str(tmp_path), model=model)
    rng = np.random.default_rng(0)
    im = rng.uniform(0.05, 1, (2, 64, 128, 3)).astype(np.float32)
    pairs = np.stack([im, np.roll(im, 2, axis=2)], axis=1)
    parts = {}
    for device in ("cuda", "cpu"):
        tr = UPFlowTrainer(cfg, device=device)
        tr.init_state()
        before = dict(LAUNCHES)
        parts[device] = tr.train_step(tr._batch(tr.upload(pairs)))
        if device == "cuda":
            torch.cuda.synchronize()
            delta = {k: LAUNCHES[k] - before[k] for k in before if LAUNCHES[k] != before[k]}
            assert delta == {"corr": 5, "corr_bwd": 5, "warp2d": 8, "warp2d_bwd": 6}
        else:
            assert LAUNCHES == before
    if not bfloat16:
        for key, ref in parts["cpu"].items():
            assert float(parts["cuda"][key]) == pytest.approx(float(ref), rel=1e-3, abs=1e-6), key
