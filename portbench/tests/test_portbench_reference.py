"""The plain reference against the port's plain CPU path at a tiny size:
the same weights and inputs give the same forward and the same three
training steps."""


import pytest
import torch

from portbench.drivers import common, train
from portbench.reference.ifnet import RefIFNet, losses
from portbench.tests.conftest import tiny_context
from portbench.weights import seeded_state


@pytest.mark.parametrize("workload", ["rife2d_train_droplet", "rife3d_train_256"])
def test_forward_matches_the_port(workload):
    from portbench.drivers.common import port_model

    ctx = tiny_context(workload)
    cfg = ctx.config
    port = port_model(cfg, 11, torch.device("cpu"))
    ref = RefIFNet(cfg["model"])
    ref.load_state_dict(seeded_state(RefIFNet(cfg["model"], device="meta"), 11, "cpu"))
    gen = torch.Generator().manual_seed(5)
    x = [torch.rand((2, 1) + tuple(cfg["size"]), generator=gen) for _ in range(3)]
    with torch.no_grad():
        a, b = port(*x), ref(*x)
        for key in ("merged", "flow_list", "mask_list"):
            for p, q in zip(a[key], b[key]):
                torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(a["merged_teacher"], b["merged_teacher"], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(a["loss_distill"], b["loss_distill"], rtol=1e-5, atol=1e-7)
        total, _ = losses(ref, b, *x, cfg["loss"])
        assert torch.isfinite(total)


@pytest.mark.parametrize("workload", ["rife2d_train_droplet", "rife3d_train_256"])
def test_train_steps_match_the_port(workload):
    ctx = tiny_context(workload)
    cell = train.TrainCell(ctx, common.Phases(0.0))
    prog, batches = cell.check_steps()
    ref = train.reference_readings(ctx.config, ctx.seed, batches, torch.device("cpu"))
    checks, _ = train.compare(prog, ref)
    # float32 on both sides: the gaps are rounding
    assert checks["loss_gap"] < 1e-5
    assert checks["grad_median_gap"] < 1e-4
    assert checks["change_gap"] < 1e-3


def test_fp8_control_rounds_to_e4m3():
    from portbench.reference.ifnet import fp8_round

    x = torch.tensor([448.0, 1.0, 0.3, -0.0625], requires_grad=True)
    y = fp8_round(x)
    assert y.tolist() == [448.0, 1.0, 0.3125, -0.0625]
    y.sum().backward()
    assert x.grad.tolist() == [1.0] * 4


def test_fp8_control_convolves_e4m3_operands_both_ways():
    """The control's convolution sees e4m3 operands forward, and its input
    and weight gradients are products of an e4m3 output gradient."""
    from portbench.reference.ifnet import fp8_round

    cfg = tiny_context("rife2d_train_droplet").config
    ref = RefIFNet(cfg["model"], precision="fp8")
    layer = ref.block0.conv0[0].conv
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((1, 2, 8, 8), generator=gen, requires_grad=True)
    g = torch.randn((1, layer.out_channels, 4, 4), generator=gen)
    y = ref._op(torch.nn.functional.conv2d, x, layer)
    y.backward(g)
    xq, wq, gq = fp8_round(x.detach()), fp8_round(layer.weight.detach()), fp8_round(g)
    want = torch.nn.functional.conv2d(xq, wq, layer.bias.detach(), 2, 1)
    torch.testing.assert_close(y.detach(), want)
    want_dx = torch.nn.grad.conv2d_input(x.shape, wq, gq, 2, 1)
    want_dw = torch.nn.grad.conv2d_weight(xq, layer.weight.shape, gq, 2, 1)
    torch.testing.assert_close(x.grad, want_dx)
    torch.testing.assert_close(layer.weight.grad, want_dw)


def test_frames_enter_the_network_at_the_compute_type():
    cfg = tiny_context("rife2d_train_droplet").config
    x = torch.tensor([1.0 + 2.0 ** -12, 0.3])
    assert RefIFNet(dict(cfg["model"], bfloat16=False))._entry(x).tolist() == x.tolist()
    assert RefIFNet(dict(cfg["model"], bfloat16=True))._entry(x).tolist() == [1.0, 0.30078125]
