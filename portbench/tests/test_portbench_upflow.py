"""The UPFlow cell at a tiny size on the plain CPU path, its planted faults,
and its count: the cost volume's bound by hand and against the kernel
table's numbers.

    python -m pytest portbench/tests/test_portbench_upflow.py -q
"""

import copy

import pytest
import torch

from portbench import control, control_upflow, harness, roofline, roofline_corr
from portbench.drivers import upflow_train
from portbench.reference import upflow_count
from portbench.tests.conftest import run_tiny

CELL = "upflow_train_kitti"
# narrow pyramid, estimator and context, float32, small frames: the plain CPU path
TINY_UPFLOW = {"num_chs": [3, 4, 8, 8, 12, 16, 16], "estimator_f_channels": [16, 16, 12, 8, 8],
               "context_f_channels": [16, 16, 16, 12, 8, 8, 2]}
TINY_TRAFFIC = {"batch": 2, "crop": [64, 128], "rho": 4, "sequences": 2, "sequence_frames": 3,
                "frame_size": [80, 144], "max_shift": 4, "profile_steps": 1}


def tiny_context(seed: int = 2**33 + 7, trace: bool = False):
    cell = harness.find_cell(harness.load_benchmark(), CELL)
    ctx = harness.context(cell, seed, 0.5, trace, "cpu", 0.0)
    ctx.config = copy.deepcopy(ctx.config)
    ctx.config["model"].update(TINY_UPFLOW)
    ctx.config["bfloat16"] = False
    ctx.traffic.update(TINY_TRAFFIC)
    return ctx


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


def test_driver_runs_and_is_correct():
    line = run_tiny(tiny_context(trace=True))
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["device"]["window_s"] > 0
    assert "host_enqueue_ms.train" in line["metrics"]


def test_a_half_batch_is_not_correct(monkeypatch):
    from opticalflowscivis_tpu_torch.training import UPFlowTrainer

    step = UPFlowTrainer.train_step
    monkeypatch.setattr(UPFlowTrainer, "train_step", lambda self, b: step(
        self, {k: v[: v.shape[0] // 2] for k, v in b.items()}))
    line = run_tiny(tiny_context())
    assert not line["correct"], line["checks"]


class _GradScale(torch.autograd.Function):
    """The identity, whose backward scales the gradient by 0.8."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return 0.8 * g


def _faulty_warp(warp):
    return lambda feature, flow, padding: warp(_GradScale.apply(feature), flow, padding)


def _faulty_corr(corr):
    return lambda f1, f2, md: corr(_GradScale.apply(f1), _GradScale.apply(f2), md)


@pytest.mark.parametrize("name, fault, check", [
    ("warp2d_with_mask", _faulty_warp, "sgu_guide_grad_scale_gap"),
    ("cost_volume_kernel", _faulty_corr, "pyramid_grad_scale_gap")])
def test_a_backward_of_the_wrong_magnitude_is_not_correct(monkeypatch, name, fault, check):
    """The masked feature warps' image gradient or the cost volume's feature
    gradients 20 % short: the unmasked gradient's scale fails where they
    land first."""
    from opticalflowscivis_tpu_torch.models import upflow

    monkeypatch.setattr(upflow, name, fault(getattr(upflow, name)))
    line = run_tiny(tiny_context())
    assert not line["correct"], line["checks"]
    gap = line["checks"][check]
    assert gap["value"] > gap["limit"], line["checks"]


def test_the_gradient_scale_gap_reads_a_scaled_part_alone():
    ref = {"feature_extractor.w": torch.tensor([3.0, 4.0]), "sgu_output_conv.w": torch.ones(2)}
    prog = {"feature_extractor.w": 0.8 * ref["feature_extractor.w"],
            "sgu_output_conv.w": ref["sgu_output_conv.w"] + torch.tensor([1.0, -1.0])}
    assert upflow_train.grad_scale_gap(prog, ref, "feature_extractor.") == pytest.approx(0.2)
    # a difference orthogonal to the gradient leaves its scale alone
    assert upflow_train.grad_scale_gap(prog, ref, "sgu_output_conv.") == 0.0


def test_the_control_module_reads_this_cell_through_control():
    assert control.READINGS["upflow_train"] is upflow_train.control_readings
    assert control_upflow.control is control


def test_the_control_and_the_fault_read_far_above_the_program():
    row = upflow_train.control_readings(tiny_context(), True)
    limits = harness.read_json("limits", CELL)
    assert harness.judge(row["program"], limits)[0], row
    for kind in ("control", "half_batch"):
        assert not harness.judge(row[kind], limits)[0], (kind, row)
    for name in ("loss_gap", "grad_median_gap"):
        assert row["control"][name] > 30 * row["program"][name], (name, row)


def test_the_corr_bound_equals_the_kernel_table():
    # [16, 32, 64, 208] f32, max_disp 4: 212992 pixels; forward (2 x 32 + 81) x 4 B,
    # backward (4 x 32 + 81) x 4 B a pixel, each over 3.35 TB/s
    shape = (16, 32, 64, 208)
    fwd, bwd = roofline_corr.corr_forward_work(shape, 4), roofline_corr.corr_backward_work(shape, 4)
    assert fwd == (212992 * 145 * 4, 212992 * 81 * 64)
    assert bwd == (212992 * 209 * 4, 212992 * 81 * 128)
    assert round(roofline.bound_s(fwd) * 1e3, 4) == 0.0369
    assert round(roofline.bound_s(bwd) * 1e3, 4) == 0.0532
    calls = [{"shape": list(shape), "bytes": 4, "grads": 2, "backward": True}]
    assert roofline_corr.corr_bound_s(calls) == pytest.approx(
        roofline.bound_s(fwd) + roofline.bound_s(bwd))


def test_the_count_at_the_cell_size():
    """One pair of 256 x 832 crops: the five levels' cost volumes stacked to
    two images (bf16, both gradients), the warps the program sends (the
    feature and SGU warps with their backward, the occlusion check's two
    without), and FLOPs of the order of the dense estimators'."""
    cfg = harness.read_json("configs", "upflow_kitti")
    counted = upflow_count.count(cfg, (256, 832), 8)
    assert [c["shape"] for c in counted["corrs"]] == [
        [2, 196, 4, 13], [2, 128, 8, 26], [2, 96, 16, 52], [2, 64, 32, 104], [2, 32, 64, 208]]
    assert all(c["bytes"] == 2 and c["grads"] == 2 and c["backward"] for c in counted["corrs"])
    sites = [c["site"] for c in counted["warps"]]
    assert sites.count("occ") == 2 and len(sites) == 4 * 3 + 2 + 2
    assert all(c["backward"] for c in counted["warps"] if c["site"] != "occ")
    assert not any(c["backward"] for c in counted["warps"] if c["site"] == "occ")
    assert all(c["image_bytes"] == 2 for c in counted["warps"] if c["mask"])
    assert 4e11 < counted["flops"] < 7e11
    work = upflow_count.work(cfg, (256, 832), 8)
    assert work["corr_bound_s_per_sample"] == pytest.approx(
        roofline_corr.corr_bound_s(counted["corrs"]))
    assert 0 < work["warp_bound_s_per_sample"] < 1e-3


def test_the_corr_share_reads_its_kernels_only():
    record = {"kind": "train", "work": {"corr_bound_s_per_sample": 1e-5},
              "profile": {"samples": 8, "kernels": [
                  ["void (anonymous namespace)::corr_fwd_kernel<float, 16>(float const*)", 4e-5],
                  ["void (anonymous namespace)::corr_bwd_kernel<float>(float const*)", 4e-5],
                  ["void warp2d_kernel<float, float>(float const*)", 1.0]]}}
    assert roofline_corr.corr_roofline_pct(record, "train") == pytest.approx(100.0)
    assert roofline_corr.corr_roofline_pct(dict(record, work={}), "train") is None
    assert roofline_corr.corr_roofline_pct(record, "interp") is None
