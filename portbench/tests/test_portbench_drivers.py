"""Each traffic driver at a tiny size on the plain CPU path, and the
comparison that decides ``correct`` against faults planted under the timed
path: a step that leaves the state unchanged, half of the batch left out
(the mean over the rest), an answer altered where it is produced.  The
cells run on one card, so no exchange between cards can be left out."""

import pytest
import torch

from portbench import control, harness
from portbench.tests.conftest import run_tiny, tiny_context

CELLS = ["rife3d_train_256", "rife2d_train_droplet", "rife2d_interp_droplet", "rife3d_interp_256"]


@pytest.mark.parametrize("workload", CELLS)
def test_driver_runs_and_is_correct(workload):
    line = run_tiny(tiny_context(workload, trace=True))
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["device"]["window_s"] > 0


def _unchanged_state(monkeypatch):
    from opticalflowscivis_tpu_torch.training.trainer import Trainer

    step = Trainer.train_step

    def same_state(self, batch):
        before = [p.detach().clone() for p in self.model.parameters()]
        parts = step(self, batch)
        with torch.no_grad():
            for p, b in zip(self.model.parameters(), before):
                p.copy_(b)
        return parts

    monkeypatch.setattr(Trainer, "train_step", same_state)


def _half_batch(monkeypatch):
    from opticalflowscivis_tpu_torch.training.trainer import Trainer

    step = Trainer.train_step
    monkeypatch.setattr(Trainer, "train_step",
                        lambda self, batch: step(self, batch[: batch.shape[0] // 2]))


def _altered_answer(monkeypatch):
    from opticalflowscivis_tpu_torch.inference import Interpolator

    forward = Interpolator.forward

    def altered(self, img0, img1, timestep=0.5):
        merged, flow, mask = forward(self, img0, img1, timestep)
        return merged.flip(-1), flow, mask

    monkeypatch.setattr(Interpolator, "forward", altered)


FAULTS = [("rife3d_train_256", _unchanged_state), ("rife2d_train_droplet", _unchanged_state),
          ("rife2d_train_droplet", _half_batch), ("rife2d_interp_droplet", _altered_answer),
          ("rife3d_interp_256", _altered_answer)]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_a_planted_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    line = run_tiny(tiny_context(workload))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_reads_far_above_the_program(workload):
    ctx = tiny_context(workload)
    row = control.READINGS[ctx.traffic["driver"]](ctx, True)
    limits = harness.read_json("limits", workload)
    for name in limits:
        value = row["program"][name]
        if name == "kept_max_abs":
            assert value == 0.0 and row["control"][name] == 0.0
        elif name != "change_gap":  # the change of three warm-up steps barely sees precision
            assert row["control"][name] > 30 * value, (name, row)
    if "half_batch" in row:
        assert not harness.judge(row["half_batch"], limits)[0], row


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct_at_the_cell_size(workload, cuda):
    """On a card, at the cell's own size: the program within its limits, the
    control outside them, and its convolutions alone too except in 3-D
    training, whose gaps of norms read the program's bf16 and e4m3
    convolutions alike."""
    cell = harness.find_cell(harness.load_benchmark(), workload)
    ctx = harness.context(cell, 2**31 + 123, 0.0, False, "cuda", 0.0)
    row = control.READINGS[ctx.traffic["driver"]](ctx, True)
    limits = harness.read_json("limits", workload)
    assert harness.judge(row["program"], limits)[0], row
    assert not harness.judge(row["control"], limits)[0], row
    if workload != "rife3d_train_256":
        assert not harness.judge(row["fp8_conv"], limits)[0], row
