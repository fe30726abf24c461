"""Closed-loop UPFlow training on KITTI-like crops: ``UPFlowTrainer.kitti_batch``
then ``UPFlowTrainer.train_step``, back to back, the path of
``fit_kitti_hbm``.

Traffic parameters: ``batch`` (pairs a step), ``crop``, ``rho`` (the
boundary-dilated windows' margin), ``sequences`` of ``sequence_frames``
frames of ``frame_size`` (made on the device from the seed by
``portbench.kitti_scenes``, the camera and the patches moving at most
``max_shift`` pixels a frame), whose consecutive frames are the pairs, and
``profile_steps`` (the traced sub-window).

Set-up builds one trainer at the configuration, loads the seeded weights,
makes the frame store on the device and drives three steps on batches drawn
from ``np.random.default_rng(seed + 2)``: the warm-up and the steps the
reference follows.  Their losses, the first step's loss parts, the first
gradient (from AdamW's first moment after one step), each leaf's change after
the three, and on the first batch before the first update the flows of a
forward without gradients and the gradient of the terms through no hard mask
(``unmasked``) are kept, with the batches as ``device_batch`` cut them.  The window runs whole steps, the
draws going on from the same generator, and ends in a synchronisation; a
traced run then profiles ``profile_steps`` more steps with ``trace.profile``
and as many with the port's spans on (``spans.profile``), whose attribution
is kept under the profile's ``spans``.  After it, the program is freed and
the plain reference (``reference/upflow.py``) takes the same three steps
from the same weights on the same batches, in float32.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from portbench import kitti_scenes, spans, trace
from portbench.drivers import common
from portbench.drivers.train import compare as train_compare
from portbench.reference import upflow_count
from portbench.reference.upflow import RefUPFlow, channels_first, host_flows, train_steps
from portbench.weights import seeded_state

CHECK_STEPS = 3


def seeded(cfg: dict, seed: int, device) -> dict:
    """The seeded state dict, with the program's parameter names."""
    return seeded_state(RefUPFlow(cfg["model"], device="meta"), seed, device)


class UPFlowCell:
    """The trainer at the configuration with its frame store and draws."""

    def __init__(self, ctx, phases: common.Phases):
        from opticalflowscivis_tpu_torch.data.kitti import KittiHBMCache
        from opticalflowscivis_tpu_torch.losses import UPFlowLossConfig
        from opticalflowscivis_tpu_torch.models import UPFlowConfig
        from opticalflowscivis_tpu_torch.training import UPFlowTrainConfig, UPFlowTrainer

        phases.mark("imports")
        cfg, traffic = ctx.config, ctx.traffic
        self.device = torch.device(ctx.device)
        self.batch_size = traffic["batch"]
        model = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["model"].items()}
        tc = UPFlowTrainConfig(batch_size=self.batch_size, bfloat16=cfg["bfloat16"],
                               exp_dir=os.path.join(tempfile.gettempdir(), "portbench", "upflow"),
                               model=UPFlowConfig(**model), loss=UPFlowLossConfig(**cfg["loss"]),
                               **cfg["optim"])
        self.trainer = UPFlowTrainer(tc, device=self.device)
        self.trainer.net.load_state_dict(seeded(cfg, ctx.seed, self.device))
        self.trainer.init_state()
        phases.mark("trainer and weights")
        self.store = kitti_scenes.kitti_scenes(
            ctx.seed + 1, traffic["sequences"], traffic["sequence_frames"],
            tuple(traffic["frame_size"]), traffic["max_shift"], self.device)
        pair_idx = kitti_scenes.pairs(traffic["sequences"], traffic["sequence_frames"])
        self.cache = KittiHBMCache.for_store(self.store.shape, pair_idx, traffic["crop"],
                                             traffic["rho"])
        self.rng = np.random.default_rng(ctx.seed + 2)
        common.sync(self.device)
        phases.mark("frames")

    def batch(self) -> dict:
        return self.trainer.kitti_batch(self.cache, self.store, self.rng)

    def check_steps(self) -> tuple[dict, list[dict]]:
        """The three first steps: the program's readings and the batches
        (on the host, for the reference)."""
        net = self.trainer.net
        names, params = zip(*net.named_parameters())
        start = [p.detach().clone() for p in params]
        out: dict = {"losses": []}
        batches = []
        for k in range(CHECK_STEPS):
            b = self.batch()
            batches.append({n: v.cpu() for n, v in b.items()})
            if k == 0:
                with torch.no_grad():  # the first forward's flows, at the step's weights
                    out["flows"] = host_flows(net(b["im1"].movedim(-1, 1),
                                                  b["im2"].movedim(-1, 1)))
                _, parts = self.trainer.losses(b)
                grads = torch.autograd.grad(unmasked(parts), params)
                out["grad_unmasked"] = {n: g.float().cpu() for n, g in zip(names, grads)}
                del parts, grads
            parts = self.trainer.train_step(b)
            out["losses"].append(float(parts["loss_total"]))
            if k == 0:
                out["parts"] = {n: float(v) for n, v in parts.items()}
                state = self.trainer.state.optimizer.state
                out["grad"] = {n: float(state[p]["exp_avg"].norm()) / 0.1
                               for n, p in zip(names, params)}
        out["change"] = {n: float((p.detach() - s).norm()) for n, p, s in zip(names, params, start)}
        return out, batches

    def step(self, i: int) -> float:
        """One window step; the host's seconds to enqueue ``train_step``."""
        b = self.batch()
        t = time.perf_counter()
        self.trainer.train_step(b)
        return time.perf_counter() - t


def unmasked(parts: dict) -> torch.Tensor:
    """The loss without the occlusion-masked distillation term: the
    photometric, census and smoothness terms, through no hard mask."""
    return parts["photo_loss"] + parts["census_loss"] + parts["smooth_loss"]


def reference_readings(cfg: dict, seed: int, batches, device, precision=None,
                       rows: int | None = None) -> dict:
    """The reference's losses, first-gradient norms and changes after the
    steps on ``batches``; ``rows``: only the first rows of each batch (the
    half-batch fault)."""
    model = RefUPFlow(cfg["model"], device=device, precision=precision,
                      bfloat16=cfg["bfloat16"])
    model.load_state_dict(seeded(cfg, seed, device))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    inputs = [channels_first(b, device, rows) for b in batches]
    with common.float32_exact():
        out = train_steps(model, inputs, cfg)
    return {"losses": out["losses"], "parts": out["parts"], "flows": out["flows"],
            "grad": {n: float(g.norm()) for n, g in out["grads"].items()},
            "grad_unmasked": {n: g.cpu() for n, g in out["grads_unmasked"].items()},
            "change": {n: float((out["params"][n] - start[n]).norm()) for n in start}}


# the parts of the network whose gradients the kernels' backwards reach
# first: the pyramid (the cost volume's and the feature warps' feature
# gradients, and everything SGU's flow warp sends back), and SGU's guidance
# convolution (the masked warp of its features at full resolution)
GRAD_PARTS = {"pyramid": "feature_extractor.", "sgu_guide": "sgu_output_conv."}


def grad_scale_gap(prog: dict, ref: dict, prefix: str) -> float:
    """``|1 - <g, g_ref> / |g_ref|^2|`` over the leaves whose names start
    with ``prefix`` (``{name: tensor}``): how far the program's gradient is
    scaled along the reference's.  A backward of the wrong magnitude moves
    it; the precision's noise, nearly orthogonal to the gradient, hardly."""
    names = [n for n in ref if n.startswith(prefix)]
    dot = sum(float((prog[n].double() * ref[n].double()).sum()) for n in names)
    sq = sum(float(ref[n].double().square().sum()) for n in names)
    return abs(1.0 - dot / sq)


def compare(prog: dict, ref: dict) -> tuple[dict, list[str]]:
    """``(checks, notes)``: ``drivers.train.compare``'s gaps over the three
    steps, and of the first forward

    - ``coarse_flow_rel_rms``: the RMS of the difference of the coarsest
      decoded level's flows (1/64, both directions; the rows both sides
      hold) over the reference's RMS: the features' precision alone, before
      any warp;
    - ``flow_rel_rms``: the same of the final flows, which the four finer
      levels' warps, whose sampling positions move with the coarser flows,
      make read each difference several times over;
    - ``parts_gap``: the largest relative gap of the photometric, census and
      smoothness terms;

    and of the first gradient of those three terms (``unmasked``), the
    backward pass through every kernel but the occlusion check's:

    - ``pyramid_grad_scale_gap``, ``sgu_guide_grad_scale_gap``: the
      ``grad_scale_gap`` of the pyramid's leaves and of SGU's guidance
      convolution's (``GRAD_PARTS``): a cost-volume or warp backward of the
      wrong magnitude shows there.

    The distillation term is left out of these: it is an average over the
    pixels that pass the occlusion check, and at the seeded weights the flows
    of the two directions disagree almost everywhere (none to a few thousand
    of a batch's 1.7 M pixels pass), so a pixel the check flips between
    bfloat16 and float32 moves it by up to tens of per cent; through it the
    whole gradient, the losses of later steps and the changes read the flips
    too."""
    checks, notes = train_compare(prog, ref)
    pf, rf = prog["flows"], ref["flows"]
    rows = min(pf["final"][0].shape[0], rf["final"][0].shape[0])

    def rel(a, b):
        return common.rel_rms(torch.cat([t[:rows] for t in a]), torch.cat([t[:rows] for t in b]))

    levels = [rel(a, b) for a, b in zip(pf["levels"], rf["levels"])]
    parts = {k: abs(prog["parts"][k] - ref["parts"][k]) / abs(ref["parts"][k])
             for k in ("photo_loss", "census_loss", "smooth_loss")}
    checks.update(coarse_flow_rel_rms=common.finite(levels[-1]),
                  flow_rel_rms=common.finite(rel(pf["final"], rf["final"])),
                  parts_gap=common.finite(max(parts.values())))
    for part, prefix in GRAD_PARTS.items():
        checks[f"{part}_grad_scale_gap"] = common.finite(
            grad_scale_gap(prog["grad_unmasked"], ref["grad_unmasked"], prefix))
    notes.append("first forward's flows, relative RMS by level, finest first: "
                 + ", ".join(f"{v:.4g}" for v in levels))
    notes.append("first step's parts: program "
                 + ", ".join(f"{k} {v:.6g}" for k, v in prog["parts"].items())
                 + "; reference " + ", ".join(f"{k} {v:.6g}" for k, v in ref["parts"].items()))
    return checks, notes


def control_readings(ctx, with_control: bool) -> dict:
    """``portbench.control``'s readings of this cell on one seed: the
    program's, and with ``with_control`` the control's (the reference in
    e4m3) and the half-batch fault's, each held against the reference."""
    device = torch.device(ctx.device)
    cell = UPFlowCell(ctx, common.Phases(ctx.t0))
    prog, batches = cell.check_steps()
    del cell
    common.free(device)
    ref = reference_readings(ctx.config, ctx.seed, batches, device)
    checks, notes = compare(prog, ref)
    out = {"program": checks, "notes": notes}
    if with_control:
        ctl = reference_readings(ctx.config, ctx.seed, batches, device, "fp8")
        out["control"] = compare(ctl, ref)[0]
        half = reference_readings(ctx.config, ctx.seed, batches, device,
                                  rows=ctx.traffic["batch"] // 2)
        out["half_batch"] = compare(half, ref)[0]
    return out


def run(ctx) -> dict:
    device = torch.device(ctx.device)
    traffic = ctx.traffic
    phases = common.Phases(ctx.t0)
    cell = UPFlowCell(ctx, phases)
    prog, batches = cell.check_steps()
    common.sync(device)
    phases.mark("three steps")
    setup_peak = common.peak_bytes(device)
    common.reset_peak(device)
    setup_s = time.perf_counter() - ctx.t0

    enqueue, steps = [], 0
    t = time.perf_counter()
    while True:
        enqueue.append(cell.step(steps))
        steps += 1
        if time.perf_counter() - t >= ctx.seconds:
            break
    common.sync(device)
    window_s = time.perf_counter() - t
    peak = common.peak_bytes(device)

    prof = None
    if ctx.trace:
        n = traffic["profile_steps"]
        prof = trace.profile(cell.step, n, lambda: common.sync(device))
        prof["samples"] = n * cell.batch_size
        prof["spans"] = spans.profile(cell.step, n, lambda: common.sync(device))["spans"]
    device_rec = common.device_record(device, max(peak, setup_peak))
    del cell
    common.free(device)
    t = time.perf_counter()
    ref = reference_readings(ctx.config, ctx.seed, batches, device)
    checks, notes = compare(prog, ref)
    notes.append(f"reference: {time.perf_counter() - t:.3f} s")
    work = upflow_count.work(ctx.config, tuple(traffic["crop"]), traffic["rho"])
    return {"kind": "train", "setup_s": setup_s, "window_s": window_s,
            "samples": steps * traffic["batch"], "attempted": steps, "failed": 0,
            "host_enqueue_s": enqueue, "peak_bytes": peak, "device": device_rec,
            "profile": prof, "work": work, "checks": checks,
            "notes": [phases.note(), f"window: {steps} steps of {traffic['batch']} pairs "
                      f"in {window_s:.4f} s"] + notes}
