"""Closed-loop training: ``Trainer.train_step`` back to back on triplets
drawn from a droplet series resident on the device.

Traffic parameters: ``batch``, ``series_frames`` (the series, made on the
device from the seed), ``profile_steps`` (the traced sub-window).  A triplet
starting at frame t is (t, t + 2, target t + 1).

Set-up builds one trainer (model, AdamW, schedule) at the configuration,
loads the seeded weights and drives it through three steps on rows that all
differ: they are the warm-up and the steps the reference follows.  Their
losses, the first gradient (from AdamW's first moment after one step) and
each leaf's change after the three are kept.  The window runs whole steps on
rows drawn from the seed and ends in a synchronisation.  After it, the
program is freed and the plain reference takes the same three steps from the
same weights on the same rows, in float32.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from portbench import data, trace
from portbench.drivers import common
from portbench.reference.ifnet import train_steps

CHECK_STEPS = 3
POOL_STEPS = 1024  # window batches drawn ahead, reused in turn


class TrainCell:
    """The trainer at the configuration with its series and draws."""

    def __init__(self, ctx, phases: common.Phases):
        from opticalflowscivis_tpu_torch.losses.rife import RIFELossWeights
        from opticalflowscivis_tpu_torch.training import OptimConfig, TrainConfig, Trainer

        phases.mark("imports")

        cfg, traffic = ctx.config, ctx.traffic
        self.device = torch.device(ctx.device)
        self.batch_size = traffic["batch"]
        tmp = os.path.join(tempfile.gettempdir(), "portbench")
        optim = {k: v for k, v in cfg["optim"].items() if k != "total_steps"}
        tc = TrainConfig(dataset=cfg["dataset"], batch_size=self.batch_size,
                         data_dir=os.path.join(tmp, "data"), results_dir=os.path.join(tmp, "results"),
                         log_dir=os.path.join(tmp, "log"), model=common.model_config(cfg),
                         optim=OptimConfig(**optim), loss=RIFELossWeights(**cfg["loss"]))
        self.trainer = Trainer(tc, device=self.device)
        common.load_seeded(self.trainer.model, cfg, ctx.seed, self.device)
        self.trainer.init_state(cfg["optim"]["total_steps"])
        phases.mark("trainer and weights")
        self.series = data.droplet_series(ctx.seed + 1, traffic["series_frames"],
                                          tuple(cfg["size"]), cfg["max_shift"], self.device)
        n = traffic["series_frames"] - 2
        gen = torch.Generator(device=self.device)
        gen.manual_seed(ctx.seed + 2)
        self.check_rows = torch.randperm(n, generator=gen, device=self.device)[
            :CHECK_STEPS * self.batch_size].view(CHECK_STEPS, self.batch_size)
        self.pool = torch.randint(0, n, (POOL_STEPS, self.batch_size), generator=gen,
                                  device=self.device)
        self.offsets = torch.tensor([0, 2, 1], device=self.device)
        common.sync(self.device)
        phases.mark("series and draws")

    def batch(self, starts: torch.Tensor) -> torch.Tensor:
        """``[B, 3, *S, 1]``: (t, t + 2, t + 1) from each start t."""
        return self.series[starts[:, None] + self.offsets].unsqueeze(-1)

    def check_steps(self) -> tuple[dict, list[torch.Tensor]]:
        """The three first steps: the program's readings and the batches
        (on the host, for the reference)."""
        model, names = self.trainer.model, []
        params = []
        for n, p in model.named_parameters():
            names.append(n)
            params.append(p)
        start = [p.detach().clone() for p in params]
        losses, grads, batches = [], {}, []
        for k in range(CHECK_STEPS):
            b = self.batch(self.check_rows[k])
            batches.append(b.cpu())
            parts = self.trainer.train_step(b)
            losses.append(float(parts["loss_G"]))
            if k == 0:
                state = self.trainer.state.optimizer.state
                grads = {n: float(state[p]["exp_avg"].norm()) / 0.1 for n, p in zip(names, params)}
        change = {n: float((p.detach() - s).norm()) for n, p, s in zip(names, params, start)}
        return {"losses": losses, "grad": grads, "change": change}, batches

    def step(self, i: int) -> float:
        """One window step; the host's seconds to enqueue ``train_step``."""
        b = self.batch(self.pool[i % POOL_STEPS])
        t = time.perf_counter()
        self.trainer.train_step(b)
        return time.perf_counter() - t


def reference_readings(cfg: dict, seed: int, batches, device, precision=None,
                       rows: int | None = None) -> dict:
    """The reference's losses, first-gradient norms and changes after the
    steps on ``batches`` (``[B, 3, *S, 1]``); ``rows``: only the first rows
    of each batch (the half-batch fault)."""
    model = common.reference_model(cfg, seed, device, precision)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    inputs = []
    for b in batches:
        b = b[:rows].to(device).movedim(-1, 2)  # [B, 3, 1, *S]
        inputs.append((b[:, 0], b[:, 1], b[:, 2]))
    with common.float32_exact():
        losses, grads, after = train_steps(model, inputs, cfg)
    return {"losses": losses,
            "grad": {n: float(g.norm()) for n, g in grads.items()},
            "change": {n: float((after[n] - start[n]).norm()) for n in after}}


def compare(prog: dict, ref: dict) -> tuple[dict, list[str]]:
    """``(checks, notes)``.  A leaf's gap is the gap of its norms over the
    larger of its reference norm and the median leaf's.

    ``loss_gap``: the largest relative gap of a step's loss;
    ``grad_median_gap``: the median leaf's gap of the first gradient;
    ``grad_large_gap``: the worst leaf's gap of the first gradient among the
    leaves whose reference gradient is at least the median leaf's;
    ``grad_worst_gap``: the worst leaf's of all (the noise of a few sums that
    cancel, such as a head's bias: a reading that no cell compares);
    ``change_gap``: the worst leaf's gap of the change after the steps.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of the change."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med = common.median(ref["grad"].values())
    grad = {n: abs(prog["grad"][n] - g) / max(g, med) for n, g in ref["grad"].items()}
    large = {n: grad[n] for n, g in ref["grad"].items() if g >= med}
    worst_l = max(large, key=large.get)
    moved = [n for n, g in ref["grad"].items() if g >= 1e-3 * med]
    medc = common.median(ref["change"][n] for n in moved)
    change = {n: abs(prog["change"][n] - ref["change"][n]) / max(ref["change"][n], medc)
              for n in moved}
    worst_g, worst_c = max(grad, key=grad.get), max(change, key=change.get)
    notes = [
        f"losses program {prog['losses']} reference {ref['losses']}",
        f"gradient's worst leaf {worst_g}: program {prog['grad'][worst_g]:.6e} "
        f"reference {ref['grad'][worst_g]:.6e} (median leaf {med:.6e}); among the "
        f"{len(large)} at or above the median {worst_l}: program {prog['grad'][worst_l]:.6e} "
        f"reference {ref['grad'][worst_l]:.6e}",
        f"change's worst leaf {worst_c}: program {prog['change'][worst_c]:.6e} "
        f"reference {ref['change'][worst_c]:.6e} (median leaf {medc:.6e}); "
        f"{len(ref['grad']) - len(moved)} leaves left out",
    ]
    checks = {"loss_gap": common.finite(loss_gap),
              "grad_median_gap": common.finite(common.median(grad.values())),
              "grad_large_gap": common.finite(large[worst_l]),
              "change_gap": common.finite(change[worst_c]),
              "grad_worst_gap": common.finite(grad[worst_g])}
    return checks, notes


def run(ctx) -> dict:
    device = torch.device(ctx.device)
    phases = common.Phases(ctx.t0)
    cell = TrainCell(ctx, phases)
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
        n = ctx.traffic["profile_steps"]
        prof = trace.profile(lambda i: cell.step(steps + i), n, lambda: common.sync(device))
        prof["samples"] = n * cell.batch_size
    device_rec = common.device_record(device, max(peak, setup_peak))
    del cell
    common.free(device)
    t = time.perf_counter()
    ref = reference_readings(ctx.config, ctx.seed, batches, device)
    checks, notes = compare(prog, ref)
    notes.append(f"reference: {time.perf_counter() - t:.3f} s")
    return {"kind": "train", "setup_s": setup_s, "window_s": window_s,
            "samples": steps * ctx.traffic["batch"], "attempted": steps, "failed": 0,
            "host_enqueue_s": enqueue, "peak_bytes": peak, "device": device_rec,
            "profile": prof, "work": common.work(ctx.config, True), "checks": checks,
            "notes": [phases.note(), f"window: {steps} steps of {ctx.traffic['batch']} in {window_s:.4f} s"] + notes}
