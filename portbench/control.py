"""The readings that a cell's limits are set from: the program's numbers over
many seeds, and the numbers of the control (the reference computing in
float8 e4m3, put in the program's place), of its convolutions alone in e4m3,
and of the faults planted in the reference, on the chip at the cell's own
size.

    python -m portbench.control --workload <name> --seeds 1,2,3 [--control-seeds 4,5,6]

For each seed of ``--seeds`` the program runs the cell's set-up and the part
of its traffic that the comparison reads (training: the three first steps;
interpolation: as many calls or requests as a run compares), and is held
against the float32 reference.  For each seed of ``--control-seeds`` the
control and its convolutions alone (``fp8_conv``) are held against the same
reference, and in training at a batch
above 1 so is the reference on half of each batch (the mean over the rest):
the half-batch fault.  One JSON line a seed, then the largest program
reading and the smallest control and fault readings of each number; each
line says whether each reading passes the cell's limits.  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import harness
from portbench.drivers import common, pairs, series, train

CONTROLS = ("control", "fp8_conv")
PRECISION = {"control": "fp8", "fp8_conv": "fp8_conv"}


def train_readings(ctx, control: bool) -> dict:
    device = torch.device(ctx.device)
    cell = train.TrainCell(ctx, common.Phases(ctx.t0))
    prog, batches = cell.check_steps()
    del cell
    common.free(device)
    ref = train.reference_readings(ctx.config, ctx.seed, batches, device)
    readings, notes = train.compare(prog, ref)
    out = {"program": readings, "notes": notes}
    if control:
        for kind in CONTROLS:
            ctl = train.reference_readings(ctx.config, ctx.seed, batches, device, PRECISION[kind])
            out[kind] = train.compare(ctl, ref)[0]
        b = ctx.traffic["batch"]
        if b > 1:
            half = train.reference_readings(ctx.config, ctx.seed, batches, device, rows=b // 2)
            out["half_batch"] = train.compare(half, ref)[0]
    return out


def series_readings(ctx, control: bool) -> dict:
    from portbench.reference.ifnet import series as ref_series

    device = torch.device(ctx.device)
    cfg, traffic = ctx.config, ctx.traffic
    cell = series.SeriesCell(ctx, common.Phases(ctx.t0))
    outs = [cell.call(i) for i in range(traffic["check_calls"])]
    frames = cell.frames
    del cell
    common.free(device)
    f = traffic["factor"]
    out = {"program": series.compare(cfg, ctx.seed, frames, outs, f, device)[0]}
    for kind in CONTROLS if control else ():
        model = common.reference_model(cfg, ctx.seed, device, PRECISION[kind])
        ctl = []
        with common.float32_exact():
            for start, recon, flows in outs:
                src = torch.from_numpy(frames[start:start + recon.shape[0]]).to(device)
                r, rf = ref_series(model, src, f, cfg["pad_multiple"], 64)
                ctl.append((start, r.cpu().numpy(), None if flows is None else rf.cpu().numpy()))
        del model
        out[kind] = series.compare(cfg, ctx.seed, frames, ctl, f, device)[0]
    return out


def pairs_readings(ctx, control: bool) -> dict:
    device = torch.device(ctx.device)
    cell = pairs.PairCell(ctx, common.Phases(ctx.t0))
    outs = []
    for i in range(ctx.traffic["check_requests"]):
        j, got, _ = cell.request(i)
        outs.append((j, tuple(o.clone() for o in got)))
    s = cell.series
    del cell
    common.free(device)
    out = {"program": pairs.compare(ctx.config, ctx.seed, s, outs, device)[0]}
    for kind in CONTROLS if control else ():
        model = common.reference_model(ctx.config, ctx.seed, device, PRECISION[kind])
        with common.float32_exact(), torch.no_grad():
            ctl = [(j, pairs.reference_outputs(model, s, j)) for j, _ in outs]
        del model
        out[kind] = pairs.compare(ctx.config, ctx.seed, s, ctl, device)[0]
    return out


READINGS = {"train": train_readings, "series": series_readings, "pairs": pairs_readings}
KINDS = ("program",) + CONTROLS + ("half_batch",)


def judged(row: dict, limits: dict) -> dict:
    """Whether each reading of ``row`` passes the cell's limits as a run
    judges it."""
    return {kind: harness.judge(row[kind], limits)[0] for kind in KINDS if kind in row}


def summary(rows: list[dict]) -> dict:
    """The largest program reading and the smallest control and fault
    reading of each number."""
    out: dict = {}
    for kind in KINDS:
        pick = max if kind == "program" else min
        seen = [r[kind] for r in rows if kind in r]
        if seen:
            out[kind] = {k: pick(s[k] for s in seen) for k in seen[0]}
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    limits = harness.read_json("limits", args.workload)
    rows = []
    plan = [(int(s), False) for s in args.seeds.split(",") if s]
    plan += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in plan:
        t = time.perf_counter()
        ctx = harness.context(cell, seed, 0.0, False, args.device, t)
        row = READINGS[ctx.traffic["driver"]](ctx, control)
        row.update(seed=seed, seconds=time.perf_counter() - t, correct=judged(row, limits))
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
