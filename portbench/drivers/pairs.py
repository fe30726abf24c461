"""Closed-loop pair requests from one client: ``Interpolator.forward`` on
two consecutive frames or volumes of a series resident on the device, each
request timed from its send until its merged output is synchronised.

Traffic parameters: ``series_frames`` (the series, made on the device from
the seed; request i takes pair ``i % (series_frames - 1)``),
``warmup_requests``, ``profile_requests`` (the traced sub-window) and
``check_requests`` (the requests of the window drawn from the seed, whose
outputs are kept on the device for the comparison).

The comparison: the reference's student forward in float32 on each sampled
pair.  Each of the request's three outputs is held against the reference's:
``flow_rel_rms``, ``mask_rel_rms`` and ``merged_rel_rms`` are the largest
RMS gaps over the reference's RMS.  The flow and the mask are what the
convolutions produce; the merged frame is mostly the warped frames.
"""

from __future__ import annotations

import time

import torch

from portbench import data, trace
from portbench.drivers import common


class PairCell:
    def __init__(self, ctx, phases: common.Phases):
        from opticalflowscivis_tpu_torch.inference import Interpolator

        phases.mark("imports")

        cfg, traffic = ctx.config, ctx.traffic
        self.device = torch.device(ctx.device)
        self.interp = Interpolator(common.port_model(cfg, ctx.seed, self.device),
                                   pad_multiple=cfg["pad_multiple"], device=self.device)
        phases.mark("model and weights")
        self.series = data.droplet_series(ctx.seed + 1, traffic["series_frames"],
                                          tuple(cfg["size"]), cfg["max_shift"],
                                          self.device).unsqueeze(1)  # [T, 1, *S]
        self.pairs = traffic["series_frames"] - 1
        common.sync(self.device)
        phases.mark("series")

    def request(self, i: int):
        """``(pair, (merged, flow, mask), seconds)``: the request's latency to
        its synchronised output."""
        j = i % self.pairs
        t = time.perf_counter()
        out = self.interp.forward(self.series[j:j + 1], self.series[j + 1:j + 2], 0.5)
        common.sync(self.device)
        return j, out, time.perf_counter() - t


OUTPUTS = ("merged", "flow", "mask")


def reference_outputs(model, series: torch.Tensor, j: int) -> tuple:
    """The reference's ``(merged, flow, mask)`` of pair ``j``."""
    out = model(series[j:j + 1], series[j + 1:j + 2])
    return out["merged"][-1], out["flow_list"][-1], out["mask_list"][-1]


def compare(cfg: dict, seed: int, series: torch.Tensor, sampled, device) -> tuple[dict, list[str]]:
    """``sampled``: ``(pair, (merged, flow, mask))`` of the requests kept."""
    model = common.reference_model(cfg, seed, device)
    worst, notes = dict.fromkeys(OUTPUTS, 0.0), []
    with common.float32_exact(), torch.no_grad():
        for j, outs in sampled:
            gaps = [common.rel_rms(got.float(), ref)
                    for got, ref in zip(outs, reference_outputs(model, series, j))]
            for name, gap in zip(OUTPUTS, gaps):
                worst[name] = max(worst[name], gap)
            notes.append(f"pair {j}: rms gaps " + ", ".join(
                f"{name} {gap:.6e}" for name, gap in zip(OUTPUTS, gaps)))
    return {f"{name}_rel_rms": common.finite(v) for name, v in worst.items()}, notes


def run(ctx) -> dict:
    device = torch.device(ctx.device)
    traffic = ctx.traffic
    phases = common.Phases(ctx.t0)
    cell = PairCell(ctx, phases)
    for i in range(traffic["warmup_requests"]):
        _, outs, _ = cell.request(i)
    k = traffic["check_requests"]
    kept = [torch.empty((k,) + tuple(o.shape), dtype=o.dtype, device=device) for o in outs]
    del outs
    common.sync(device)
    phases.mark("warm-up requests")
    setup_peak = common.peak_bytes(device)
    common.reset_peak(device)
    setup_s = time.perf_counter() - ctx.t0

    sample = common.Reservoir(k, ctx.seed + 3)
    latencies = []
    t = time.perf_counter()
    while True:
        j, outs, sec = cell.request(len(latencies))
        latencies.append(sec)
        slot = sample.slot()
        if slot is not None:
            for buf, o in zip(kept, outs):
                buf[slot].copy_(o)
            sample.items[slot] = j
        if time.perf_counter() - t >= ctx.seconds:
            break
    common.sync(device)
    window_s = time.perf_counter() - t
    peak = common.peak_bytes(device)

    prof = None
    if ctx.trace:
        n = traffic["profile_requests"]
        prof = trace.profile(lambda i: cell.request(len(latencies) + i), n,
                             lambda: common.sync(device))
        prof["samples"] = n
    series = cell.series
    device_rec = common.device_record(device, max(peak, setup_peak))
    del cell
    common.free(device)
    sampled = [(j, tuple(buf[s] for buf in kept)) for s, j in enumerate(sample.items)]
    t = time.perf_counter()
    checks, notes = compare(ctx.config, ctx.seed, series, sampled, device)
    notes.append(f"reference: {time.perf_counter() - t:.3f} s")
    return {"kind": "interp", "setup_s": setup_s, "window_s": window_s,
            "samples": len(latencies), "latencies_s": latencies, "attempted": len(latencies),
            "failed": 0, "peak_bytes": peak, "device": device_rec, "profile": prof,
            "work": common.work(ctx.config, False), "checks": checks,
            "notes": [phases.note(), f"window: {len(latencies)} requests in {window_s:.4f} s"] + notes}
