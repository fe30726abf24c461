"""Closed-loop series interpolation: ``inference.interpolate_series`` back
to back, each call on a window of a host series, as the CLI's
``interpolate`` job runs it.

Traffic parameters: ``factor`` (a power of two: the device path),
``collect_flow`` (the call also returns the flows between the kept frames),
``series_frames`` (the host series, made on the device from the seed and
downloaded once), ``call_frames``, ``call_stride`` and ``start_wrap`` (call
i reads ``call_frames`` frames from ``(call_stride * i) % start_wrap``),
``warmup_calls``, ``profile_calls`` (the traced sub-window) and
``check_calls`` (the calls of the window drawn from the seed for the
comparison).

The comparison: the reference reconstructs each sampled call's window by its
own bisection in float32; ``interp_rel_rms`` is the largest RMS gap of the
interpolated frames over their RMS, ``kept_max_abs`` the largest gap of the
kept frames, which pass through unchanged, and ``flow_rel_rms`` the largest
RMS gap of the call's flows over the reference's RMS.  The flows are what
the convolutions produce; the interpolated frames are mostly warped frames.
"""

from __future__ import annotations

import time

import torch

from portbench import data, trace
from portbench.drivers import common
from portbench.reference.ifnet import series


class SeriesCell:
    def __init__(self, ctx, phases: common.Phases):
        from opticalflowscivis_tpu_torch.inference import Interpolator

        phases.mark("imports")

        cfg, traffic = ctx.config, ctx.traffic
        self.device = torch.device(ctx.device)
        self.traffic = traffic
        self.interp = Interpolator(common.port_model(cfg, ctx.seed, self.device),
                                   pad_multiple=cfg["pad_multiple"], device=self.device)
        phases.mark("model and weights")
        frames = data.droplet_series(ctx.seed + 1, traffic["series_frames"], tuple(cfg["size"]),
                                     cfg["max_shift"], self.device)
        self.frames = frames.unsqueeze(-1).cpu().numpy()  # [T, *S, 1] on the host
        del frames
        phases.mark("series")

    def window(self, i: int):
        t = self.traffic
        start = (t["call_stride"] * i) % t["start_wrap"]
        return start, self.frames[start:start + t["call_frames"]]

    def call(self, i: int):
        from opticalflowscivis_tpu_torch.inference import interpolate_series

        start, frames = self.window(i)
        recon, flows = interpolate_series(self.interp, frames, self.traffic["factor"],
                                          collect_flow=self.traffic.get("collect_flow", False))
        return start, recon, flows

    def interpolated(self) -> int:
        """Frames a call interpolates."""
        f, n = self.traffic["factor"], self.traffic["call_frames"]
        return (n - 1) // f * (f - 1)


def compare(cfg: dict, seed: int, frames, sampled, factor: int, device) -> tuple[dict, list[str]]:
    """``sampled``: ``(start, recon, flows)`` of the calls kept; ``frames``:
    the host series."""
    model = common.reference_model(cfg, seed, device)
    worst, kept, worst_flow = 0.0, 0.0, 0.0
    notes = []
    with common.float32_exact():
        for start, recon, flows in sampled:
            src = torch.from_numpy(frames[start:start + recon.shape[0]]).to(device)
            ref, ref_flows = series(model, src, factor, cfg["pad_multiple"], rows=64)
            got = torch.from_numpy(recon).to(device)
            mid = torch.ones(recon.shape[0], dtype=torch.bool)
            mid[::factor] = False
            gap = common.rel_rms(got[mid], ref[mid])
            kept = max(kept, float((got[~mid] - src[::factor]).abs().max()))
            worst = max(worst, gap)
            note = f"call from frame {start}: interpolated frames' rms gap {gap:.6e}"
            if flows is not None:
                flow_gap = common.rel_rms(torch.from_numpy(flows).to(device), ref_flows)
                worst_flow = max(worst_flow, flow_gap)
                note += f", flows' {flow_gap:.6e}"
            notes.append(note)
    checks = {"interp_rel_rms": common.finite(worst), "kept_max_abs": kept}
    if sampled[0][2] is not None:
        checks["flow_rel_rms"] = common.finite(worst_flow)
    return checks, notes


def run(ctx) -> dict:
    device = torch.device(ctx.device)
    traffic = ctx.traffic
    phases = common.Phases(ctx.t0)
    cell = SeriesCell(ctx, phases)
    for i in range(traffic["warmup_calls"]):
        cell.call(i)
    common.sync(device)
    phases.mark("warm-up calls")
    setup_peak = common.peak_bytes(device)
    common.reset_peak(device)
    setup_s = time.perf_counter() - ctx.t0

    sample = common.Reservoir(traffic["check_calls"], ctx.seed + 3)
    calls = 0
    t = time.perf_counter()
    while True:
        out = cell.call(calls)  # the frames are on the host: the call has ended
        calls += 1
        slot = sample.slot()
        if slot is not None:
            sample.items[slot] = out
        if time.perf_counter() - t >= ctx.seconds:
            break
    window_s = time.perf_counter() - t
    peak = common.peak_bytes(device)

    prof = None
    if ctx.trace:
        n = traffic["profile_calls"]
        prof = trace.profile(lambda i: cell.call(calls + i), n, lambda: common.sync(device))
        prof["samples"] = n * cell.interpolated()
    samples = calls * cell.interpolated()
    frames = cell.frames
    device_rec = common.device_record(device, max(peak, setup_peak))
    del cell
    common.free(device)
    t = time.perf_counter()
    checks, notes = compare(ctx.config, ctx.seed, frames, sample.items, traffic["factor"], device)
    notes.append(f"reference: {time.perf_counter() - t:.3f} s")
    return {"kind": "interp", "setup_s": setup_s, "window_s": window_s, "samples": samples,
            "attempted": calls, "failed": 0, "peak_bytes": peak, "device": device_rec,
            "profile": prof, "work": common.work(ctx.config, False), "checks": checks,
            "notes": [phases.note(), f"window: {calls} calls, {samples} frames in {window_s:.4f} s"] + notes}
