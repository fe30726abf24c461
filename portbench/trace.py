"""The traced sub-window: a few steps or requests under ``torch.profiler``,
read from its Chrome trace.

``profile(fn, n, sync)`` runs ``fn(i)`` for ``i < n`` between two
synchronisations under the profiler with CUDA activity alone, so that the
host runs at nearly its unprofiled pace, and returns:

- ``kernels``: ``[name, seconds]`` of every kernel launch on the card;
- ``busy_s``: the union of the intervals in which a kernel, a copy or a
  fill ran on the card; ``window_s``: the host's clock from the first
  synchronisation to the last;
- ``device_ops``: the 10 kernels with the most time, summed by name.

Then ``fn(i)`` for ``n <= i < 2n`` runs under CPU and CUDA activity, whose
host operations slow the host down, for ``idle_gaps``: the card's idle time
between its intervals, summed by the innermost host operation that ran at
each gap's start, the 10 largest.

The kernel classes that the metrics read (``warp_seconds``,
``conv_seconds``) are named here.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")

# the port's hand-written warp kernels (csrc/warp2d.cu, csrc/warp3d.cu), forward and backward
WARP_KERNEL = re.compile(r"\bwarp[23]d(_bwd)?_kernel\b")
# convolutions and their GEMMs in cuDNN / cuBLAS / CUTLASS, with the layout
# transforms cuDNN runs around them
CONV_KERNEL = re.compile(
    r"conv|xmma|cudnn|implicit_gemm|implicit_convolve|wgrad|dgrad|fprop|cutlass|gemm|"
    r"nchwToNhwc|nhwcToNchw|nchw2nhwc|nhwc2nchw|sm90_|sm80_", re.IGNORECASE)


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _top(totals: dict, n: int = 10) -> list:
    return [[name, sec] for name, sec in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def read_trace(events: list[dict], window_s: float) -> dict:
    """The profile's numbers from Chrome-trace events (times in microseconds)."""
    device, host, kernels = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in _DEVICE_CATS:
            device.append((start, end))
            if cat == "kernel":
                kernels.append([e["name"], float(e["dur"]) * 1e-6])
        elif cat in _HOST_CATS:
            host.append((start, end, e["name"]))
    busy = _union(device)
    totals: dict = {}
    for name, sec in kernels:
        totals[name[:160]] = totals.get(name[:160], 0.0) + sec
    gaps: dict = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        inner = [h for h in host if h[0] <= a < h[1]]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "(no host operation)"
        gaps[name[:160]] = gaps.get(name[:160], 0.0) + (b - a) * 1e-6
    return {"kernels": kernels, "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": window_s, "device_ops": _top(totals), "idle_gaps": _top(gaps)}


def _session(fn, steps, sync, activities) -> tuple[list[dict], float]:
    """Chrome-trace events and the window's seconds of ``fn`` over ``steps``;
    the trace goes through a temporary file in ``TMPDIR``."""
    import torch

    sync()
    with torch.profiler.profile(activities=activities) as prof:
        t = time.perf_counter()
        for i in steps:
            fn(i)
        sync()
        window = time.perf_counter() - t
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return events, window


def profile(fn, n: int, sync) -> dict:
    """The card's activity over ``fn(i)``, ``i < n``, and the idle gaps by
    host operation over ``n <= i < 2n``; ``sync()`` waits for the device."""
    import torch
    from torch.profiler import ProfilerActivity

    cpu = ProfilerActivity.CPU
    card = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    out = read_trace(*_session(fn, range(n), sync, card or [cpu]))
    gaps = read_trace(*_session(fn, range(n, 2 * n), sync, [cpu] + card))
    out["idle_gaps"] = gaps["idle_gaps"]
    return out


def warp_seconds(prof: dict) -> float:
    return sum(sec for name, sec in prof["kernels"] if WARP_KERNEL.search(name))


def conv_seconds(prof: dict) -> float:
    return sum(sec for name, sec in prof["kernels"]
               if CONV_KERNEL.search(name) and not WARP_KERNEL.search(name))
