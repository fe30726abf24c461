#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times ROOT

Builds every Hopper kernel of the port from the sources in this checkout,
holds each kernel against its plain PyTorch version on the card, drives the
main paths at the full width of ``ifnet_2d``, ``ifnet_3d`` and ``UPFlowNet``
and shows that each went through the kernels: interpolation serving
(``Interpolator``, ``interpolate_series``) and training (``Trainer.fit``, then
the CLI verbs generate → train → test → inference_video), on 2-D frames and on
64^3 volumes, the ``train256`` module at 128^3, and UPFlow flow estimation
(``UPFlowTrainer.predict``) and training (``UPFlowTrainer.fit``, then
``train_upflow`` → ``test_upflow``) at 256 x 832.  It compares each path with
the same weights on the CPU, and times them.

Phases, printed in order:
  1. card: ``nvidia-smi`` name and power limit, torch / CUDA versions, build time,
     each kernel's registers and spills (none allowed in ``corr_fwd_kernel``,
     ``corr_bwd_kernel``, ``warp3d_bwd_kernel`` or ``warp2d_bwd_kernel``, each
     with its count of instances), and the warps' blocks per SM;
  2. kernels vs plain on the card, forward and backward, 2-D and 3-D, every
     case against a stated tolerance; the 2-D warp also at UPFlow's feature
     shapes, in float32 and with a bf16 image under a float32 flow, its fused
     validity mask bit for bit against the warp of ones; the forwards' vector
     and element paths (ragged rows, misaligned and channels-last flows, all
     type modes) and their grid-stride loops on thin shapes; the 2-D backward
     at UPFlow's four warped feature levels and on the same paths in every
     instance (one channel, a channel loop, channel groups; with and without
     ``dimg``), each case's ``dflow`` twice bit for bit; the 3-D backward on
     the same ragged rows and grid-stride shapes, and twice bit for bit at the
     model's shape;
  3. 2-D serving path at full width, f32 and bf16, with launch counts, the CPU
     comparison and the series metrics against the linear baseline;
  4. 2-D training path at full width, f32 and bf16: ``fit`` lowers ``loss_G``,
     10 forward and 10 backward launches per train step (10 / 0 per eval
     step), ``loss.json``, checkpoint round trip, what each backward call of
     one step hands the kernel (2 of the 10 with ``dimg``); one train step
     against the CPU; the CLI verbs;
  5. 3-D serving path at full width at [4, 64, 64, 64, 1]: 6 ``warp3d``
     launches per forward (12 with TTA), the CPU comparison, a ``rectangle_3d``
     series against the linear baseline;
  6. 3-D training path: ``fit`` with the 3-D presets, 8 + 8 launches per train
     step (8 + 0 per eval step), checkpoint round trip, the strides and row
     paths of what one f32 and one bf16 train step hand the backward
     (``warp3d layouts``), ``remat`` against the plain step, one train step
     against the CPU, the CLI verbs on ``rectangle3d``, the ``train256``
     module at 128^3;
  7. the cost volume kernels against ``cost_volume_plain`` and autograd through
     it, at the five shapes UPFlow gives them and odd ones; the backward also
     on its tile's edges; both on channel slices and twice bit for bit, and
     their launches against ``forward_launch`` and ``backward_launch``;
  8. UPFlow at full width at 256 x 832: ``predict`` on 8 pairs (5 ``corr``
     and 4 ``warp2d`` launches per forward, 4 more in the losses), the bf16
     model's flow within a bound of the
     float32 model's, the CPU comparison, the layouts of the maps the model
     hands the cost volume (``corr layouts``); ``fit`` in f32 and bf16 (5 + 5
     ``corr`` / ``corr_bwd`` launches per train step, 10 + 10 with the
     ex_runner recipe), one train step against the CPU, checkpoint round trip,
     what each 2-D backward call of an f32 and a bf16 RIFE-2D and UPFlow train
     step hands the kernel (``warp2d layouts``), both decode forms, the CLI
     verbs;
  9. times (CUDA events, warm-up, inputs that vary from call to call) and
     profiles of all paths; each forward warp kernel against ``F.grid_sample``
     in turns (the median of 5 profiler windows of 40 calls each), also at
     UPFlow's finest feature warp; the 2-D backward where training runs it
     (``warp2d_bwd cases``: RIFE-2D's shape on iid and smooth flows, f32 and
     bf16, with ``dimg``; UPFlow's photometric warp and its four feature levels
     with ``dimg``, f32 and bf16 features), each with the call's device time,
     the host's µs per call, its bound and autograd through ``F.grid_sample``;
     the 3-D backward on iid and smooth flows, f32 and bf16, at 64^3 and
     256^3 (``warp3d_bwd cases``);
 10. one ``{"kernels": [...]}`` line.
The last line is ``{"ok": true, "device": {...}}``.  Any failure raises, so
the script exits nonzero and prints no result; it also does so without a
CUDA device or without the port beside it.

``--kernel-times ROOT`` runs only the kernels' timings, through the package
of another checkout at ``ROOT`` (a commit unpacked with ``git archive``): the
warps' of phase 9 (the 2-D backward's ``warp2d_bwd cases``; the 3-D backward
also on smooth flows, in bf16 and at [1, 1, 256, 256, 256]), and ``corr`` and
``corr_bwd`` at the finest UPFlow level
in f32 and bf16, both at all five levels in f32, and ``corr`` at the finest
level on channels-last f32 maps; it ends with one ``corr kernel times {...}``
and one ``kernel times {...}`` line of their medians.  Two versions of the kernels
are compared by running it on both checkouts in turns (A, B, B, A) on the
same card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# H100 SXM published peaks (NVIDIA data sheet), used for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # float32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # bf16 operands, dense, on the tensor cores

WARP_SHAPE = (32, 160, 224, 1)  # [B, H, W, C] of the serving path's warps
TRAIN_SHAPE = (64, 128, 128, 1)  # [B, H, W, C] of the training path's warps
VOLUME_SHAPE = (4, 64, 64, 64, 1)  # [B, Z, Y, X, C] of the 3-D paths' warps
RADII_3D = ((8, 8), (4, 0), (0, 0))  # (r_z, r_yx); the model passes (8, 8)
F32_TOL = 1e-5  # order of the f32 sums: the two versions add 4 taps differently
CPU_TOL = 1e-3  # f32 convs in other summation orders across 3 blocks of 13 layers
# Backward, relative to the largest reference gradient of the case.  f32: dflow
# sums C terms in another order; dimg adds up to a few dozen contributions per
# source pixel with atomics, in an order that changes from run to run.  bf16:
# each result is rounded once to bf16 (2^-9 relative) on either side.
BWD_F32_TOL = 1e-4
BWD_BF16_TOL = 1e-2
# one train step, card against CPU: f32 convolutions and their gradients in
# other summation orders through 4 blocks, relative to the largest gradient
TRAIN_PARTS_TOL = 1e-3
TRAIN_GRAD_TOL = 1e-2

UPFLOW_HW = (256, 832)  # the KITTI protocol's frame size
UPFLOW_BATCH = 8
# [B, C, H, W] of the five cost volumes of a 256 x 832 forward at batch 8: both
# directions stacked (B = 16), coarsest level first
CORR_SHAPES = ((16, 196, 4, 13), (16, 128, 8, 26), (16, 96, 16, 52), (16, 64, 32, 104),
               (16, 32, 64, 208))
CORR_ODD_SHAPE = (2, 7, 11, 13)
# the backward's tile edges: H and W not multiples of its 8 x 16 pixels, C not
# a multiple of its 8 channels a thread (nor of its 32 a block)
CORR_EDGE_SHAPE = (3, 45, 11, 13)
# the same at md 4 with rows of a multiple of 4 (not of 16), which NCHW maps
# read through the backward's instance that loads 4 elements at a time
CORR_VEC_EDGE_SHAPE = (3, 45, 11, 52)
# [B, H, W, C] of UPFlow's feature warps at the finest and the coarsest decoded
# level of the same forward; the features are bf16 by default, the flow float32
UPFLOW_WARP_SHAPES = ((16, 64, 208, 32), (16, 4, 13, 196))
# [B, H, W, C] of the four feature maps a train step warps under a gradient
# (/32, /16, /8, /4, coarsest first), and of the photometric term's warps of
# the input frames at 256 x 832, batch 8
UPFLOW_FEATURE_LEVELS = ((16, 8, 26, 128), (16, 16, 52, 96), (16, 32, 104, 64),
                         (16, 64, 208, 32))
PHOTO_SHAPE = (8, 256, 832, 3)
# bf16 model against the float32 one from the same seed-0 weights, on flow_f:
# the largest difference as a share of the float32 flow's largest component
# (bf16 rounding of the features through five decode levels, each doubling the
# flow it takes over; a validity mask may flip at a pixel on the threshold),
# and the mean difference as a share of the mean flow magnitude.  Both about
# twice what an H100 measured (0.044 and 0.0044).
UPFLOW_BF16_FLOW_MAX_TOL = 0.1
UPFLOW_BF16_FLOW_MEAN_TOL = 0.01


# launches of one call of each path as this run counted them (kernel -> count),
# filled by the phases and written into the kernels line
PER_CALL: dict[str, dict[str, int]] = {}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke failed: {msg}")


def cuda_and_host_ms(fn, iters: int, warmup: int = 3) -> tuple[float, float]:
    """Mean milliseconds per call of ``fn(i)`` over one loop, by CUDA events
    and by the host's clock around the loop and a final synchronize."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / iters
    return start.elapsed_time(end) / iters, host


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn(i)`` by CUDA events."""
    return cuda_and_host_ms(fn, iters, warmup)[0]


def is_kernel(ev, device_type) -> bool:
    """A device-side profiler event that is work of the card, not an
    annotated range (``Optimizer.step#...``), whose span would count the
    kernels under it twice and the gaps between them as device time."""
    annotated = getattr(ev, "is_user_annotation", False) or ev.key.startswith("Optimizer.")
    return ev.device_type == device_type.CUDA and not annotated


def device_ms(fn, iters: int, only: str | None = None, launches: int | None = None) -> float:
    """Mean device milliseconds per call of ``fn(i)``: the time the card's
    kernels ran, from torch.profiler (CUPTI), without the host's launch cost
    that a back-to-back CUDA-event timing of a short kernel also measures.
    ``only`` keeps the kernels whose name holds that string.  With
    ``launches`` (kernels of ``only`` per call) the time is the mean of the
    kernel events the window recorded, times ``launches``: a window can lose
    events, and dividing their sum by ``iters`` then reads low."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    # a profiler window can come back with fewer kernel events than it ran:
    # none (seen over 40 launches of one short kernel right after a window with
    # thousands of events) or some (on an H100, 1 or 7 of 40, the same number in
    # every window of a process).  A window holding less than half of them, or
    # none, is measured again, never estimated
    expected = None if launches is None else iters * launches
    for attempt in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if is_kernel(ev, DeviceType) and (only is None or only in ev.key)]
        total_us = sum(ev.self_device_time_total for ev in events)
        count = sum(ev.count for ev in events)
        if expected is None and total_us > 0:
            return total_us / iters / 1e3
        if expected is not None and total_us > 0 and expected / 2 <= count <= expected:
            if count < expected:
                print(f"device_ms: the window recorded {count} of {expected} {only} kernels; "
                      "the mean of those")
            return total_us / count * launches / 1e3
        print(f"device_ms: profiler window {attempt + 1} held {count} device events"
              f"{'' if expected is None else f' of {expected}'}, measuring again")
    raise RuntimeError("chip_smoke failed: the profiler lost device events in 5 windows")


def interleaved_device_ms(fns: dict, windows: int = 5, iters: int = 40,
                          only: str | dict | None = None, launches: int | None = None) -> dict:
    """Median device ms per call of each of ``fns`` (name -> ``fn(i)``) over
    ``windows`` profiler windows of ``iters`` calls, the functions' windows
    taken in turns (a, b, a, b, ...) so that the card's clocks and its
    neighbours weigh on each alike; with each window's time.  ``only`` and
    ``launches`` are ``device_ms``'s; ``only`` may also map each name to its
    own kernel name."""
    samples = {name: [] for name in fns}
    for _ in range(windows):
        for name, fn in fns.items():
            kernel = only.get(name) if isinstance(only, dict) else only
            samples[name].append(device_ms(fn, iters, kernel, launches))
    return {name: {"median_ms": statistics.median(v), "windows_ms": v}
            for name, v in samples.items()}


def kernel_against_library(fns: dict, bound_ms: float, kernel: str, library: str) -> dict:
    """``interleaved_device_ms`` of a kernel (``fns["kernel"]``) and the
    library call (``fns["library"]``), each one launch of the kernel whose
    name holds ``kernel`` or ``library``, their ratio, and the kernel's share
    of its bound.  (``F.grid_sample`` runs ATen's ``grid_sampler_*d_kernel``,
    or cuDNN's ``bilinear_sampler_fw_4d`` for f32 with zeros padding.)"""
    timed = interleaved_device_ms(fns, only={"kernel": kernel, "library": library}, launches=1)
    kernel, library = timed["kernel"]["median_ms"], timed["library"]["median_ms"]
    return {"kernel_ms": kernel, "library_ms": library, "kernel_over_library": kernel / library,
            "below_library": kernel < library, "bound_share": bound_ms / kernel,
            "windows_ms": {name: t["windows_ms"] for name, t in timed.items()}}


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN restricted to algorithms whose results repeat bit for bit, for
    comparisons of two evaluations of the same weights.  Without it the same
    f32 trainer evaluated twice differed by 8.5e-8 to 1.7e-7 (relative) on an
    H100, once by 1.5e-5."""
    before = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before


def bf16_ulp(x):
    """One bf16 ulp at the magnitude of each element of ``x`` (float32 tensor).
    ``frexp`` and ``ldexp`` are exact; the card's ``pow(2, -10)`` is not (it
    came out one float32 ulp short, which failed a difference of exactly one
    bf16 ulp)."""
    import torch

    mag = x.abs().clamp_min(2.0**-126)
    exponent = torch.frexp(mag).exponent  # mag = m * 2^e with m in [0.5, 1)
    return torch.ldexp(torch.ones_like(mag), exponent - 8)


def within_one_bf16_ulp(out, ref, slack: float = 0.0):
    """Whether each element of ``out`` lies within one bf16 ulp (plus
    ``slack``) of ``ref``, the ulp taken at the larger of the two magnitudes
    (two neighbouring bf16 values on either side of a power of two are one ulp
    of the upper binade apart).  ``slack`` is for sums that cancel: their
    float32 error is absolute, and near zero it exceeds any ulp of the result."""
    import torch

    out, ref = out.float(), ref.float()
    return (out - ref).abs() <= bf16_ulp(torch.maximum(out.abs(), ref.abs())) + slack


def warp_inputs(shape, dtype, seed: int, scale: float = 10.0, channels_last=False,
                flow_dtype=None):
    """Image and a (dy, dx) flow that is a channel slice of a 4-channel flow,
    as the model passes it (NCHW, or the channels-last layout cuDNN may
    produce); N(0, scale) flows, some beyond ±16.  ``flow_dtype``: the flow's
    type where it is not the image's."""
    import torch

    b, h, w, c = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand((b, c, h, w), generator=g, device="cuda").to(dtype)
    flow4 = (torch.randn((b, 4, h, w), generator=g, device="cuda") * scale).to(flow_dtype or dtype)
    if channels_last:
        flow4 = flow4.contiguous(memory_format=torch.channels_last)
    return img, flow4[:, 2:4]


def smooth_flow(torch, shape, scale: float, seed: int):
    """A flow ``[B, n, *S]`` that varies smoothly, as a model's does: N(0,
    scale) on a grid 16 times coarser, upsampled.  Neighbouring pixels' taps
    then share cache lines, which iid flows deny them."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    coarse = torch.randn(tuple(shape[:2]) + tuple(max(2, n // 16) for n in shape[2:]),
                         generator=gen, device="cuda")
    mode = "bilinear" if len(shape) == 4 else "trilinear"
    return F.interpolate(coarse, size=tuple(shape[2:]), mode=mode, align_corners=True) * scale


def grid2d(torch, flow, r: int):
    """``F.grid_sample``'s (x, y) grid in [-1, 1] for a (dy, dx) flow clipped to ±r."""
    _, _, h, w = flow.shape
    fl = flow.float().clamp(-r, r) if r else flow.float()
    ys = torch.arange(h, device="cuda", dtype=torch.float32).view(1, h, 1)
    xs = torch.arange(w, device="cuda", dtype=torch.float32).view(1, 1, w)
    return torch.stack([2.0 * (xs + fl[:, 1]) / (w - 1) - 1.0,
                        2.0 * (ys + fl[:, 0]) / (h - 1) - 1.0], dim=-1)


def clipped_grid2d(torch, flow, r: int):
    """``grid2d`` with the clip written as ``torch.where``: the 2-D backward's
    library yardstick (since PR 2), whose autograd gives 0 at and beyond r."""
    if r:
        flow = torch.where(flow.abs() < r, flow, torch.sign(flow.detach()) * r)
    return grid2d(torch, flow, 0)


def device_ms_by_kernel(fn, iters: int = 20) -> dict:
    """Device ms per call of ``fn(i)`` for each kernel it runs, from one
    profiler window: which kernels a library time covers."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    return {ev.key[:60]: ev.self_device_time_total / iters / 1e3
            for ev in prof.key_averages() if is_kernel(ev, DeviceType)}


def library_record(library, iters: int = 20) -> dict:
    """The 2-D backward's library yardstick, autograd through
    ``F.grid_sample`` and its grid: the whole pass's device ms, the sampler's
    backward kernel alone (ATen's ``grid_sampler_2d_backward_kernel`` or
    cuDNN's), and each kernel of the pass."""
    kernels = device_ms_by_kernel(library, iters)
    return {"library_ms": device_ms(library, iters),
            "library_sampler_ms": sum(ms for k, ms in kernels.items() if "ampler" in k),
            "library_kernels_ms": kernels}


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_card(torch):
    smi = card_line()
    print(smi)
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}")
    from opticalflowscivis_tpu_torch.ops.kernels.build import build

    t0 = time.perf_counter()
    # each source holds a forward and a backward kernel; one nvcc per source, in parallel
    libs = build(["warp2d", "warp3d", "corr"])
    print(f"kernel build: {time.perf_counter() - t0:.2f} s  "
          f"{[str(p.relative_to(REPO)) for p in libs.values()]}")
    ptxas = ptxas_report(["warp2d", "warp3d", "corr"])
    print("ptxas " + json.dumps(ptxas))
    bwd = {k: v for k, v in ptxas.items() if k.startswith("corr_bwd_kernel")}
    # f32 and bf16 at md 1-4 read one element a load; at md 4 both also have
    # an instance that reads 4
    check(len(bwd) == 10 and all(v.get("spill_stores") == 0 for v in bwd.values()),
          f"corr_bwd_kernel's 10 instances should build without spills: {bwd}")
    fwd = {k: v for k, v in ptxas.items() if k.startswith("corr_fwd_kernel")}
    # the same 5 per type, each for tiles of 16 rows and of 1 row
    check(len(fwd) == 20 and all(v.get("spill_stores") == 0 for v in fwd.values()),
          f"corr_fwd_kernel's 20 instances should build without spills: {fwd}")
    # f32 and bf16, with and without dimg, one channel or a channel loop,
    # border or zeros padding
    bwd3 = {k: v for k, v in ptxas.items() if k.startswith("warp3d_bwd_kernel")}
    check(len(bwd3) == 16 and all(v.get("spill_stores") == 0 for v in bwd3.values()),
          f"warp3d_bwd_kernel's 16 instances should build without spills: {bwd3}")
    # three type modes, with and without dimg, one channel, a channel loop or
    # channel groups
    bwd2 = {k: v for k, v in ptxas.items() if k.startswith("warp2d_bwd_kernel")}
    check(len(bwd2) == 18 and all(v.get("spill_stores") == 0 for v in bwd2.values()),
          f"warp2d_bwd_kernel's 18 instances should build without spills: {bwd2}")
    return smi


def ptxas_report(names: list) -> dict:
    """Registers and spill stores of each kernel of ``csrc/<name>.cu`` (kernel
    name and its mangled template arguments), from the build's ``-Xptxas -v``
    output."""
    import re

    from opticalflowscivis_tpu_torch.ops.kernels.build import ptxas_log

    report = {}
    for name in names:
        kernel = None
        for line in ptxas_log(name).splitlines():
            entry = re.search(r"Compiling entry function '\w*?\d((?:warp[23]d|corr)(?:_fwd|_bwd)?"
                              r"_kernel)I(\w*?)EEv", line)
            if entry:
                kernel = f"{entry.group(1)}<{entry.group(2)}>"
            spills = re.search(r"(\d+) bytes spill stores", line)
            if kernel and spills:
                report.setdefault(kernel, {})["spill_stores"] = int(spills.group(1))
            used = re.search(r"Used (\d+) registers", line)
            if kernel and used:
                registers = int(used.group(1))
                report.setdefault(kernel, {})["registers"] = registers
                if kernel.startswith("warp"):  # no shared memory: registers set the blocks
                    report[kernel]["blocks_per_sm_256"] = blocks_per_sm(registers, 256)
    return report


def blocks_per_sm(registers: int, threads: int) -> int:
    """Blocks of ``threads`` that fit on one SM by registers alone: 65,536
    registers, allotted per warp in units of 256 (8 a thread), at most 2048
    threads and 32 blocks."""
    per_warp = -(-registers * 32 // 256) * 256
    warps = threads // 32
    return min(65536 // per_warp // warps, 2048 // threads, 32)


def phase_kernel_vs_plain(torch):
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
    from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d, warp2d_with_mask
    from opticalflowscivis_tpu_torch.ops.warp import warp2d_plain

    worst_f32 = 0.0
    seed = 0
    for shape in (WARP_SHAPE, (3, 37, 53, 3)):
        for padding in ("border", "zeros"):
            for r in (16, 0):
                for dtype in (torch.float32, torch.bfloat16):
                    seed += 1
                    img, flow = warp_inputs(shape, dtype, seed, channels_last=shape[-1] > 1)
                    check(bool((flow.float().abs() > 16).any()), "no flow beyond ±16")
                    out = warp2d(img, flow, r, padding)
                    ref = warp2d_plain(img, flow, r, padding)
                    torch.cuda.synchronize()
                    check(out.dtype == dtype and out.shape == ref.shape, "kernel output type")
                    diff = (out.float() - ref.float()).abs()
                    err = float(diff.max())
                    if dtype == torch.float32:
                        ok, tol = err <= F32_TOL, f"{F32_TOL:g}"
                        worst_f32 = max(worst_f32, err)
                    else:
                        ok = bool((diff <= bf16_ulp(ref.float())).all())
                        tol = "1 bf16 ulp"
                    name = str(dtype).replace("torch.", "")
                    print(f"warp2d {list(shape)} {padding:6s} r={r:2d} {name:8s} "
                          f"max_abs_err={err:.3e} tol={tol} {'ok' if ok else 'FAIL'}")
                    check(ok, f"warp2d kernel disagrees with plain ({shape}, {padding}, r={r}, {name})")
    # UPFlow's warps: unbounded, at its feature shapes, float32 and the mixed
    # form (bf16 image under a float32 flow), contiguous and channels-last flows
    for shape in UPFLOW_WARP_SHAPES:
        for padding in ("border", "zeros"):
            for dtype in (torch.float32, torch.bfloat16):
                for cl in (False, True):
                    seed += 1
                    # flows of the plane's own size, so that taps fall on both sides of its edge
                    img, flow = warp_inputs(shape, dtype, seed, scale=min(10.0, shape[1] / 2),
                                            channels_last=cl, flow_dtype=torch.float32)
                    out = warp2d(img, flow, 0, padding)
                    ref = warp2d_plain(img, flow, 0, padding)
                    torch.cuda.synchronize()
                    check(out.dtype == dtype and out.shape == ref.shape, "kernel output type")
                    diff = (out.float() - ref.float()).abs()
                    err = float(diff.max())
                    if dtype == torch.float32:
                        ok, tol = err <= F32_TOL, f"{F32_TOL:g}"
                        worst_f32 = max(worst_f32, err)
                    else:
                        ok = bool((diff <= bf16_ulp(ref.float())).all())
                        tol = "1 bf16 ulp"
                    name = "float32" if dtype == torch.float32 else "bf16 img, f32 flow"
                    # UPFlow's masked warp: one launch writes the warp and the
                    # validity mask, which is the warp of ones bit for bit
                    before = LAUNCHES["warp2d"]
                    warped, mask = warp2d_with_mask(img, flow, padding)
                    torch.cuda.synchronize()
                    check(LAUNCHES["warp2d"] == before + 1, "warp2d_with_mask launch count")
                    ones = torch.ones_like(mask)
                    fused = (torch.equal(mask, warp2d(ones, flow, 0, "zeros"))
                             and torch.equal(warped, out))
                    print(f"warp2d {list(shape)} {padding:6s} r= 0 {name:18s} "
                          f"{'nhwc' if cl else 'nchw'} max_abs_err={err:.3e} tol={tol} "
                          f"fused mask bit-equal={fused} {'ok' if ok else 'FAIL'}")
                    check(ok, f"warp2d kernel disagrees with plain ({shape}, {padding}, r=0, {name})")
                    check(fused, f"warp2d's fused mask differs from the warp of ones ({shape}, "
                                 f"{padding}, {name})")
    return worst_f32


# [B, C, H, W]: ragged rows (W = 1, 13, 37, 53), single rows and pixels, one
# plane whose rows the vector path takes; H * W odd but in the last, so that
# the [:, 1:3] slice of a 4-channel flow starts on an odd element
LAYOUT_SHAPES = ((2, 3, 5, 1), (2, 2, 7, 13), (1, 3, 1, 37), (3, 1, 9, 53), (2, 1, 1, 1),
                 (2, 2, 8, 16))
TYPE_MODES = (("float32", "float32"), ("bfloat16", "bfloat16"), ("bfloat16", "float32"))


def flow_views(torch, flow):
    """``flow [B, 2, H, W]`` as the kernel may be handed it: the slice
    ``[:, 2:4]`` of a 4-channel NCHW flow, the slice ``[:, 1:3]`` (misaligned
    where H * W is odd), and a slice of a channels-last one."""
    nchw = torch.cat([flow * 0.5, flow], 1)[:, 2:4]
    misaligned = torch.cat([flow[:, :1], flow, flow[:, :1]], 1)[:, 1:3]
    nhwc = torch.cat([flow * 0.5, flow], 1).contiguous(memory_format=torch.channels_last)[:, 2:4]
    return {"nchw": nchw, "misaligned": misaligned, "nhwc": nhwc}


def phase_warp2d_layouts_vs_plain(torch):
    """The forward's vector and element paths against the plain version:
    ragged rows, single rows, aligned and misaligned NCHW flow slices and
    channels-last flows, both paddings, r 16 and 0, all three type modes; the
    fused validity mask against the warp of ones; and the grid-stride loops
    on thin shapes beyond the grid's 65535 limit."""
    from opticalflowscivis_tpu_torch.ops.kernels.warp import (
        launch_geometry,
        warp2d,
        warp2d_with_mask,
    )
    from opticalflowscivis_tpu_torch.ops.warp import warp2d_plain

    worst_f32, cases = 0.0, 0
    gen = torch.Generator(device="cuda").manual_seed(1000)
    for img_type, flow_type in TYPE_MODES:
        dt, ft = getattr(torch, img_type), getattr(torch, flow_type)
        name = f"{img_type} img, {flow_type} flow"
        for padding in ("border", "zeros"):
            for r in (16, 0):
                err, masks_equal = 0.0, True
                for b, c, h, w in LAYOUT_SHAPES:
                    img = torch.rand((b, c, h, w), generator=gen, device="cuda").to(dt)
                    flow = torch.randn((b, 2, h, w), generator=gen, device="cuda") * 10
                    flow[:, :, ::3] = torch.round(flow[:, :, ::3]) + 1e-3  # edges hit exactly
                    for layout, view in flow_views(torch, flow.to(ft)).items():
                        out = warp2d(img, view, r, padding)
                        ref = warp2d_plain(img, view, r, padding)
                        torch.cuda.synchronize()
                        diff = (out.float() - ref.float()).abs()
                        ok = (float(diff.max()) <= F32_TOL if dt == torch.float32
                              else bool((diff <= bf16_ulp(ref.float())).all()))
                        check(ok and out.dtype == dt and out.shape == ref.shape,
                              f"warp2d disagrees with plain ({(b, c, h, w)}, {layout}, {padding}, "
                              f"r={r}, {name}): {float(diff.max()):.3e}")
                        err = max(err, float(diff.max()))
                        cases += 1
                        if r == 0:
                            warped, mask = warp2d_with_mask(img, view, padding)
                            ones = torch.ones((b, 1, h, w), dtype=dt, device="cuda")
                            masks_equal &= (torch.equal(mask, warp2d(ones, view, 0, "zeros"))
                                            and torch.equal(warped, out))
                if dt == torch.float32:
                    worst_f32 = max(worst_f32, err)
                tol = f"{F32_TOL:g}" if dt == torch.float32 else "1 bf16 ulp"
                shown = f" fused mask bit-equal={masks_equal}" if r == 0 else ""
                print(f"warp2d layouts {padding:6s} r={r:2d} {name}: {len(LAYOUT_SHAPES)} shapes x "
                      f"nchw / misaligned / nhwc max_abs_err={err:.3e} tol={tol}{shown} ok")
                check(masks_equal, f"warp2d's fused mask differs from the warp of ones ({name})")
    for shape in ((70000, 1, 1, 5), (1, 2, 65535 * 256 + 3, 1)):
        check(launch_geometry(shape).strided, f"{shape} takes no grid-stride loop")
        b, c, h, w = shape
        img = torch.rand(shape, generator=gen, device="cuda")
        flow = torch.randn((b, 2, h, w), generator=gen, device="cuda") * 3
        for padding in ("border", "zeros"):
            err = float((warp2d(img, flow, 16, padding)
                         - warp2d_plain(img, flow, 16, padding)).abs().max())
            print(f"warp2d grid-stride {list(shape)} {padding:6s} r=16 float32 "
                  f"grid={launch_geometry(shape).grid} max_abs_err={err:.3e} tol={F32_TOL:g}")
            check(err <= F32_TOL, f"warp2d's grid-stride loop disagrees with plain ({shape})")
            worst_f32 = max(worst_f32, err)
            cases += 1
    print(f"warp2d layout cases: {cases}")
    return worst_f32


# the backward's paths: LAYOUT_SHAPES (one channel group each), then shapes
# whose small planes and many channels take channel groups, the last group
# of the first one short (37 channels in groups of 5)
BWD_LAYOUT_SHAPES = LAYOUT_SHAPES + ((2, 37, 3, 13), (1, 64, 5, 37))


def phase_warp2d_bwd_layouts_vs_plain(torch):
    """The backward's vector and element paths against autograd through the
    plain version, in every instance the kernel is built with: ragged rows,
    single rows and pixels, aligned and misaligned NCHW flow slices and
    channels-last flows (with a channels-last g), both paddings, r 16 and 0,
    all three type modes, with and without ``dimg``, with one channel group and
    with several; each case's ``dflow`` twice bit for bit; then the grid-stride
    loops on thin shapes.  bf16 results are held against the plain version on
    float32 copies of the same inputs: the kernel computes in float32 and
    rounds each result once."""
    from opticalflowscivis_tpu_torch.ops.kernels.warp import backward_geometry, warp2d
    from opticalflowscivis_tpu_torch.ops.warp import warp2d_plain

    def grads(fn, img, flow, g, r, padding, img_grad):
        im = img.detach().clone().requires_grad_(img_grad)
        fl = flow.detach().clone(memory_format=torch.preserve_format).requires_grad_(True)
        fn(im, fl, r, padding).backward(g)
        return im.grad, fl.grad

    def held(img, flow, g, r, padding, img_grad, tol, what):
        """Largest error over the largest reference gradient of one case; raises
        where it exceeds ``tol``, where dflow is not 0 at and beyond r, or where
        two runs differ."""
        got = grads(warp2d, img, flow, g, r, padding, img_grad)
        want = grads(warp2d_plain, img.float(), flow.float(), g.float(), r, padding, img_grad)
        ratio = 0.0
        for name, a, ref in zip(("dimg", "dflow"), got, want):
            if ref is None:
                check(a is None, "an image gradient nobody asked for")
                continue
            check(a.dtype == (img.dtype if name == "dimg" else flow.dtype)
                  and a.shape == ref.shape, f"{name} type ({what})")
            err = float((a.float() - ref).abs().max())
            ratio = max(ratio, err / max(float(ref.abs().max()), 1e-30))
        if r:
            check(bool((got[1][flow.float().abs() >= r] == 0).all()),
                  f"dflow not 0 at and beyond r ({what})")
        check(ratio <= tol, f"warp2d backward disagrees with plain ({what}): {ratio:.3e}")
        check(dflow_repeats(torch, img, flow, g, r, padding, img_grad),
              f"two warp2d backward runs differ ({what})")
        return ratio

    cases = 0
    gen = torch.Generator(device="cuda").manual_seed(2000)
    for img_type, flow_type in TYPE_MODES:
        dt, ft = getattr(torch, img_type), getattr(torch, flow_type)
        tol = BWD_F32_TOL if dt == torch.float32 else BWD_BF16_TOL
        name = f"{img_type} img, {flow_type} flow"
        for padding in ("border", "zeros"):
            for r in (16, 0):
                worst = 0.0
                for b, c, h, w in BWD_LAYOUT_SHAPES:
                    img = torch.rand((b, c, h, w), generator=gen, device="cuda").to(dt)
                    flow = torch.randn((b, 2, h, w), generator=gen, device="cuda") * 10
                    flow = torch.round(flow * 4) / 4 + 0.11  # off the weights' kinks
                    g = torch.randn((b, c, h, w), generator=gen, device="cuda").to(dt)
                    for layout, view in flow_views(torch, flow.to(ft)).items():
                        gv = g.contiguous(memory_format=torch.channels_last
                                          if layout == "nhwc" else torch.contiguous_format)
                        for img_grad in (False, True):
                            what = f"{(b, c, h, w)}, {layout}, {padding}, r={r}, {name}, " \
                                   f"dimg={img_grad}"
                            worst = max(worst, held(img, view, gv, r, padding, img_grad, tol,
                                                    what))
                            cases += 1
                print(f"warp2d_bwd layouts {padding:6s} r={r:2d} {name}: "
                      f"{len(BWD_LAYOUT_SHAPES)} shapes (channel groups "
                      f"{[backward_geometry((b, c, h, w)).groups for b, c, h, w in BWD_LAYOUT_SHAPES]}"
                      f") x nchw / misaligned / nhwc x dimg or not: worst err/max|ref| "
                      f"{worst:.3e} tol={tol:g}, dflow repeats bit-equal ok")
    for shape in ((70000, 1, 1, 5), (70000, 16, 1, 5), (1, 2, 65535 * 256 + 3, 1)):
        geometry = backward_geometry(shape)
        check(geometry.strided, f"{shape} takes no grid-stride loop")
        b, c, h, w = shape
        img = torch.rand(shape, generator=gen, device="cuda")
        flow = torch.round(torch.randn((b, 2, h, w), generator=gen, device="cuda") * 12) + 0.11
        g = torch.randn(shape, generator=gen, device="cuda")
        for padding in ("border", "zeros"):
            for img_grad in (False, True):
                ratio = held(img, flow, g, 16, padding, img_grad, BWD_F32_TOL,
                             f"grid-stride {shape}, {padding}, dimg={img_grad}")
                print(f"warp2d_bwd grid-stride {list(shape)} {padding:6s} r=16 float32 "
                      f"img_grad={int(img_grad)} grid={geometry.grid} groups={geometry.groups} "
                      f"err/max|ref|={ratio:.3e} tol={BWD_F32_TOL:g}")
                cases += 1
    print(f"warp2d_bwd layout cases: {cases}")


def phase_main_path(torch):
    from opticalflowscivis_tpu_torch.data import rectangle_2d
    from opticalflowscivis_tpu_torch.evalsuite import (
        calculate_metrics,
        linear_interpolation_baseline,
    )
    from opticalflowscivis_tpu_torch.inference import Interpolator, interpolate_series
    from opticalflowscivis_tpu_torch.models import ifnet_2d
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    b, h, w, c = WARP_SHAPE
    model32 = ifnet_2d(device="cuda", seed=0)
    model16 = ifnet_2d(dtype=torch.bfloat16, device="cuda", seed=0)
    interp32 = Interpolator(model32)
    interp16 = Interpolator(model16)
    interp_tta = Interpolator(model32, tta=True)
    rng = np.random.default_rng(0)
    a = rng.random((b, h, w, c), dtype=np.float32)
    z = rng.random((b, h, w, c), dtype=np.float32)
    series = rectangle_2d(n_frames=33, grid=(h, w), seed=0)[..., :1]

    def launches_of(fn):
        before = LAUNCHES["warp2d"]
        res = fn()
        torch.cuda.synchronize()
        return res, LAUNCHES["warp2d"] - before

    reset_launches()  # the main path's run starts here
    outs = {}
    for name, interp in (("f32", interp32), ("bf16", interp16)):
        (merged, flow, mask), n = launches_of(lambda: interp.pair(a, z))
        print(f"pair {name} [{b},{h},{w},{c}]: warp2d launches={n}")
        check(n == 6, f"{name} forward launched warp2d {n} times, expected 6")
        PER_CALL["ifnet_2d_forward"] = {"warp2d": n}
        check(merged.shape == (b, h, w, c) and flow.shape == (b, h, w, 4)
              and mask.shape == (b, h, w, 1), f"{name} output shapes")
        check(all(np.isfinite(x).all() for x in (merged, flow, mask)), f"{name} not finite")
        outs[name] = (merged, flow, mask)
    _, n = launches_of(lambda: interp_tta.pair(a[:2], z[:2]))
    print(f"pair tta [2,{h},{w},{c}]: warp2d launches={n}")
    check(n == 12, f"TTA forward launched warp2d {n} times, expected 12")
    d16 = np.abs(outs["bf16"][0] - outs["f32"][0]).max()
    print(f"merged bf16 vs f32 max_abs_diff={d16:.3e}")

    # the same weights on the CPU (the plain path) at batch 2
    cpu_model = ifnet_2d(device="cpu", seed=0)
    cpu_model.load_state_dict(model32.state_dict())
    cpu = Interpolator(cpu_model, device="cpu").pair(a[:2], z[:2])
    (gpu), n = launches_of(lambda: interp32.pair(a[:2], z[:2]))
    check(n == 6, "batch-2 forward launches")
    for name, x, y in zip(("merged", "flow", "mask"), gpu, cpu):
        err = float(np.abs(x - y).max())
        tol = CPU_TOL * max(1.0, float(np.abs(y).max()))
        print(f"cuda vs cpu {name}: max_abs_err={err:.3e} tol={tol:.3e} "
              f"max|cpu|={np.abs(y).max():.3e}")
        check(err <= tol, f"cuda {name} disagrees with the CPU plain path")

    for factor in (2, 4):
        (recon, _), n = launches_of(lambda: interpolate_series(interp32, series, factor))
        k = recon.shape[0]
        psnr, ssim_v = calculate_metrics(series[:k, ..., 0] * 255.0, recon[..., 0] * 255.0, factor)
        base = linear_interpolation_baseline(series[:k], factor)
        psnr_b, ssim_b = calculate_metrics(series[:k, ..., 0] * 255.0, base[..., 0] * 255.0, factor)
        vals = {"factor": factor, "frames": k, "warp2d_launches": n, "psnr": psnr,
                "ssim": ssim_v, "psnr_linear_baseline": psnr_b, "ssim_linear_baseline": ssim_b}
        print("series " + json.dumps(vals))
        check(recon.shape == (33, h, w, 1) and np.isfinite(recon).all(), "series output")
        check(all(math.isfinite(v) for v in (psnr, ssim_v, psnr_b, ssim_b)), "series metrics")
        check(n == 6 * int(math.log2(factor)), f"series x{factor} launches {n}")
    torch.cuda.synchronize()
    total = LAUNCHES["warp2d"]  # read just after the main path's run
    print(f"main path: warp2d launches={total}")
    check(total > 0, "the main path never launched warp2d")
    return total, (interp32, interp16, a, z)


def profile_forward(torch, name: str, fn, iters: int = 3, unit: str = "forward") -> None:
    """Device time by kernel over ``iters`` forwards (or train steps), and the
    busy share of the window's wall time (torch.profiler, CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [
        (ev.key, ev.self_device_time_total, ev.count)
        for ev in prof.key_averages()
        if is_kernel(ev, DeviceType) and ev.self_device_time_total > 0
    ]
    total = sum(t for _, t, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    def share(part: str) -> float:
        return sum(t for k, t, _ in kernels if part in k) / max(total, 1e-9)

    print("profile " + json.dumps({
        "compute": name, f"{unit}s": iters,
        f"device_ms_per_{unit}": total / iters / 1e3,
        f"wall_ms_per_{unit}": wall_us / iters / 1e3,
        "busy_share": total / wall_us,
        "warp2d_share": share("warp2d_kernel"),
        "warp2d_bwd_share": share("warp2d_bwd_kernel"),
        "warp3d_share": share("warp3d_kernel"),
        "warp3d_bwd_share": share("warp3d_bwd_kernel"),
        "corr_share": share("corr_fwd_"),
        "corr_bwd_share": share("corr_bwd_"),
        "kernel_launches": sum(n for _, _, n in kernels) // iters,
        "top": [{"kernel": k[:70], "share": t / max(total, 1e-9), "launches": n // iters}
                for k, t, n in top],
    }))


def phase_times(torch, interps):
    interp32, interp16, a, z = interps
    b, h, w, c = WARP_SHAPE
    times = {}
    for name, interp in (("f32", interp32), ("bf16", interp16)):
        sets = []
        for i in range(4):
            g = torch.Generator(device="cuda").manual_seed(100 + i)
            sets.append((torch.rand((b, c, h, w), generator=g, device="cuda"),
                         torch.rand((b, c, h, w), generator=g, device="cuda")))
        ms = cuda_ms(lambda i: interp.forward(*sets[i % 4]), iters=20)
        times[f"pairs_per_sec_{name}"] = b / (ms / 1e3)
        times[f"forward_ms_{name}"] = ms
        t0 = time.perf_counter()
        for i in range(5):
            interp.pair(a + i * 1e-3, z)
        torch.cuda.synchronize()
        times[f"pair_call_pairs_per_sec_{name}"] = 5 * b / (time.perf_counter() - t0)
        profile_forward(torch, name, lambda i: interp.forward(*sets[i % 4]))

    print("times " + json.dumps(times))
    warp = warp2d_forward_times(torch)
    return times, warp


def warp2d_forward_times(torch):
    """The forward kernel at the serving path's warp, [32, 1, 160, 224] f32,
    border, r = 16, flow a 2-channel slice: against ``F.grid_sample`` in
    turns on iid and on smooth flows, its plain version and its bound."""
    import torch.nn.functional as F

    from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d
    from opticalflowscivis_tpu_torch.ops.warp import warp2d_plain

    b, h, w, c = WARP_SHAPE
    sets = [warp_inputs(WARP_SHAPE, torch.float32, 200 + i) for i in range(4)]

    def kernel(i):
        return warp2d(*sets[i % 4], 16, "border")

    def plain(i):
        return warp2d_plain(*sets[i % 4], 16, "border")

    grids = [(img, grid2d(torch, flow, 16)) for img, flow in sets]

    def library(i, grids=grids):
        return F.grid_sample(*grids[i % 4], mode="bilinear", padding_mode="border",
                             align_corners=True)

    # back-to-back calls timed by CUDA events: device time or the host's
    # per-call cost, whichever is larger
    call_ms = {name: cuda_ms(f, 40) for name, f in
               (("kernel", kernel), ("plain", plain), ("library", library))}
    px = b * h * w
    bytes_moved = px * (4 * c + 8 + 4 * c)  # img read, (dy, dx) read, out written
    flops = px * (24 + 7 * c)  # clip, coords, floor, fractions, 4 weights; 4 taps/ch
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    # the kernel and F.grid_sample in turns: median of 5 windows of 40 calls each
    warp = kernel_against_library({"kernel": kernel, "library": library}, max(bytes_ms, ops_ms),
                                  "warp2d_kernel", "sampler")
    warp.update({
        "plain_ms": device_ms(plain, 40),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": bytes_moved,
        "back_to_back_call_ms": call_ms,
        "achieved_GBps": bytes_moved / (warp["kernel_ms"] / 1e3) / 1e9,
    })
    # the same images under smooth flows of the same scale, in turns again
    smooth = [(img, smooth_flow(torch, (b, 4, h, w), 10.0, 210 + i)[:, 2:4])
              for i, (img, _) in enumerate(sets)]
    smooth_grids = [(img, grid2d(torch, flow, 16)) for img, flow in smooth]
    warp["smooth_flow"] = kernel_against_library({
        "kernel": lambda i: warp2d(*smooth[i % 4], 16, "border"),
        "library": lambda i: library(i, smooth_grids)}, warp["bound_ms"],
        "warp2d_kernel", "sampler")
    print("warp2d times " + json.dumps(warp) + "  (bound: H100 SXM 3.35 TB/s, 67 TFLOP/s f32)")
    return warp


def phase_upflow_warp_times(torch):
    """``warp2d`` at UPFlow's finest feature warp, [16, 32, 64, 208], r = 0,
    zeros, in float32 and in the bf16 default's mixed form (bf16 image under a
    float32 flow), without and with the fused validity mask, against
    ``F.grid_sample`` in turns.  ``F.grid_sample`` takes one dtype, so in the
    mixed form its grid is bf16."""
    import torch.nn.functional as F

    from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d, warp2d_with_mask

    shape = UPFLOW_WARP_SHAPES[0]
    b, h, w, c = shape
    out = {}
    for name, dtype in (("float32", torch.float32), ("bf16_img_f32_flow", torch.bfloat16)):
        sets = [warp_inputs(shape, dtype, 1100 + i, scale=min(10.0, h / 2),
                            flow_dtype=torch.float32) for i in range(4)]
        grids = [(img, grid2d(torch, flow, 0).to(dtype)) for img, flow in sets]

        def kernel(i, sets=sets):
            return warp2d(*sets[i % 4], 0, "zeros")

        def masked(i, sets=sets):
            return warp2d_with_mask(*sets[i % 4], "zeros")

        def library(i, grids=grids):
            return F.grid_sample(*grids[i % 4], mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

        size = 4 if dtype == torch.float32 else 2
        px = b * h * w
        bytes_moved = px * (size * c + 8 + size * c)  # img read, f32 (dy, dx) read, out written
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = px * (24 + 7 * c) / F32_FLOPS_PER_S * 1e3
        res = kernel_against_library({"kernel": kernel, "library": library},
                                     max(bytes_ms, ops_ms), "warp2d_kernel", "sampler")
        masked_ms = device_ms(masked, 40, only="warp2d_kernel", launches=1)
        res.update({
            "with_mask_ms": masked_ms,
            "with_mask_bound_ms": (bytes_moved + px * size) / HBM_BYTES_PER_S * 1e3,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_moved,
            "achieved_GBps": bytes_moved / (res["kernel_ms"] / 1e3) / 1e9,
        })
        out[name] = res
    print("warp2d upflow times " + json.dumps(out) + f"  (shape {list(shape)} [B,H,W,C], r=0, "
          "zeros; bound: H100 SXM 3.35 TB/s, 67 TFLOP/s f32)")
    return out


def backward_inputs(torch, shape, dtype, seed: int, channels_last: bool, scale: float = 10.0,
                    flow_dtype=None):
    """Image, 4-channel flow (the warp takes its last two channels) and an
    incoming gradient; flow and gradient in NCHW or channels-last layout.
    ``flow_dtype``: the flow's type where it is not the image's."""
    b, h, w, c = shape
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand((b, c, h, w), generator=gen, device="cuda").to(dtype)
    # off-integer flows: at an integer coordinate the bilinear weights have a kink
    flow4 = torch.randn((b, 4, h, w), generator=gen, device="cuda") * scale
    flow4 = (torch.round(flow4 * 4) / 4 + 0.11).to(flow_dtype or dtype).contiguous(
        memory_format=fmt)
    g = torch.randn((b, c, h, w), generator=gen, device="cuda").to(dtype)
    return img, flow4, g.contiguous(memory_format=fmt)


def warp_grads(torch, fn, img, flow4, g, r, padding, img_grad: bool):
    """(dimg or None, dflow [B, 2, H, W]) of ``fn`` through autograd."""
    im = img.detach().clone().requires_grad_(img_grad)
    fl = flow4.detach().clone(memory_format=torch.preserve_format).requires_grad_(True)
    fn(im, fl[:, 2:4], r, padding).backward(g)
    return im.grad, fl.grad[:, 2:4]


def dflow_repeats(torch, img, flow, g, r: int, padding: str, need_dimg: bool) -> bool:
    """Whether two launches of the 2-D backward give the same ``dflow`` bit
    for bit (it is written once per pixel, channel groups added in order)."""
    from opticalflowscivis_tpu_torch.ops.kernels.warp import _launch_backward

    runs = [_launch_backward(img, flow, g, r, padding, need_dimg)[1] for _ in range(2)]
    return torch.equal(runs[0], runs[1])


def phase_backward_vs_plain(torch):
    """The backward kernel against autograd through the plain version, each
    case's ``dflow`` twice bit for bit: RIFE-2D's shape and a ragged one, then
    UPFlow's four warped feature levels and its coarsest map."""
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
    from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d
    from opticalflowscivis_tpu_torch.ops.warp import warp2d_plain

    worst_f32 = 0.0
    seed = 100
    for shape in (TRAIN_SHAPE, (3, 37, 53, 3)):
        for padding in ("border", "zeros"):
            for r in (16, 0):
                for dtype in (torch.float32, torch.bfloat16):
                    # the small shape runs with channels-last flow and gradient;
                    # the big one also once without an image gradient
                    variants = [True] if shape[-1] > 1 else [True, False]
                    for img_grad in variants:
                        seed += 1
                        cl = shape[-1] > 1
                        img, flow4, g = backward_inputs(torch, shape, dtype, seed, cl)
                        check(bool((flow4.float().abs() > 16).any()), "no flow beyond ±16")
                        before = LAUNCHES["warp2d_bwd"]
                        dimg, dflow = warp_grads(torch, warp2d, img, flow4, g, r, padding, img_grad)
                        torch.cuda.synchronize()
                        check(LAUNCHES["warp2d_bwd"] == before + 1, "backward launch count")
                        dimg_ref, dflow_ref = warp_grads(torch, warp2d_plain, img, flow4, g, r,
                                                         padding, img_grad)
                        check(LAUNCHES["warp2d_bwd"] == before + 1, "the plain version launched")
                        tol = BWD_F32_TOL if dtype == torch.float32 else BWD_BF16_TOL
                        errs = {}
                        pairs = [("dflow", dflow, dflow_ref)]
                        if img_grad:
                            pairs.append(("dimg", dimg, dimg_ref))
                        else:
                            check(dimg is None, "an image gradient nobody asked for")
                        ok = True
                        for name, out, ref in pairs:
                            check(out.dtype == dtype and out.shape == ref.shape, f"{name} type")
                            err = float((out.float() - ref.float()).abs().max())
                            scale = float(ref.float().abs().max())
                            errs[name] = (err, scale)
                            ok = ok and err <= tol * scale
                            if dtype == torch.float32:
                                worst_f32 = max(worst_f32, err)
                        if r > 0:  # clamped components carry no gradient
                            clamped = flow4[:, 2:4].float().abs() >= r
                            ok = ok and bool((dflow[clamped] == 0).all())
                        same = dflow_repeats(torch, img, flow4[:, 2:4], g, r, padding, img_grad)
                        name = str(dtype).replace("torch.", "")
                        shown = " ".join(f"{k}_err={e:.3e} (max|ref|={m:.3e})"
                                         for k, (e, m) in errs.items())
                        print(f"warp2d_bwd {list(shape)} {padding:6s} r={r:2d} {name:8s} "
                              f"{'nhwc' if cl else 'nchw'} img_grad={int(img_grad)} {shown} "
                              f"tol={tol:g}*max|ref| dflow repeats bit-equal={same} "
                              f"{'ok' if ok and same else 'FAIL'}")
                        check(same, f"two warp2d backward runs differ ({shape}, {padding}, "
                                    f"r={r}, {name}, img_grad={img_grad})")
                        check(ok, f"warp2d backward disagrees with plain ({shape}, {padding}, "
                                  f"r={r}, {name}, img_grad={img_grad})")
    # UPFlow's feature warps: unbounded, with the image's gradient, float32 and
    # the mixed form, whose dimg is bf16 and whose dflow stays float32; the four
    # warped levels, finest first, and the coarsest map
    for shape in UPFLOW_FEATURE_LEVELS[::-1] + UPFLOW_WARP_SHAPES[1:]:
        for padding in ("border", "zeros"):
            for dtype in (torch.float32, torch.bfloat16):
                for cl in (False, True):
                    seed += 1
                    img, flow4, g = backward_inputs(torch, shape, dtype, seed, cl,
                                                    scale=min(10.0, shape[1] / 2),
                                                    flow_dtype=torch.float32)
                    before = LAUNCHES["warp2d_bwd"]
                    dimg, dflow = warp_grads(torch, warp2d, img, flow4, g, 0, padding, True)
                    torch.cuda.synchronize()
                    check(LAUNCHES["warp2d_bwd"] == before + 1, "backward launch count")
                    dimg_ref, dflow_ref = warp_grads(torch, warp2d_plain, img, flow4, g, 0,
                                                     padding, True)
                    check(LAUNCHES["warp2d_bwd"] == before + 1, "the plain version launched")
                    check(dimg.dtype == dtype and dflow.dtype == torch.float32
                          and dimg.shape == dimg_ref.shape and dflow.shape == dflow_ref.shape,
                          "gradient types")
                    tol = BWD_F32_TOL if dtype == torch.float32 else BWD_BF16_TOL
                    ok, shown = True, []
                    for what, out, ref in (("dflow", dflow, dflow_ref), ("dimg", dimg, dimg_ref)):
                        err = float((out.float() - ref.float()).abs().max())
                        scale = float(ref.float().abs().max())
                        ok = ok and err <= tol * scale
                        shown.append(f"{what}_err={err:.3e} (max|ref|={scale:.3e})")
                        if dtype == torch.float32:
                            worst_f32 = max(worst_f32, err)
                    name = "float32" if dtype == torch.float32 else "bf16 img, f32 flow"
                    same = dflow_repeats(torch, img, flow4[:, 2:4], g, 0, padding, True)
                    print(f"warp2d_bwd {list(shape)} {padding:6s} r= 0 {name:18s} "
                          f"{'nhwc' if cl else 'nchw'} img_grad=1 {' '.join(shown)} "
                          f"tol={tol:g}*max|ref| dflow repeats bit-equal={same} "
                          f"{'ok' if ok else 'FAIL'}")
                    check(ok, f"warp2d backward disagrees with plain ({shape}, {padding}, r=0, "
                              f"{name})")
                    check(same, f"two warp2d backward runs differ ({shape}, {padding}, {name})")
    return worst_f32


def train_config(torch, tmp: str, bfloat16: bool, **kw):
    """The configuration the reference's bench times: ``ifnet_2d`` at full
    width, batch 64, flow-supervised 2-D losses.  The warm-up is cut from 2000
    steps to 20 so that a few dozen steps move the loss."""
    from opticalflowscivis_tpu_torch.losses import RIFELossWeights
    from opticalflowscivis_tpu_torch.training import ModelConfig, OptimConfig, TrainConfig

    name = "bf16" if bfloat16 else "f32"
    return TrainConfig(
        dataset="rectangle2d", batch_size=64,
        model=ModelConfig(bfloat16=bfloat16),
        loss=RIFELossWeights.preset_2d(flow_supervised=True),
        optim=OptimConfig(warmup_steps=20),
        data_dir=os.path.join(tmp, "data"), log_dir=os.path.join(tmp, f"log_{name}"),
        results_dir=os.path.join(tmp, f"res_{name}"), **kw,
    )


def phase_training(torch, tmp: str):
    """``Trainer.fit`` at full width on 128x128 rectangle tuples, f32 and bf16."""
    from opticalflowscivis_tpu_torch.data import group_tuples, rectangle_2d
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from opticalflowscivis_tpu_torch.training import Trainer

    b, h, w, _ = TRAIN_SHAPE
    epochs, steps_per_epoch, n_val = 6, 4, 16
    frames = rectangle_2d(n_frames=3 * (steps_per_epoch * b + n_val), grid=(h, w), box=(60, 80),
                          seed=0)
    tuples = group_tuples(frames, 1).astype(np.float32)
    train, val = tuples[: steps_per_epoch * b], tuples[steps_per_epoch * b :]
    check(train.shape == (steps_per_epoch * b, 3, h, w, 3) and val.shape[0] == n_val, "tuples")

    launches = {"warp2d": 0, "warp2d_bwd": 0}
    trainers = {}
    for bfloat16 in (False, True):
        name = "bf16" if bfloat16 else "f32"
        cfg = train_config(torch, tmp, bfloat16)
        tr = Trainer(cfg)
        reset_launches()  # the training path's run starts here
        hist = tr.fit(train, val, epochs=epochs, log_every=0)
        torch.cuda.synchronize()
        counts = {k: LAUNCHES[k] for k in launches}  # read just after the run
        steps, evals = epochs * steps_per_epoch, epochs  # one val chunk per epoch
        print(f"fit {name}: {steps} train steps + {evals} eval steps at [{b},{h},{w},1]: "
              f"launches={counts} loss_G first eval {hist[0]['loss_G']:.6f} "
              f"last {hist[-1]['loss_G']:.6f}")
        check(len(hist) == epochs and tr.state.step == steps, f"{name} fit length")
        check(all(math.isfinite(v) for parts in hist for v in parts.values()),
              f"{name} losses not finite")
        check(hist[-1]["loss_G"] < hist[0]["loss_G"], f"{name} fit did not lower loss_G")
        check(counts["warp2d"] == 10 * (steps + evals),
              f"{name}: {counts['warp2d']} forward launches, expected 10 per train and eval step")
        check(counts["warp2d_bwd"] == 10 * steps,
              f"{name}: {counts['warp2d_bwd']} backward launches, expected 10 per train step")
        for key in launches:
            launches[key] += counts[key]

        with open(os.path.join(tr.results_dir, "loss.json")) as f:
            rows = json.load(f)["val_loss"]
        check(len(rows) == epochs and all(len(row) == 7 for row in rows), f"{name} loss.json")
        check(os.path.isfile(tr.checkpoint_path()), f"{name} checkpoint not written")
        fresh = Trainer(cfg)
        fresh.init_state(total_steps=steps)
        check(fresh.load_checkpoint() and fresh.state.step == steps, f"{name} checkpoint load")
        restored = fresh.model.state_dict()
        check(all(torch.equal(v, restored[k]) for k, v in tr.model.state_dict().items()),
              f"{name}: restored weights differ")

        def rel_diff(x, y):
            return max(abs(x[k] - y[k]) / max(abs(x[k]), 1e-12) for k in x)

        with deterministic_cudnn(torch):
            ours = tr.evaluate(val, b)
            again = rel_diff(ours, tr.evaluate(val, b))
            theirs = rel_diff(ours, fresh.evaluate(val, b))
        # the weights are compared bit for bit above; in bf16 the card's
        # convolutions do not repeat bit for bit from run to run
        tol = 1e-6 if not bfloat16 else 1e-3
        print(f"checkpoint {name}: restored step {fresh.state.step}, weights equal, evaluate "
              f"rel diff {theirs:.3e} (same trainer twice: {again:.3e}) tol={tol:g}")
        check(theirs <= tol, f"{name}: the restored trainer evaluates differently")
        trainers[name] = (tr, train)
    print(f"training path: launches={launches}")
    check(all(v > 0 for v in launches.values()), "the training path missed a kernel")
    for name, (tr, train) in trainers.items():
        # the photometric term's 2 warps of the prediction carry its gradient
        record_warp2d_layouts(torch, f"rife_{name}",
                              lambda tr=tr, train=train: tr.train_step(tr.upload(train[:b])), 10, 2)
    return launches, trainers


# what each backward call of one train step hands the 2-D backward kernel,
# per path and type (the ``warp2d layouts`` line)
WARP2D_LAYOUTS: dict[str, list] = {}


def warp2d_row_path(t, pair: bool) -> str:
    """The path the 2-D backward kernel's rows of 4 pixels take through ``t``
    (a flow if ``pair``, else g): a channels-last (dy, dx) pair is one load
    ("pair"), a row of 4 aligned elements one vector load ("vector"),
    anything else element by element ("element")."""
    size = t.element_size()
    if pair and t.stride(1) == 1 and t.stride(-1) % 2 == 0 and t.data_ptr() % (2 * size) == 0:
        return "pair"
    aligned = t.data_ptr() % (4 * size) == 0 and all(st % 4 == 0 for st in t.stride()[:-1])
    return "vector" if t.stride(-1) == 1 and aligned and t.shape[-1] % 4 == 0 else "element"


def record_warp2d_layouts(torch, name: str, step, calls: int, with_dimg: int) -> list:
    """Run one train step (``step()``) and keep, under ``name`` in
    ``WARP2D_LAYOUTS``, the image's shape and type, the flow's type and
    strides, g's strides, padding, r, ``need_dimg`` and the rows' paths of
    each of its ``calls`` calls of ``_launch_backward``, ``with_dimg`` of
    which ask for the image's gradient."""
    from opticalflowscivis_tpu_torch.ops.kernels import warp as kernels_warp

    original = kernels_warp._launch_backward
    seen = []

    def record(img, flow, grad_out, r, padding, need_dimg):
        seen.append({
            "shape": list(img.shape), "dtype": str(img.dtype).replace("torch.", ""),
            "flow_dtype": str(flow.dtype).replace("torch.", ""),
            "flow_strides": list(flow.stride()), "grad_strides": list(grad_out.stride()),
            "rows": [warp2d_row_path(flow, True), warp2d_row_path(grad_out, False)],
            "padding": padding, "r": r, "need_dimg": bool(need_dimg)})
        return original(img, flow, grad_out, r, padding, need_dimg)

    try:
        kernels_warp._launch_backward = record
        step()
    finally:
        kernels_warp._launch_backward = original
    torch.cuda.synchronize()
    check(len(seen) == calls, f"{name}: {len(seen)} warp2d backward calls a step, expected {calls}")
    check(sum(c["need_dimg"] for c in seen) == with_dimg,
          f"{name}: expected {with_dimg} of the {calls} calls with dimg: {seen}")
    WARP2D_LAYOUTS[name] = seen
    return seen


def phase_train_step_vs_cpu(torch, tmp: str):
    """One train step at batch 2 from the same weights, card against CPU.

    The frames carry a random texture: on an exactly flat background the
    photometric term compares zero with zero, where ``(x² + ε²)^0.25``
    (ε = 1e-9) turns float32 rounding into gradients of order 1e3, and both
    devices would follow their own rounding."""
    from opticalflowscivis_tpu_torch.data import group_tuples, rectangle_2d
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
    from opticalflowscivis_tpu_torch.training import Trainer

    _, h, w, _ = TRAIN_SHAPE
    tuples = group_tuples(rectangle_2d(n_frames=6, grid=(h, w), box=(60, 80), seed=1), 1)
    tuples = tuples.astype(np.float32)
    tuples[..., 0] += np.random.default_rng(0).uniform(0.05, 0.3, tuples.shape[:-1]).astype(
        np.float32)
    cfg = train_config(torch, tmp, bfloat16=False)
    parts, grads = {}, {}
    for device in ("cuda", "cpu"):
        tr = Trainer(cfg, device=device)
        tr.init_state(total_steps=10)
        before = dict(LAUNCHES)
        parts[device] = {k: float(v) for k, v in
                         tr.train_step(tr.upload(tuples)).items()}
        delta = {k: LAUNCHES[k] - before[k] for k in before if LAUNCHES[k] != before[k]}
        check(delta == ({"warp2d": 10, "warp2d_bwd": 10} if device == "cuda" else {}),
              f"{device} step launches {delta}")
        if device == "cuda":
            PER_CALL["ifnet_2d_train_step"] = delta
        grads[device] = {n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()}
    for key, ref in parts["cpu"].items():
        err = abs(parts["cuda"][key] - ref)
        print(f"train step cuda vs cpu {key}: cuda={parts['cuda'][key]:.6e} cpu={ref:.6e} "
              f"tol={TRAIN_PARTS_TOL:g} rel")
        check(err <= TRAIN_PARTS_TOL * max(abs(ref), 1e-6), f"train step {key} disagrees")
    largest = max(float(g.abs().max()) for g in grads["cpu"].values())
    worst, where = max((float((grads["cuda"][n] - g).abs().max()), n)
                       for n, g in grads["cpu"].items())
    print(f"train step cuda vs cpu gradients: max_abs_diff={worst:.3e} at {where}, "
          f"largest gradient {largest:.3e}, ratio {worst / largest:.3e} tol={TRAIN_GRAD_TOL:g}")
    check(worst <= TRAIN_GRAD_TOL * largest, "train step gradients disagree with the CPU")


def phase_cli(torch, tmp: str):
    """generate → train (1 epoch) → test → inference_video, in process, on the card."""
    from opticalflowscivis_tpu_torch.cli.__main__ import main as cli
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES

    dirs = ["--data_dir", os.path.join(tmp, "cli_d"), "--results_dir", os.path.join(tmp, "cli_r"),
            "--log_dir", os.path.join(tmp, "cli_l")]
    before = dict(LAUNCHES)
    cli(["generate", "--dataset", "rectangle2d", "--frames", "99", "--data_dir", dirs[1]])
    cli(["train", "--dataset", "rectangle2d", "--epochs", "1", "--batch_size", "8",
         "--flow_supervised", *dirs])
    cli(["test", "--dataset", "rectangle2d", *dirs])
    cli(["inference_video", "--dataset", "rectangle2d", "--factors", "2,4", "--max_frames", "9",
         *dirs])
    torch.cuda.synchronize()
    run = os.path.join(tmp, "cli_r", "rectangle2d")
    with open(os.path.join(run, "2x", "flownet", "loss.json")) as f:
        final = json.load(f)["val_loss"][-1]
    with open(os.path.join(run, "2x", "flownet", "test_report.json")) as f:
        report = json.load(f)
    with open(os.path.join(run, "interp_report.json")) as f:
        interp = json.load(f)
    check(all(math.isfinite(v) for v in final), "cli train: loss.json not finite")
    check(set(report) == {"psnr", "ssim", "epe_ft1", "epe_ft0"}
          and all(math.isfinite(v) for v in report.values()), "cli test report")
    check(set(interp) == {"2", "4"} and all(math.isfinite(v) for row in interp.values()
                                            for v in row.values()), "cli interp report")
    check(os.path.isfile(os.path.join(tmp, "cli_l", "rectangle2d", "flownet.ckpt")),
          "cli checkpoint")
    delta = {k: LAUNCHES[k] - before[k] for k in ("warp2d", "warp2d_bwd")}
    print(f"cli: generate, train, test, inference_video ok; launches={delta}")
    check(all(v > 0 for v in delta.values()), "the CLI run missed a kernel")


def phase_train_times(torch, trainers):
    """Train steps per second, a profile of three steps, and the backward
    kernel alone against its plain version, its bound and ``F.grid_sample``."""
    b = TRAIN_SHAPE[0]
    times = {}
    for name, (tr, train) in trainers.items():
        batches = [tr.upload(train[i * b : (i + 1) * b]) for i in range(4)]

        def step(i, tr=tr, batches=batches):
            return tr.train_step(batches[i % 4])

        ms = cuda_ms(step, iters=10)
        times[f"train_step_ms_{name}"] = ms
        times[f"train_steps_per_sec_{name}"] = 1e3 / ms
        times[f"train_pairs_per_sec_{name}"] = b * 1e3 / ms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(10):
            step(i)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / 10
        times[f"train_steps_per_sec_host_clock_{name}"] = 1 / host
        times[f"train_pairs_per_sec_host_clock_{name}"] = b / host
        profile_forward(torch, f"train_{name}", step, unit="train_step")
    print("train times " + json.dumps(times))

    return times, warp2d_backward_times(torch)


def warp2d_backward_work(shape, size: int, flow_size: int, with_dimg: bool) -> tuple[int, int]:
    """Bytes and f32 operations of the 2-D backward at ``[B, H, W, C]``, image
    and g in elements of ``size`` bytes, flow and dflow of ``flow_size``:
    image, flow and g read once, dflow (and dimg, in the image's type) written
    once; clip, coordinates and 4 weights a pixel, and per channel the 4 taps'
    differences (and the 4 scattered products)."""
    b, h, w, c = shape
    px = b * h * w
    function_bytes = px * (2 * size * c + 4 * flow_size + (size * c if with_dimg else 0))
    flops = px * (30 + 16 * c + (8 * c if with_dimg else 0))
    return function_bytes, flops


def warp2d_backward_bound_ms(shape, size: int, flow_size: int,
                             with_dimg: bool) -> tuple[float, str]:
    """The 2-D backward's bound: its bytes over the HBM rate against its
    operations over the f32 rate, whichever is larger, and which it is."""
    function_bytes, flops = warp2d_backward_work(shape, size, flow_size, with_dimg)
    bytes_ms = function_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def host_us_per_call(torch, fn, iters: int = 40) -> float:
    """Microseconds of the host's time per call of ``fn(i)``: the loop's
    enqueue time, before the final synchronize."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    host = (time.perf_counter() - t0) * 1e6 / iters
    torch.cuda.synchronize()
    return host


def warp2d_backward_times(torch):
    """The backward kernel at the training path's shape, [64, 1, 128, 128]
    f32, border, r = 16, iid flows, without and with ``dimg``: alone, against
    autograd through its plain version and through ``F.grid_sample``, and its
    bound; then every case of ``warp2d_backward_cases``."""
    import torch.nn.functional as F

    from opticalflowscivis_tpu_torch.ops.kernels.warp import _launch_backward
    from opticalflowscivis_tpu_torch.ops.warp import warp2d_plain

    sets = [backward_inputs(torch, TRAIN_SHAPE, torch.float32, 300 + i, False) for i in range(4)]
    out = {}
    for with_dimg in (False, True):
        graphs = {"plain": [], "library": []}
        for img, flow4, g in sets:
            for kind in graphs:
                im = img.clone().requires_grad_(with_dimg)
                fl = flow4[:, 2:4].clone().requires_grad_(True)
                if kind == "plain":
                    res = warp2d_plain(im, fl, 16, "border")
                else:
                    res = F.grid_sample(im, clipped_grid2d(torch, fl, 16), mode="bilinear",
                                        padding_mode="border", align_corners=True)
                graphs[kind].append((res, (im, fl) if with_dimg else (fl,), g))

        def kernel(i):
            img, flow4, g = sets[i % 4]
            return _launch_backward(img, flow4[:, 2:4], g, 16, "border", with_dimg)

        def through(kind):
            def run(i):
                res, leaves, g = graphs[kind][i % 4]
                return torch.autograd.grad(res, leaves, g, retain_graph=True)
            return run

        tag = "with_dimg" if with_dimg else "dflow_only"
        # the design also zero-fills the f32 accumulator and reads it back
        # under the atomics, beyond the function's bytes
        function_bytes, flops = warp2d_backward_work(TRAIN_SHAPE, 4, 4, with_dimg)
        px, c = math.prod(TRAIN_SHAPE[:3]), TRAIN_SHAPE[3]
        design_bytes = function_bytes + (px * 8 * c if with_dimg else 0)
        bytes_ms = function_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        kernel_only = device_ms(kernel, 40, only="warp2d_bwd_kernel", launches=1)
        out[tag] = {
            "kernel_ms": kernel_only,
            "call_device_ms": device_ms(kernel, 40),  # with the zero-fill
            "plain_ms": device_ms(through("plain"), 20),
            **library_record(through("library")),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_bound_ms": bytes_ms, "operations_bound_ms": ops_ms,
            "design_bytes_ms": design_bytes / HBM_BYTES_PER_S * 1e3,
            "bytes": function_bytes,
            "achieved_GBps": function_bytes / (kernel_only / 1e3) / 1e9,
            "back_to_back_call_ms": cuda_ms(kernel, 40),
        }
    print("warp2d_bwd times " + json.dumps(out)
          + "  (bound: H100 SXM 3.35 TB/s, 67 TFLOP/s f32)")
    out.update(warp2d_backward_cases(torch))
    return out


def upflow_step_backward_calls(torch, bfloat16: bool) -> list:
    """The arguments ``(img, flow, g, r, padding, need_dimg)`` of each
    ``_launch_backward`` call of one UPFlow train step at full width
    (``upflow_config``, seed weights, batch 8 of ``upflow_pairs`` at 256 x
    832): the flows, features and gradients training hands the 2-D backward,
    in their own layouts."""
    from opticalflowscivis_tpu_torch.ops.kernels import warp as kernels_warp
    from opticalflowscivis_tpu_torch.training import UPFlowTrainer

    pairs, _ = upflow_pairs(UPFLOW_BATCH, UPFLOW_HW, seed=1)
    original = kernels_warp._launch_backward
    calls = []

    def record(*args):
        calls.append(tuple(a.detach() if hasattr(a, "detach") else a for a in args))
        return original(*args)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tr = UPFlowTrainer(upflow_config(tmp, "step_calls", bfloat16))
        tr.init_state()
        batch = tr._batch(tr.upload(pairs))
        try:
            kernels_warp._launch_backward = record
            tr.train_step(batch)
        finally:
            kernels_warp._launch_backward = original
        torch.cuda.synchronize()
    del tr
    check(len(calls) == 6 and sum(c[5] for c in calls) == 4,
          f"a UPFlow train step made {len(calls)} warp2d backward calls, expected 6 (4 dimg)")
    return calls


def warp2d_backward_cases(torch) -> dict:
    """The 2-D backward where training runs it, each case one call of
    ``_launch_backward`` on the layouts the ``warp2d layouts`` line shows:
    RIFE-2D's shape [64, 1, 128, 128], border, r = 16, on iid and smooth flows
    (``smooth_flow``, scale 10), the flow a slice of a 4-channel flow, in f32
    and in bf16 (the bf16 model's flow channels-last, also its NCHW form), and
    with ``dimg`` under zeros padding on smooth flows (the photometric term's
    warp of the prediction); UPFlow's photometric warp of the input frames,
    [8, 3, 256, 832] f32, border, r = 0, g channels-last; UPFlow's four
    feature levels (``UPFLOW_FEATURE_LEVELS``) with ``dimg``, zeros, r = 0, in
    f32 and with a bf16 image under a float32 flow, on smooth flows of scale
    min(10, H / 2); and the 6 calls of one UPFlow train step, f32 and bf16,
    on the inputs it hands the kernel (``upflow_step_backward_calls``).  Per
    case: the kernel's device time (median of 5 profiler
    windows of 40 calls over 4 input sets, the cases of one group in turns),
    the call's device time (with the zero-filled accumulator and the cast of
    ``dimg``), the host's µs per call, the bound, and autograd through
    ``F.grid_sample`` (``library_record``)."""
    import torch.nn.functional as F

    from opticalflowscivis_tpu_torch.ops.kernels.warp import _launch_backward

    f32, bf16 = torch.float32, torch.bfloat16
    rife = dict(shape=TRAIN_SHAPE, dt=f32, ft=f32, smooth=False, padding="border", r=16,
                dimg=False, flow="slice", g="nchw")
    upflow = dict(padding="zeros", r=0, dimg=True, smooth=True, flow="own", g="nchw")
    # the cases of a group, each a name and how it differs from the group's first
    groups = (
        {"iid": rife, "smooth": {**rife, "smooth": True},
         "bf16_iid": {**rife, "dt": bf16, "ft": bf16},
         "bf16_smooth": {**rife, "dt": bf16, "ft": bf16, "smooth": True},
         "bf16_nhwc_iid": {**rife, "dt": bf16, "ft": bf16, "flow": "slice_nhwc"},
         "bf16_nhwc_smooth": {**rife, "dt": bf16, "ft": bf16, "flow": "slice_nhwc",
                              "smooth": True},
         "smooth_zeros_dimg": {**rife, "smooth": True, "padding": "zeros", "dimg": True}},
        {"photo": {**rife, "shape": PHOTO_SHAPE, "smooth": True, "r": 0, "flow": "own",
                   "g": "nhwc"}},
        {f"upflow_{tag}_{name}": {**upflow, "shape": shape, "dt": dt, "ft": f32}
         for name, dt in (("f32", f32), ("bf16", bf16))
         for tag, shape in zip(("32", "16", "8", "4"), UPFLOW_FEATURE_LEVELS)},
    )
    cases = {}

    def time_group(members: dict) -> None:
        """Time the cases of one group in turns; ``members`` maps a name to
        (4 input sets (img, flow, g), r, padding, dimg, flows)."""
        fns, meta = {}, {}
        for name, (sets, r, padding, with_dimg, flows) in members.items():
            img, flow, g = sets[0]
            dt, ft = img.dtype, flow.dtype
            graphs = []
            for img, flow, g in sets:
                im = img.detach().clone().requires_grad_(with_dimg)
                fl = flow.detach().clone().requires_grad_(True)
                res = F.grid_sample(im, clipped_grid2d(torch, fl, r).to(dt), mode="bilinear",
                                    padding_mode=padding, align_corners=True)
                graphs.append((res, (im, fl) if with_dimg else (fl,), g))

            def run(i, sets=sets, r=r, padding=padding, with_dimg=with_dimg):
                img, flow, g = sets[i % 4]
                return _launch_backward(img, flow, g, r, padding, with_dimg)

            def library(i, graphs=graphs):
                res, leaves, g = graphs[i % 4]
                return torch.autograd.grad(res, leaves, g, retain_graph=True)

            fns[name] = run
            b, c, h, w = sets[0][0].shape
            bound, by = warp2d_backward_bound_ms((b, h, w, c), 2 if dt == bf16 else 4,
                                                 2 if ft == bf16 else 4, with_dimg)
            meta[name] = {
                "shape": [b, h, w, c], "dtype": str(dt).replace("torch.", ""),
                "flow_dtype": str(ft).replace("torch.", ""),
                "flows": flows, "padding": padding, "r": r,
                "dimg": with_dimg, "flow_strides": list(sets[0][1].stride()),
                "grad_strides": list(sets[0][2].stride()),
                "bound_ms": bound, "bound_by": by,
                "call_device_ms": device_ms(run, 40),
                "host_us_per_call": host_us_per_call(torch, run),
                **library_record(library),
            }
        timed = interleaved_device_ms(fns, only="warp2d_bwd_kernel", launches=1)
        for name, t in timed.items():
            cases[name] = {"kernel_ms": t["median_ms"], "windows_ms": t["windows_ms"],
                           **meta[name], "bound_share": meta[name]["bound_ms"] / t["median_ms"]}
        del fns
        torch.cuda.empty_cache()

    for group in groups:
        members = {}
        for k, (name, case) in enumerate(group.items()):
            shape, dt, ft = case["shape"], case["dt"], case["ft"]
            b, h, w, c = shape
            scale = 10.0 if case["r"] else min(10.0, h / 2)
            sets = []
            for i in range(4):
                seed = 1200 + 20 * k + i
                img, flow4, g = backward_inputs(torch, shape, dt, seed, case["g"] == "nhwc",
                                                scale=scale, flow_dtype=ft)
                if case["smooth"]:
                    flow4 = smooth_flow(torch, (b, 4, h, w), scale, seed).to(ft)
                if case["flow"] == "slice_nhwc":  # the bf16 model's channels-last flow
                    flow4 = flow4.contiguous(memory_format=torch.channels_last)
                flow = flow4[:, 2:4]
                if case["flow"] == "own":  # a flow of its own, [B, 2, H, W] contiguous
                    flow = flow.contiguous()
                sets.append((img, flow, g))
            members[name] = (sets, case["r"], case["padding"], case["dimg"],
                             "smooth" if case["smooth"] else "iid")
        time_group(members)
    # the flows, features and gradients of one UPFlow train step, as it hands them over
    for name, bfloat16 in (("f32", False), ("bf16", True)):
        members = {}
        for i, (img, flow, g, r, padding, with_dimg) in enumerate(
                upflow_step_backward_calls(torch, bfloat16)):
            _, c, h, w = img.shape
            members[f"step_{name}_{i}_{c}x{h}x{w}{'_dimg' if with_dimg else ''}"] = (
                [(img, flow, g)] * 4, r, padding, with_dimg, "upflow_step")
        time_group(members)
    print("warp2d_bwd cases " + json.dumps(cases)
          + "  (bound: H100 SXM 3.35 TB/s, 67 TFLOP/s f32)")
    return cases


# -- 3-D: the trilinear warp kernels, ifnet_3d serving and training ------------------


def warp3d_inputs(torch, shape, dtype, seed: int, channels_last: bool, off_integer=False):
    """Image ``[B, C, Z, Y, X]``, a 6-channel flow (the warp takes its last three
    channels, as the model passes them) and an incoming gradient; flow and
    gradient contiguous or in the channels-last-3d layout cuDNN may produce.
    N(0, 6) flows, some beyond ±8; ``off_integer`` keeps them off the kinks of
    the trilinear weights."""
    b, z, y, x, c = shape
    fmt = torch.channels_last_3d if channels_last else torch.contiguous_format
    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand((b, c, z, y, x), generator=gen, device="cuda").to(dtype)
    flow6 = torch.randn((b, 6, z, y, x), generator=gen, device="cuda") * 6.0
    if off_integer:
        flow6 = torch.round(flow6 * 4) / 4 + 0.11
    flow6 = flow6.to(dtype).contiguous(memory_format=fmt)
    g = torch.randn((b, c, z, y, x), generator=gen, device="cuda").to(dtype)
    return img, flow6, g.contiguous(memory_format=fmt)


def phase_warp3d_vs_plain(torch):
    """``warp3d`` and ``warp3d_bwd`` against ``warp3d_plain`` and autograd through it."""
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
    from opticalflowscivis_tpu_torch.ops.kernels.warp import warp3d
    from opticalflowscivis_tpu_torch.ops.warp import warp3d_plain

    def grads(fn, img, flow6, g, radii, padding, img_grad):
        im = img.detach().clone().requires_grad_(img_grad)
        fl = flow6.detach().clone(memory_format=torch.preserve_format).requires_grad_(True)
        fn(im, fl[:, 3:], *radii, padding).backward(g)
        return im.grad, fl.grad[:, 3:]

    worst = {"fwd": 0.0, "bwd": 0.0}
    seed = 400
    for shape in (VOLUME_SHAPE, (2, 11, 13, 17, 3)):
        cl = shape[-1] > 1  # the small shape: channels-last-3d flow and gradient
        for padding in ("border", "zeros"):
            for radii in RADII_3D:
                for dtype in (torch.float32, torch.bfloat16):
                    seed += 1
                    name = str(dtype).replace("torch.", "")
                    tag = (f"{list(shape)} {padding:6s} r={radii} {name:8s} "
                           f"{'ndhwc' if cl else 'ncdhw'}")
                    # forward
                    img, flow6, _ = warp3d_inputs(torch, shape, dtype, seed, cl)
                    flow = flow6[:, 3:]
                    check(bool((flow.float().abs() > 8).any()), "no flow beyond ±8")
                    before = dict(LAUNCHES)
                    out = warp3d(img, flow, *radii, padding)
                    torch.cuda.synchronize()
                    ref = warp3d_plain(img, flow, *radii, padding)
                    check(LAUNCHES["warp3d"] == before["warp3d"] + 1
                          and LAUNCHES["warp3d_bwd"] == before["warp3d_bwd"],
                          "forward launch count")
                    check(out.dtype == dtype and out.shape == ref.shape, "kernel output type")
                    diff = (out.float() - ref.float()).abs()
                    err = float(diff.max())
                    if dtype == torch.float32:
                        ok, tol = err <= F32_TOL, f"{F32_TOL:g}"
                        worst["fwd"] = max(worst["fwd"], err)
                    else:
                        ok, tol = bool((diff <= bf16_ulp(ref.float())).all()), "1 bf16 ulp"
                    print(f"warp3d {tag} max_abs_err={err:.3e} tol={tol} {'ok' if ok else 'FAIL'}")
                    check(ok, f"warp3d kernel disagrees with plain ({tag})")
                    # backward, with an image gradient and (the big shape) without
                    for img_grad in ([True] if cl else [True, False]):
                        img, flow6, g = warp3d_inputs(torch, shape, dtype, seed + 1000, cl,
                                                      off_integer=True)
                        before = dict(LAUNCHES)
                        dimg, dflow = grads(warp3d, img, flow6, g, radii, padding, img_grad)
                        torch.cuda.synchronize()
                        check(LAUNCHES["warp3d"] == before["warp3d"] + 1
                              and LAUNCHES["warp3d_bwd"] == before["warp3d_bwd"] + 1,
                              "backward launch count")
                        dimg_ref, dflow_ref = grads(warp3d_plain, img, flow6, g, radii, padding,
                                                    img_grad)
                        check(LAUNCHES["warp3d_bwd"] == before["warp3d_bwd"] + 1,
                              "the plain version launched")
                        rel = BWD_F32_TOL if dtype == torch.float32 else BWD_BF16_TOL
                        pairs = [("dflow", dflow, dflow_ref)]
                        if img_grad:
                            pairs.append(("dimg", dimg, dimg_ref))
                        else:
                            check(dimg is None, "an image gradient nobody asked for")
                        ok, shown = True, []
                        for what, got, want in pairs:
                            check(got.dtype == dtype and got.shape == want.shape, f"{what} type")
                            err = float((got.float() - want.float()).abs().max())
                            scale = float(want.float().abs().max())
                            ok = ok and err <= rel * scale
                            shown.append(f"{what}_err={err:.3e} (max|ref|={scale:.3e})")
                            if dtype == torch.float32:
                                worst["bwd"] = max(worst["bwd"], err)
                        fl = flow6[:, 3:].float()
                        for comp, r in ((slice(0, 1), radii[0]), (slice(1, 3), radii[1])):
                            if r:  # exactly 0 at and beyond the bound
                                clamped = fl[:, comp].abs() >= r
                                ok = ok and bool((dflow[:, comp][clamped] == 0).all())
                        print(f"warp3d_bwd {tag} img_grad={int(img_grad)} {' '.join(shown)} "
                              f"tol={rel:g}*max|ref| {'ok' if ok else 'FAIL'}")
                        check(ok, f"warp3d backward disagrees with plain ({tag}, "
                                  f"img_grad={img_grad})")
    # the forward's element paths: ragged rows (X = 1, 5, 13, 62) and single
    # rows, contiguous and channels-last-3d flows; then planes (B * Z) and rows
    # beyond the grid's 65535 limit
    from opticalflowscivis_tpu_torch.ops.kernels.warp import launch_geometry

    for dtype in (torch.float32, torch.bfloat16):
        err = 0.0
        for shape in ((2, 6, 7, 1, 1), (1, 5, 3, 5, 2), (2, 4, 1, 13, 3), (1, 9, 10, 62, 1)):
            for cl in (False, True):
                seed += 1
                img, flow6, _ = warp3d_inputs(torch, shape, dtype, seed, cl)
                for padding in ("border", "zeros"):
                    for radii in RADII_3D:
                        out = warp3d(img, flow6[:, 3:], *radii, padding)
                        ref = warp3d_plain(img, flow6[:, 3:], *radii, padding)
                        diff = (out.float() - ref.float()).abs()
                        ok = (float(diff.max()) <= F32_TOL if dtype == torch.float32
                              else bool((diff <= bf16_ulp(ref.float())).all()))
                        check(ok, f"warp3d disagrees with plain ({shape}, ndhwc={cl}, {padding}, "
                                  f"{radii}, {dtype})")
                        err = max(err, float(diff.max()))
        if dtype == torch.float32:
            worst["fwd"] = max(worst["fwd"], err)
        print(f"warp3d ragged rows {str(dtype).replace('torch.', '')}: 4 shapes x ncdhw / ndhwc "
              f"x both paddings x radii {RADII_3D} max_abs_err={err:.3e} ok")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for shape in ((2, 1, 40000, 2, 3), (1, 1, 1, 65535 * 256 + 1, 1)):
        check(launch_geometry(shape).strided, f"{shape} takes no grid-stride loop")
        img = torch.rand(shape, generator=gen, device="cuda")
        flow = torch.randn((shape[0], 3) + shape[2:], generator=gen, device="cuda") * 3
        for padding in ("border", "zeros"):
            err = float((warp3d(img, flow, 8, 8, padding)
                         - warp3d_plain(img, flow, 8, 8, padding)).abs().max())
            print(f"warp3d grid-stride {list(shape)} {padding:6s} r=(8, 8) float32 "
                  f"grid={launch_geometry(shape).grid} max_abs_err={err:.3e} tol={F32_TOL:g}")
            check(err <= F32_TOL, f"warp3d's grid-stride loop disagrees with plain ({shape})")
            worst["fwd"] = max(worst["fwd"], err)

    def backward_case(img, flow6, g, radii, padding, img_grad):
        """Relative error of one backward launch against autograd through
        the plain version; raises where ``dflow`` is not exactly 0 at and
        beyond a radius."""
        before = LAUNCHES["warp3d_bwd"]
        got = grads(warp3d, img, flow6, g, radii, padding, img_grad)
        torch.cuda.synchronize()
        check(LAUNCHES["warp3d_bwd"] == before + 1, "backward launch count")
        want = grads(warp3d_plain, img, flow6, g, radii, padding, img_grad)
        errs = []
        for what, a, ref in zip(("dimg", "dflow"), got, want):
            if ref is None:
                check(a is None, "an image gradient nobody asked for")
                continue
            check(a.dtype == img.dtype and a.shape == ref.shape, f"{what} type")
            err = float((a.float() - ref.float()).abs().max())
            errs.append((err, float(ref.float().abs().max())))
        fl = flow6[:, 3:].float()
        for comp, r in ((slice(0, 1), radii[0]), (slice(1, 3), radii[1])):
            if r:
                check(bool((got[1][:, comp][fl[:, comp].abs() >= r] == 0).all()),
                      f"dflow not 0 at and beyond r={r}")
        return errs

    # the backward's element paths: the same ragged rows, flow and incoming
    # gradient contiguous or channels-last-3d, with and without dimg; then its
    # grid-stride loops on the same two shapes
    for dtype in (torch.float32, torch.bfloat16):
        rel = BWD_F32_TOL if dtype == torch.float32 else BWD_BF16_TOL
        ratio = 0.0
        for shape in ((2, 6, 7, 1, 1), (1, 5, 3, 5, 2), (2, 4, 1, 13, 3), (1, 9, 10, 62, 1)):
            for cl in (False, True):
                seed += 1
                img, flow6, g = warp3d_inputs(torch, shape, dtype, seed, cl, off_integer=True)
                for padding in ("border", "zeros"):
                    for radii in RADII_3D:
                        for img_grad in (False, True):
                            for err, scale in backward_case(img, flow6, g, radii, padding,
                                                            img_grad):
                                check(err <= rel * scale,
                                      f"warp3d backward disagrees with plain ({shape}, "
                                      f"ndhwc={cl}, {padding}, {radii}, {dtype}, {img_grad})")
                                ratio = max(ratio, err / max(scale, 1e-30))
                                if dtype == torch.float32:
                                    worst["bwd"] = max(worst["bwd"], err)
        print(f"warp3d_bwd ragged rows {str(dtype).replace('torch.', '')}: 4 shapes x ncdhw / "
              f"ndhwc x both paddings x radii {RADII_3D} x dimg or not: worst err/max|ref| "
              f"{ratio:.3e} tol={rel:g} ok")
    for shape in ((2, 1, 40000, 2, 3), (1, 1, 1, 65535 * 256 + 1, 1)):
        b, _, z, y, x = shape
        img = torch.rand(shape, generator=gen, device="cuda")
        flow6 = torch.randn((b, 6, z, y, x), generator=gen, device="cuda") * 3
        g = torch.randn(shape, generator=gen, device="cuda")
        for padding in ("border", "zeros"):
            for img_grad in (False, True):
                errs = backward_case(img, flow6, g, (8, 8), padding, img_grad)
                print(f"warp3d_bwd grid-stride {list(shape)} {padding:6s} r=(8, 8) float32 "
                      f"img_grad={int(img_grad)} grid={launch_geometry(shape).grid} "
                      + " ".join(f"err={e:.3e} (max|ref|={m:.3e})" for e, m in errs)
                      + f" tol={BWD_F32_TOL:g}*max|ref|")
                check(all(e <= BWD_F32_TOL * m for e, m in errs),
                      f"warp3d_bwd's grid-stride loop disagrees with plain ({shape})")
                worst["bwd"] = max([worst["bwd"]] + [e for e, _ in errs])
    # dflow is written once per voxel with no atomics: two runs at the model's
    # shape agree bit for bit, on a contiguous and on a channels-last-3d flow slice
    from opticalflowscivis_tpu_torch.ops.kernels.warp import _launch3d_backward

    for dtype in (torch.float32, torch.bfloat16):
        for cl in (False, True):
            seed += 1
            img, flow6, g = warp3d_inputs(torch, VOLUME_SHAPE, dtype, seed, cl)
            runs = [_launch3d_backward(img, flow6[:, 3:], g, *RADII_3D[0], "border", False)[1]
                    for _ in range(2)]
            same = torch.equal(runs[0], runs[1])
            print(f"warp3d_bwd repeat {list(VOLUME_SHAPE)} {str(dtype).replace('torch.', '')} "
                  f"{'ndhwc' if cl else 'ncdhw'}: two dflow-only runs bit-equal={same}")
            check(same and bool(runs[0].abs().sum() > 0),
                  "two dflow-only runs of warp3d_bwd differ")
    return worst


def phase_serving3d(torch):
    """``ifnet_3d`` at full width through ``Interpolator`` on 64^3 volumes."""
    from opticalflowscivis_tpu_torch.data import rectangle_3d
    from opticalflowscivis_tpu_torch.evalsuite import (
        calculate_metrics,
        linear_interpolation_baseline,
    )
    from opticalflowscivis_tpu_torch.inference import Interpolator, interpolate_series
    from opticalflowscivis_tpu_torch.models import ifnet_3d
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    b, z, y, x, c = VOLUME_SHAPE
    model32 = ifnet_3d(device="cuda", seed=0)
    model16 = ifnet_3d(dtype=torch.bfloat16, device="cuda", seed=0)
    interp32, interp16 = Interpolator(model32), Interpolator(model16)
    interp_tta = Interpolator(model32, tta=True)
    rng = np.random.default_rng(0)
    a = rng.random(VOLUME_SHAPE, dtype=np.float32)
    e = rng.random(VOLUME_SHAPE, dtype=np.float32)
    series = rectangle_3d(n_frames=9, grid=(z, y, x), seed=0, with_flow=False)

    def launches_of(fn):
        before = dict(LAUNCHES)
        res = fn()
        torch.cuda.synchronize()
        check(all(LAUNCHES[k] == before[k] for k in before if k != "warp3d"),
              "a 3-D forward launched another kernel than warp3d")
        return res, LAUNCHES["warp3d"] - before["warp3d"]

    reset_launches()  # the 3-D serving path's run starts here
    outs = {}
    for name, interp in (("f32", interp32), ("bf16", interp16)):
        (merged, flow, mask), n = launches_of(lambda: interp.pair(a, e))
        print(f"pair3d {name} {list(VOLUME_SHAPE)}: warp3d launches={n}")
        check(n == 6, f"{name} 3-D forward launched warp3d {n} times, expected 6")
        PER_CALL["ifnet_3d_forward"] = {"warp3d": n}
        check(merged.shape == VOLUME_SHAPE and flow.shape == (b, z, y, x, 6)
              and mask.shape == VOLUME_SHAPE, f"{name} 3-D output shapes")
        check(all(np.isfinite(v).all() for v in (merged, flow, mask)), f"{name} 3-D not finite")
        outs[name] = merged
    _, n = launches_of(lambda: interp_tta.pair(a[:1], e[:1]))
    print(f"pair3d tta [1,{z},{y},{x},{c}]: warp3d launches={n}")
    check(n == 12, f"3-D TTA forward launched warp3d {n} times, expected 12")
    print(f"merged3d bf16 vs f32 max_abs_diff={np.abs(outs['bf16'] - outs['f32']).max():.3e}")

    # the same weights on the CPU (the plain path) at batch 1
    cpu_model = ifnet_3d(device="cpu", seed=0)
    cpu_model.load_state_dict(model32.state_dict())
    cpu = Interpolator(cpu_model, device="cpu").pair(a[:1], e[:1])
    gpu, n = launches_of(lambda: interp32.pair(a[:1], e[:1]))
    check(n == 6, "batch-1 3-D forward launches")
    for name, got, want in zip(("merged", "flow", "mask"), gpu, cpu):
        err = float(np.abs(got - want).max())
        tol = CPU_TOL * max(1.0, float(np.abs(want).max()))
        print(f"cuda vs cpu 3-D {name}: max_abs_err={err:.3e} tol={tol:.3e} "
              f"max|cpu|={np.abs(want).max():.3e}")
        check(err <= tol, f"cuda 3-D {name} disagrees with the CPU plain path")

    for factor in (2, 4):
        (recon, _), n = launches_of(lambda: interpolate_series(interp32, series, factor))
        k = recon.shape[0]
        psnr, ssim_v = calculate_metrics(series[:k, ..., 0] * 255.0, recon[..., 0] * 255.0, factor)
        base = linear_interpolation_baseline(series[:k], factor)
        psnr_b, ssim_b = calculate_metrics(series[:k, ..., 0] * 255.0, base[..., 0] * 255.0, factor)
        vals = {"factor": factor, "volumes": k, "warp3d_launches": n, "psnr": psnr,
                "ssim": ssim_v, "psnr_linear_baseline": psnr_b, "ssim_linear_baseline": ssim_b}
        print("series3d " + json.dumps(vals))
        check(recon.shape == (9, z, y, x, 1) and np.isfinite(recon).all(), "3-D series output")
        check(all(math.isfinite(v) for v in (psnr, ssim_v, psnr_b, ssim_b)), "3-D series metrics")
        check(n == 6 * int(math.log2(factor)), f"3-D series x{factor} launches {n}")
    torch.cuda.synchronize()
    total = LAUNCHES["warp3d"]  # read just after the 3-D serving path's run
    print(f"3-D serving path: warp3d launches={total}")
    check(total > 0, "the 3-D serving path never launched warp3d")
    return total, (interp32, interp16)


def train3d_config(tmp: str, bfloat16: bool, batch: int = 4, **model_kw):
    """``ModelConfig.preset_3d()`` at full width with ``RIFELossWeights.preset_3d()``
    on ``rectangle3d``; the warm-up is cut from 2000 steps to 10 so that a few
    dozen steps move the loss."""
    from opticalflowscivis_tpu_torch.losses import RIFELossWeights
    from opticalflowscivis_tpu_torch.training import ModelConfig, OptimConfig, TrainConfig

    name = "bf16" if bfloat16 else "f32"
    return TrainConfig(
        dataset="rectangle3d", batch_size=batch,
        model=ModelConfig.preset_3d(bfloat16=bfloat16, **model_kw),
        loss=RIFELossWeights.preset_3d(),
        optim=OptimConfig(warmup_steps=10),
        data_dir=os.path.join(tmp, "data3d"), log_dir=os.path.join(tmp, f"log3d_{name}"),
        results_dir=os.path.join(tmp, f"res3d_{name}"),
    )


def phase_training3d(torch, tmp: str):
    """``Trainer.fit`` at full width on 64^3 ``rectangle_3d`` tuples, f32 and bf16.

    The loss is read on the first training tuples themselves: an untrained
    IFNet already returns the linear blend of its inputs, and on held-out
    tuples the unsupervised 3-D recipe needs far more than a few dozen steps
    to beat that, while on the tuples it trains on ``loss_G`` falls at once."""
    from opticalflowscivis_tpu_torch.data import group_tuples, rectangle_3d
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from opticalflowscivis_tpu_torch.training import Trainer

    b, z, y, x, _ = VOLUME_SHAPE
    epochs, steps_per_epoch = 16, 2
    frames = rectangle_3d(n_frames=3 * steps_per_epoch * b, grid=(z, y, x), seed=0)
    train = group_tuples(frames, 1).astype(np.float32)
    val = train[:b]
    check(train.shape == (steps_per_epoch * b, 3, z, y, x, 4), "3-D tuples")

    launches = {"warp3d": 0, "warp3d_bwd": 0}
    trainers = {}
    for bfloat16 in (False, True):
        name = "bf16" if bfloat16 else "f32"
        cfg = train3d_config(tmp, bfloat16)
        tr = Trainer(cfg)
        reset_launches()  # the 3-D training path's run starts here
        hist = tr.fit(train, val, epochs=epochs, log_every=0)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)  # read just after the run
        steps, evals = epochs * steps_per_epoch, epochs  # one val chunk per epoch
        print(f"fit3d {name}: {steps} train steps + {evals} eval steps at {list(VOLUME_SHAPE)}: "
              f"launches={counts} loss_G first eval {hist[0]['loss_G']:.6f} "
              f"last {hist[-1]['loss_G']:.6f}")
        check(len(hist) == epochs and tr.state.step == steps, f"{name} 3-D fit length")
        check(all(math.isfinite(v) for parts in hist for v in parts.values()),
              f"{name} 3-D losses not finite")
        check(hist[-1]["loss_G"] < hist[0]["loss_G"], f"{name} 3-D fit did not lower loss_G")
        check(counts["warp3d"] == 8 * (steps + evals),
              f"{name}: {counts['warp3d']} warp3d launches, expected 8 per train and eval step")
        check(counts["warp3d_bwd"] == 8 * steps,
              f"{name}: {counts['warp3d_bwd']} warp3d_bwd launches, expected 8 per train step")
        check(counts["warp2d"] == 0 and counts["warp2d_bwd"] == 0,
              "3-D training launched a 2-D kernel")
        for key in launches:
            launches[key] += counts[key]

        with open(os.path.join(tr.results_dir, "loss.json")) as f:
            rows = json.load(f)["val_loss"]
        check(len(rows) == epochs and all(len(row) == 7 for row in rows), f"{name} 3-D loss.json")
        check(os.path.isfile(tr.checkpoint_path()), f"{name} 3-D checkpoint not written")
        fresh = Trainer(cfg)
        fresh.init_state(total_steps=steps)
        check(fresh.load_checkpoint() and fresh.state.step == steps, f"{name} 3-D checkpoint load")
        restored = fresh.model.state_dict()
        check(all(torch.equal(v, restored[k]) for k, v in tr.model.state_dict().items()),
              f"{name}: restored 3-D weights differ")

        def rel_diff(p, q):
            return max(abs(p[k] - q[k]) / max(abs(p[k]), 1e-12) for k in p)

        with deterministic_cudnn(torch):
            ours = tr.evaluate(val, b)
            again = rel_diff(ours, tr.evaluate(val, b))
            theirs = rel_diff(ours, fresh.evaluate(val, b))
        tol = 1e-6 if not bfloat16 else 1e-3  # as in 2-D
        print(f"checkpoint3d {name}: restored step {fresh.state.step}, weights equal, evaluate "
              f"rel diff {theirs:.3e} (same trainer twice: {again:.3e}) tol={tol:g}")
        check(theirs <= tol, f"{name}: the restored 3-D trainer evaluates differently")
        trainers[name] = (tr, train)
    print(f"3-D training path: launches={launches}")
    check(all(v > 0 for v in launches.values()), "the 3-D training path missed a kernel")
    warp3d_layouts(torch, trainers)
    return launches, trainers


def warp3d_layouts(torch, trainers) -> dict:
    """One ``warp3d layouts`` line: the shape, dtype and strides of the flow
    and the incoming gradient that each backward call of one f32 and one bf16
    train step hands ``_launch3d_backward``, whether it asks for ``dimg``, and
    which path the kernel's rows take: "vector" where the tensor is
    contiguous in x and each row's pair of voxels is aligned, else
    "element"."""
    from opticalflowscivis_tpu_torch.ops.kernels import warp as kernels_warp

    original = kernels_warp._launch3d_backward
    seen = {}

    def rows(t):
        aligned = t.data_ptr() % (2 * t.element_size()) == 0
        even = all(st % 2 == 0 for st in t.stride()[:-1]) and t.shape[-1] % 2 == 0
        return "vector" if t.stride(-1) == 1 and aligned and even else "element"

    def record(img, flow, grad_out, r_z, r_yx, padding, need_dimg):
        seen[name].append({
            "shape": list(img.shape), "dtype": str(img.dtype).replace("torch.", ""),
            "flow_strides": list(flow.stride()), "grad_strides": list(grad_out.stride()),
            "rows": [rows(flow), rows(grad_out)], "need_dimg": bool(need_dimg),
            "radii": [r_z, r_yx], "padding": padding})
        return original(img, flow, grad_out, r_z, r_yx, padding, need_dimg)

    b = VOLUME_SHAPE[0]
    try:
        kernels_warp._launch3d_backward = record
        for name, (tr, train) in trainers.items():
            seen[name] = []
            tr.train_step(tr.upload(train[:b]))
    finally:
        kernels_warp._launch3d_backward = original
    torch.cuda.synchronize()
    print("warp3d layouts " + json.dumps(seen))
    check(all(len(v) == 8 for v in seen.values()), f"expected 8 backward calls a step: {seen}")
    return seen


def textured_volume_tuples(n_tuples: int, grid, seed: int):
    """``rectangle_3d`` tuples on a random texture: every voxel carries signal,
    so that gradients are not float32 rounding of exact zeros."""
    from opticalflowscivis_tpu_torch.data import group_tuples, rectangle_3d

    tuples = group_tuples(rectangle_3d(n_frames=3 * n_tuples, grid=grid, seed=seed), 1)
    tuples = tuples.astype(np.float32)
    tuples[..., 0] += np.random.default_rng(seed).uniform(0.05, 0.3, tuples.shape[:-1]).astype(
        np.float32)
    return tuples


def phase_train3d_step_checks(torch, tmp: str):
    """One 3-D train step from the same weights: ``remat`` against the plain
    step on the card (batch 4), and the card against the CPU (batch 1)."""
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
    from opticalflowscivis_tpu_torch.training import Trainer

    grid = VOLUME_SHAPE[1:4]

    def one_step(cfg, device, tuples):
        tr = Trainer(cfg, device=device)
        tr.init_state(total_steps=10)
        before = dict(LAUNCHES)
        parts = {k: float(v) for k, v in tr.train_step(tr.upload(tuples)).items()}
        if device == "cuda":
            torch.cuda.synchronize()
        delta = {k: LAUNCHES[k] - before[k] for k in before if LAUNCHES[k] != before[k]}
        grads = {n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()}
        return parts, grads, delta

    def compare(tag, got, want, parts_tol, grad_tol):
        for key, ref in want[0].items():
            print(f"train3d step {tag} {key}: {got[0][key]:.6e} vs {ref:.6e} tol={parts_tol:g} rel")
            check(abs(got[0][key] - ref) <= parts_tol * max(abs(ref), 1e-6),
                  f"3-D train step {tag}: {key} disagrees")
        largest = max(float(g.abs().max()) for g in want[1].values())
        worst, where = max((float((got[1][n] - g).abs().max()), n) for n, g in want[1].items())
        print(f"train3d step {tag} gradients: max_abs_diff={worst:.3e} at {where}, largest "
              f"gradient {largest:.3e}, ratio {worst / largest:.3e} tol={grad_tol:g}")
        check(worst <= grad_tol * largest, f"3-D train step {tag}: gradients disagree")

    expected = {"warp3d": 8, "warp3d_bwd": 8}
    tuples4 = textured_volume_tuples(VOLUME_SHAPE[0], grid, seed=1)
    plain = one_step(train3d_config(tmp, False), "cuda", tuples4)
    remat = one_step(train3d_config(tmp, False, remat=True), "cuda", tuples4)
    print(f"train3d step launches: plain {plain[2]} remat {remat[2]}")
    check(plain[2] == expected, f"3-D train step launches {plain[2]}")
    PER_CALL["ifnet_3d_train_step"] = plain[2]
    # the warps lie outside the recomputed blocks: remat reruns none of them
    check(remat[2] == expected, f"3-D train step launches with remat {remat[2]}")
    # the same arithmetic, but cuDNN may pick other algorithms for the recomputation
    compare("remat vs plain", remat, plain, 1e-5, 1e-3)

    cfg1 = train3d_config(tmp, False, batch=1)
    tuples1 = tuples4[:1]
    cuda, cpu = one_step(cfg1, "cuda", tuples1), one_step(cfg1, "cpu", tuples1)
    check(cuda[2] == expected and cpu[2] == {}, f"step launches cuda {cuda[2]} cpu {cpu[2]}")
    compare("cuda vs cpu", cuda, cpu, TRAIN_PARTS_TOL, TRAIN_GRAD_TOL)


def phase_cli3d(torch, tmp: str):
    """generate → train (1 epoch) → test → inference_video on ``rectangle3d``, in
    process, on the card, at the full width the flags build; then the
    ``train256`` module at 128^3 as its own process."""
    from opticalflowscivis_tpu_torch.cli.__main__ import main as cli
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES

    dirs = ["--data_dir", os.path.join(tmp, "cli3_d"), "--results_dir", os.path.join(tmp, "cli3_r"),
            "--log_dir", os.path.join(tmp, "cli3_l")]
    before = dict(LAUNCHES)
    cli(["generate", "--dataset", "rectangle3d", "--frames", "60", "--data_dir", dirs[1]])
    cli(["train", "--dataset", "rectangle3d", "--epochs", "1", "--batch_size", "4", *dirs])
    cli(["test", "--dataset", "rectangle3d", "--batch_size", "4", *dirs])
    cli(["inference_video", "--dataset", "rectangle3d", "--factors", "2,4", "--max_frames", "9",
         *dirs])
    torch.cuda.synchronize()
    run = os.path.join(tmp, "cli3_r", "rectangle3d")
    with open(os.path.join(run, "2x", "flownet", "loss.json")) as f:
        final = json.load(f)["val_loss"][-1]
    with open(os.path.join(run, "2x", "flownet", "test_report.json")) as f:
        report = json.load(f)
    with open(os.path.join(run, "interp_report.json")) as f:
        interp = json.load(f)
    check(all(math.isfinite(v) for v in final), "3-D cli train: loss.json not finite")
    check(set(report) == {"psnr", "ssim", "epe_ft1", "epe_ft0"}
          and all(math.isfinite(v) for v in report.values()), "3-D cli test report")
    check(set(interp) == {"2", "4"} and all(math.isfinite(v) for row in interp.values()
                                            for v in row.values()), "3-D cli interp report")
    check(os.path.isfile(os.path.join(tmp, "cli3_l", "rectangle3d", "flownet.ckpt")),
          "3-D cli checkpoint")
    delta = {k: LAUNCHES[k] - before[k] for k in before}
    print(f"cli3d: generate, train, test, inference_video ok; launches={delta}")
    check(delta["warp3d"] > 0 and delta["warp3d_bwd"] > 0 and delta["warp2d"] == 0,
          "the 3-D CLI run missed a kernel")

    out = os.path.join(tmp, "t256")
    cmd = [sys.executable, "-m", "opticalflowscivis_tpu_torch.scripts.train256", "--grid", "128",
           "--frames", "5", "--epochs", "1", "--coarse_final", "--out", out]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"train256 exited {res.returncode}:\n{res.stderr[-2000:]}")
    report = json.loads(res.stdout.strip().splitlines()[-1])
    print("train256 " + json.dumps(report))
    check(report["grid"] == 128 and report["steps"] == 4 and report["coarse_final"]
          and report["device"].startswith("cuda"), "train256 report")
    check(all(math.isfinite(report[k]) for k in ("seconds_per_step", "train_step_seconds",
                                                 "val_loss_final", "val_psnr_model"))
          and report["cuda_peak_bytes"] > 0, "train256 numbers")


def phase_times3d(torch, interps, trainers):
    """Times of the 3-D paths and of the two 3-D kernels at the paths' shape."""
    b, z, y, x, c = VOLUME_SHAPE
    times = {}
    for name, interp in zip(("f32", "bf16"), interps):
        sets = []
        for i in range(4):
            g = torch.Generator(device="cuda").manual_seed(500 + i)
            sets.append((torch.rand((b, c, z, y, x), generator=g, device="cuda"),
                         torch.rand((b, c, z, y, x), generator=g, device="cuda")))
        ms = cuda_ms(lambda i: interp.forward(*sets[i % 4]), iters=10)
        times[f"forward3d_ms_{name}"] = ms
        times[f"volume_pairs_per_sec_{name}"] = b / (ms / 1e3)
        profile_forward(torch, f"3d_{name}", lambda i: interp.forward(*sets[i % 4]))
    for name, (tr, train) in trainers.items():
        batches = [tr.upload(train[i * b : (i + 1) * b]) for i in range(train.shape[0] // b)]

        def step(i, tr=tr, batches=batches):
            return tr.train_step(batches[i % len(batches)])

        ms = cuda_ms(step, iters=8)
        times[f"train3d_step_ms_{name}"] = ms
        times[f"train3d_volumes_per_sec_{name}"] = b * 1e3 / ms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(8):
            step(i)
        torch.cuda.synchronize()
        times[f"train3d_volumes_per_sec_host_clock_{name}"] = 8 * b / (time.perf_counter() - t0)
        profile_forward(torch, f"train3d_{name}", step, unit="train_step")
    print("times3d " + json.dumps(times))

    return (times, *warp3d_times(torch))


def warp3d_times(torch):
    """The two 3-D kernels at the paths' shape, [4, 1, 64, 64, 64] f32, border,
    radii (8, 8), flow a 3-channel slice: the forward against ``F.grid_sample``
    in turns on iid and smooth flows, the backward without and with ``dimg``
    alone and against autograd through the plain version and the library
    call; both against their plain versions and bounds."""
    import torch.nn.functional as F

    from opticalflowscivis_tpu_torch.ops.kernels.warp import _launch3d_backward, warp3d
    from opticalflowscivis_tpu_torch.ops.warp import warp3d_plain

    b, z, y, x, c = VOLUME_SHAPE
    r_z, r_yx = RADII_3D[0]
    sets = [warp3d_inputs(torch, VOLUME_SHAPE, torch.float32, 600 + i, False, off_integer=True)
            for i in range(4)]

    def clipped_grid(flow):
        """``F.grid_sample``'s (x, y, z) grid in [-1, 1] for a (dz, dy, dx) flow."""
        fz = torch.where(flow[:, 0].abs() < r_z, flow[:, 0], torch.sign(flow[:, 0].detach()) * r_z)
        fyx = torch.where(flow[:, 1:].abs() < r_yx, flow[:, 1:],
                          torch.sign(flow[:, 1:].detach()) * r_yx)
        zs = torch.arange(z, device="cuda", dtype=torch.float32).view(1, z, 1, 1)
        ys = torch.arange(y, device="cuda", dtype=torch.float32).view(1, 1, y, 1)
        xs = torch.arange(x, device="cuda", dtype=torch.float32).view(1, 1, 1, x)
        gz = 2.0 * (zs + fz) / (z - 1) - 1.0
        gy = 2.0 * (ys + fyx[:, 0]) / (y - 1) - 1.0
        gx = 2.0 * (xs + fyx[:, 1]) / (x - 1) - 1.0
        return torch.stack([gx, gy, gz], dim=-1)

    def library_forward(img, flow):
        return F.grid_sample(img, clipped_grid(flow), mode="bilinear", padding_mode="border",
                             align_corners=True)

    grids = [(img, clipped_grid(flow6[:, 3:])) for img, flow6, _ in sets]
    # the library call is held against the kernel once: it is the same function
    lib_err = float((library_forward(sets[0][0], sets[0][1][:, 3:])
                     - warp3d(sets[0][0], sets[0][1][:, 3:], r_z, r_yx, "border")).abs().max())
    check(lib_err <= 1e-4, f"F.grid_sample is not the same function ({lib_err:.3e})")

    def kernel(i):
        return warp3d(sets[i % 4][0], sets[i % 4][1][:, 3:], r_z, r_yx, "border")

    def plain(i):
        return warp3d_plain(sets[i % 4][0], sets[i % 4][1][:, 3:], r_z, r_yx, "border")

    def library(i):
        return F.grid_sample(*grids[i % 4], mode="bilinear", padding_mode="border",
                             align_corners=True)

    vox = b * z * y * x
    fwd_bytes = vox * (4 * c + 12 + 4 * c)  # image read, (dz, dy, dx) read, out written
    fwd_flops = vox * (45 + 24 + 16 * c)  # clips, coords, 8 weights; 8 taps per channel
    bytes_ms = fwd_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = fwd_flops / F32_FLOPS_PER_S * 1e3
    # the kernel and F.grid_sample in turns: median of 5 windows of 40 calls each
    fwd = kernel_against_library({"kernel": kernel, "library": library}, max(bytes_ms, ops_ms),
                                 "warp3d_kernel", "sampler")
    fwd.update({
        "plain_ms": device_ms(plain, 20),
        "bytes_bound_ms": bytes_ms,
        "operations_bound_ms": ops_ms,
        "bytes": fwd_bytes,
        "back_to_back_call_ms": {"kernel": cuda_ms(kernel, 40), "plain": cuda_ms(plain, 20),
                                 "library": cuda_ms(library, 40)},
    })
    fwd["bound_ms"] = max(bytes_ms, ops_ms)
    fwd["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    fwd["achieved_GBps"] = fwd_bytes / (fwd["kernel_ms"] / 1e3) / 1e9
    # the same volumes under smooth flows of the same scale, in turns again
    smooth = [(img, smooth_flow(torch, (b, 3, z, y, x), 6.0, 610 + i))
              for i, (img, _, _) in enumerate(sets)]
    smooth_grids = [(img, clipped_grid(flow)) for img, flow in smooth]
    fwd["smooth_flow"] = kernel_against_library({
        "kernel": lambda i: warp3d(*smooth[i % 4], r_z, r_yx, "border"),
        "library": lambda i: F.grid_sample(*smooth_grids[i % 4], mode="bilinear",
                                           padding_mode="border", align_corners=True)},
        fwd["bound_ms"], "warp3d_kernel", "sampler")
    print("warp3d times " + json.dumps(fwd) + "  (bound: H100 SXM 3.35 TB/s, 67 TFLOP/s f32)")

    bwd = {}
    for with_dimg in (False, True):
        graphs = {"plain": [], "library": []}
        for img, flow6, g in sets:
            for kind in graphs:
                im = img.clone().requires_grad_(with_dimg)
                fl = flow6[:, 3:].clone().requires_grad_(True)
                res = (warp3d_plain(im, fl, r_z, r_yx, "border") if kind == "plain"
                       else library_forward(im, fl))
                graphs[kind].append((res, (im, fl) if with_dimg else (fl,), g))

        def bwd_kernel(i):
            img, flow6, g = sets[i % 4]
            return _launch3d_backward(img, flow6[:, 3:], g, r_z, r_yx, "border", with_dimg)

        def through(kind):
            def run(i):
                res, leaves, g = graphs[kind][i % 4]
                return torch.autograd.grad(res, leaves, g, retain_graph=True)
            return run

        # the design also zero-fills its f32 accumulator and reads it back
        # under the atomics, beyond the function's bytes
        function_bytes, flops = warp3d_backward_work(VOLUME_SHAPE, 4, with_dimg)
        bytes_ms = function_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        kernel_only = device_ms(bwd_kernel, 40, only="warp3d_bwd_kernel", launches=1)
        bwd["with_dimg" if with_dimg else "dflow_only"] = {
            "kernel_ms": kernel_only,
            "call_device_ms": device_ms(bwd_kernel, 40),  # with the zero-fill and the cast
            "plain_ms": device_ms(through("plain"), 10),
            "library_ms": device_ms(through("library"), 20),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_bound_ms": bytes_ms, "operations_bound_ms": ops_ms,
            "bytes": function_bytes,
            "achieved_GBps": function_bytes / (kernel_only / 1e3) / 1e9,
            "back_to_back_call_ms": cuda_ms(bwd_kernel, 40),
        }
    print("warp3d_bwd times " + json.dumps(bwd) + "  (bound: H100 SXM 3.35 TB/s, 67 TFLOP/s f32)")
    bwd.update(warp3d_backward_cases(torch))
    return fwd, bwd


def warp3d_backward_work(shape, size: int, with_dimg: bool) -> tuple[int, int]:
    """Bytes and f32 operations of the backward at ``[B, Z, Y, X, C]`` with
    elements of ``size`` bytes: image, flow and g read once, dflow (and dimg)
    written once; clips, coordinates and 8 weights, and per channel the 8
    taps' differences (and the 8 scattered products)."""
    b, z, y, x, c = shape
    vox = b * z * y * x
    function_bytes = vox * size * (c + 3 + c + 3 + (c if with_dimg else 0))
    flops = vox * (45 + 24 + 60 * c + (16 * c if with_dimg else 0))
    return function_bytes, flops


def warp3d_backward_bound_ms(shape, size: int, with_dimg: bool) -> tuple[float, str]:
    """The backward's bound: its bytes over the HBM rate against its
    operations over the f32 rate, whichever is larger, and which it is."""
    function_bytes, flops = warp3d_backward_work(shape, size, with_dimg)
    bytes_ms = function_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def warp3d_backward_cases(torch) -> dict:
    """The 3-D backward where the 3-D training paths run it, each case one
    launch of ``warp3d_bwd_kernel`` through ``_launch3d_backward`` (border,
    radii (8, 8)): at [4, 1, 64, 64, 64] on iid and smooth flows (``smooth_flow``,
    scale 6, as the forward's smooth set), f32 and bf16, ``dflow`` only and
    with ``dimg`` on smooth flows, and bf16 on the layout the bf16 model hands
    it (``warp3d layouts``: the flow a slice of a channels-last-3d 6-channel
    flow, read element by element, the gradient contiguous); at
    [1, 1, 256, 256, 256] (``train256``) in f32 on smooth and iid flows.
    Medians of 5 profiler windows of 40 calls over 4 input sets, the cases of
    one shape in turns, each beside its bound."""
    from opticalflowscivis_tpu_torch.ops.kernels.warp import _launch3d_backward

    r_z, r_yx = RADII_3D[0]

    def input_sets(shape, dtype, seed, smooth, ndhwc=False):
        b, z, y, x, _ = shape
        sets = []
        for i in range(4):
            img, flow6, g = warp3d_inputs(torch, shape, dtype, seed + i, False, off_integer=True)
            if smooth:
                flow6 = torch.cat([flow6[:, :3], smooth_flow(torch, (b, 3, z, y, x), 6.0,
                                                             seed + 10 + i).to(dtype)], 1)
            if ndhwc:
                flow6 = flow6.contiguous(memory_format=torch.channels_last_3d)
            sets.append((img, flow6[:, 3:], g))
        return sets

    big = (1, 256, 256, 256, 1)
    groups = (
        (VOLUME_SHAPE, (("iid", torch.float32, False, False),
                        ("smooth", torch.float32, True, False),
                        ("smooth_with_dimg", torch.float32, True, True),
                        ("bf16_iid", torch.bfloat16, False, False),
                        ("bf16_smooth", torch.bfloat16, True, False),
                        ("bf16_ndhwc_iid", torch.bfloat16, False, False),
                        ("bf16_ndhwc_smooth", torch.bfloat16, True, False))),
        (big, (("256_smooth", torch.float32, True, False),
               ("256_iid", torch.float32, False, False))),
    )
    cases = {}
    for shape, group in groups:
        fns, meta = {}, {}
        for i, (name, dtype, smooth, with_dimg) in enumerate(group):
            sets = input_sets(shape, dtype, 700 + 20 * i, smooth, "ndhwc" in name)

            def run(k, sets=sets, with_dimg=with_dimg):
                img, flow, g = sets[k % 4]
                return _launch3d_backward(img, flow, g, r_z, r_yx, "border", with_dimg)

            fns[name] = run
            bound, by = warp3d_backward_bound_ms(shape, 2 if dtype == torch.bfloat16 else 4,
                                                 with_dimg)
            meta[name] = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
                          "flows": "smooth" if smooth else "iid", "dimg": with_dimg,
                          "flow_strides": list(sets[0][1].stride()),
                          "bound_ms": bound, "bound_by": by}
        timed = interleaved_device_ms(fns, only="warp3d_bwd_kernel", launches=1)
        for name, t in timed.items():
            cases[name] = {"kernel_ms": t["median_ms"], "windows_ms": t["windows_ms"],
                           **meta[name], "bound_share": meta[name]["bound_ms"] / t["median_ms"]}
        del fns
        torch.cuda.empty_cache()
    print("warp3d_bwd cases " + json.dumps(cases) + "  (bound: H100 SXM 3.35 TB/s, 67 TFLOP/s f32)")
    return cases



# -- UPFlow: the cost volume kernels, flow estimation and training -------------------


def corr_inputs(torch, shape, dtype, seed: int, channels_last: bool):
    """Two feature maps ``[B, C, H, W]`` and an incoming gradient per ``md``,
    contiguous or in the channels-last layout cuDNN may produce."""
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f1 = torch.randn(shape, generator=gen, device="cuda").to(dtype).contiguous(memory_format=fmt)
    f2 = torch.randn(shape, generator=gen, device="cuda").to(dtype).contiguous(memory_format=fmt)

    def grad(md):
        b, _, h, w = shape
        g = torch.randn((b, (2 * md + 1) ** 2, h, w), generator=gen, device="cuda").to(dtype)
        return g.contiguous(memory_format=fmt)

    return f1, f2, grad


def phase_corr_vs_plain(torch):
    """``corr`` against ``cost_volume_plain`` and ``corr_bwd`` against autograd
    through it: the five model shapes and an odd one, md 4 and 2 (the odd shape
    also md 1 and 3: every md the kernels are built for), f32 and bf16,
    contiguous and channels-last; the odd shape, and two on the backward
    tile's edges (at md 1 and 3, and at md 4 with rows of a multiple of 4),
    also with each gradient alone.  Then channel
    slices of wider maps, two runs of each kernel bit for bit, and the
    launch geometries against ``forward_launch`` and ``backward_launch``."""
    from opticalflowscivis_tpu_torch.ops.correlation import cost_volume_plain
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
    from opticalflowscivis_tpu_torch.ops.kernels.correlation import cost_volume_kernel

    def grads(fn, f1, f2, g, md, needs):
        a = f1.detach().clone(memory_format=torch.preserve_format).requires_grad_(needs != "f2")
        b = f2.detach().clone(memory_format=torch.preserve_format).requires_grad_(needs != "f1")
        fn(a, b, md).backward(g)
        return a.grad, b.grad

    # worst float32 errors (absolute), worst bf16 gradient error relative to
    # the largest gradient of its case, and the number of cases
    worst = {"fwd": 0.0, "bwd": 0.0, "bwd_bf16_rel": 0.0, "fwd_cases": 0, "bwd_cases": 0}
    seed = 700
    odd_mds = {CORR_ODD_SHAPE: (4, 2, 1, 3), CORR_EDGE_SHAPE: (1, 3), CORR_VEC_EDGE_SHAPE: (4,)}
    for shape in CORR_SHAPES + tuple(odd_mds):
        odd = shape in odd_mds
        mds = odd_mds.get(shape, (4, 2))
        for md in mds:
            for dtype in (torch.float32, torch.bfloat16):
                for cl in (False, True):
                    seed += 1
                    name = str(dtype).replace("torch.", "")
                    tag = f"{list(shape)} md={md} {name:8s} {'nhwc' if cl else 'nchw'}"
                    f1, f2, grad = corr_inputs(torch, shape, dtype, seed, cl)
                    before = dict(LAUNCHES)
                    out = cost_volume_kernel(f1, f2, md)
                    torch.cuda.synchronize()
                    ref = cost_volume_plain(f1, f2, md)
                    check(LAUNCHES["corr"] == before["corr"] + 1
                          and LAUNCHES["corr_bwd"] == before["corr_bwd"], "corr launch count")
                    check(out.dtype == dtype and out.shape == ref.shape and out.is_contiguous(),
                          "corr output type")
                    diff = (out.float() - ref.float()).abs()
                    err = float(diff.max())
                    if dtype == torch.float32:
                        ok, tol = err <= F32_TOL, f"{F32_TOL:g}"
                        worst["fwd"] = max(worst["fwd"], err)
                    else:
                        # the float32 sums of C products that cancel differ by up
                        # to F32_TOL whatever the result's size; each side then
                        # rounds once to bf16
                        near = within_one_bf16_ulp(out, ref, slack=F32_TOL)
                        ok, tol = bool(near.all()), f"1 bf16 ulp + {F32_TOL:g}"
                    print(f"corr {tag} max_abs_err={err:.3e} tol={tol} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        at = int((~near).flatten().nonzero()[0])
                        print(f"  first element beyond: kernel {float(out.flatten()[at]):.8e} "
                              f"plain {float(ref.flatten()[at]):.8e}")
                    check(ok, f"corr kernel disagrees with plain ({tag})")
                    worst["fwd_cases"] += 1

                    g = grad(md)
                    for needs in (("both", "f1", "f2") if odd else ("both",)):
                        before = dict(LAUNCHES)
                        got = grads(cost_volume_kernel, f1, f2, g, md, needs)
                        torch.cuda.synchronize()
                        check(LAUNCHES["corr_bwd"] == before["corr_bwd"] + 1,
                              "corr backward launch count")
                        want = grads(cost_volume_plain, f1, f2, g, md, needs)
                        check(LAUNCHES["corr_bwd"] == before["corr_bwd"] + 1,
                              "the plain version launched")
                        rel = BWD_F32_TOL if dtype == torch.float32 else BWD_BF16_TOL
                        ok, shown = True, []
                        for what, x, y in zip(("df1", "df2"), got, want):
                            if y is None:
                                check(x is None, f"a gradient nobody asked for ({what})")
                                continue
                            check(x.dtype == dtype and x.shape == y.shape, f"{what} type")
                            err = float((x.float() - y.float()).abs().max())
                            scale = float(y.float().abs().max())
                            ok = ok and err <= rel * scale
                            shown.append(f"{what}_err={err:.3e} (max|ref|={scale:.3e})")
                            if dtype == torch.float32:
                                worst["bwd"] = max(worst["bwd"], err)
                            else:
                                worst["bwd_bf16_rel"] = max(worst["bwd_bf16_rel"], err / scale)
                        worst["bwd_cases"] += 1
                        print(f"corr_bwd {tag} needs={needs:4s} {' '.join(shown)} "
                              f"tol={rel:g}*max|ref| {'ok' if ok else 'FAIL'}")
                        check(ok, f"corr backward disagrees with plain ({tag}, {needs})")
    corr_bwd_slices_and_repeats(torch, worst)
    corr_fwd_geometry(torch)
    corr_bwd_geometry(torch)
    # a max_disp the kernels are not built for is refused, not served another way
    f1, f2, _ = corr_inputs(torch, CORR_ODD_SHAPE, torch.float32, seed, False)
    for md in (0, 5):
        before = dict(LAUNCHES)
        try:
            cost_volume_kernel(f1, f2, md)
        except ValueError as e:
            print(f"corr md={md}: refused ({e})")
        else:
            check(False, f"corr took max_disp {md}")
        check(dict(LAUNCHES) == before, "a refused cost volume counted a launch")
    print("corr vs plain " + json.dumps(worst))
    return worst


def corr_bwd_slices_and_repeats(torch, worst):
    """``corr_bwd`` on channel slices of wider feature maps (NCHW and
    channels-last, so no stride is the contiguous one), against autograd
    through the plain version at the backward tolerances; then two backward
    runs on the same inputs, which must agree bit for bit (no atomics); then
    ``corr`` on the same slices against the plain version, twice bit for
    bit."""
    from opticalflowscivis_tpu_torch.ops.correlation import cost_volume_plain
    from opticalflowscivis_tpu_torch.ops.kernels.correlation import (
        _launch_backward,
        cost_volume_kernel,
    )

    md = 4
    for shape in (CORR_SHAPES[-1], CORR_EDGE_SHAPE):
        b, c, h, w = shape
        for dtype in (torch.float32, torch.bfloat16):
            for cl in (False, True):
                wide1, wide2, grad = corr_inputs(torch, (b, c + 9, h, w), dtype, 950 + c, cl)
                f1, f2 = wide1[:, 5:5 + c], wide2[:, 2:2 + c]
                check(not f1.is_contiguous() and not f1.is_contiguous(
                    memory_format=torch.channels_last), "the slice should be non-contiguous")
                g = grad(md)

                def through(fn, f1=f1, f2=f2, g=g):
                    # leaves that keep the slices' strides (a clone would not)
                    a, bq = f1.detach().requires_grad_(True), f2.detach().requires_grad_(True)
                    fn(a, bq, md).backward(g)
                    return a.grad, bq.grad

                got, want = through(cost_volume_kernel), through(cost_volume_plain)
                rel = BWD_F32_TOL if dtype == torch.float32 else BWD_BF16_TOL
                name = str(dtype).replace("torch.", "")
                tag = f"{list(shape)} md={md} {name:8s} {'nhwc' if cl else 'nchw'} slice"
                shown = []
                for what, x, y in zip(("df1", "df2"), got, want):
                    err = float((x.float() - y.float()).abs().max())
                    scale = float(y.float().abs().max())
                    shown.append(f"{what}_err={err:.3e} (max|ref|={scale:.3e})")
                    check(err <= rel * scale, f"corr backward disagrees with plain ({tag}, {what})")
                    if dtype == torch.float32:
                        worst["bwd"] = max(worst["bwd"], err)
                    else:
                        worst["bwd_bf16_rel"] = max(worst["bwd_bf16_rel"], err / scale)
                worst["bwd_cases"] += 1
                print(f"corr_bwd {tag} {' '.join(shown)} tol={rel:g}*max|ref| ok")
                first = _launch_backward(f1, f2, g, md)
                second = _launch_backward(f1, f2, g, md)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(first, second))
                print(f"corr_bwd {tag} twice: {'bit-equal' if same else 'DIFFER'}")
                check(same, f"two corr backward runs differ ({tag})")
                # the forward on the same slices, against the plain version and twice
                out, again = cost_volume_kernel(f1, f2, md), cost_volume_kernel(f1, f2, md)
                torch.cuda.synchronize()
                ref = cost_volume_plain(f1, f2, md)
                err = float((out.float() - ref.float()).abs().max())
                ok = (err <= F32_TOL if dtype == torch.float32
                      else bool(within_one_bf16_ulp(out, ref, slack=F32_TOL).all()))
                same = torch.equal(out, again)
                print(f"corr {tag} max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}, twice: "
                      f"{'bit-equal' if same else 'DIFFER'}")
                check(ok, f"corr kernel disagrees with plain ({tag})")
                check(same, f"two corr forward runs differ ({tag})")
                if dtype == torch.float32:
                    worst["fwd"] = max(worst["fwd"], err)


def corr_fwd_geometry(torch):
    """The launch the built ``corr_forward`` reports for each shape, md and
    type against ``forward_launch``, and both refusing a grid beyond CUDA's z
    limit."""
    from opticalflowscivis_tpu_torch.ops.kernels.correlation import (
        forward_launch,
        kernel_forward_launch,
    )

    cases = 0
    for shape in CORR_SHAPES + (CORR_ODD_SHAPE, CORR_EDGE_SHAPE, CORR_VEC_EDGE_SHAPE):
        for md in (1, 2, 3, 4):
            for bf16 in (False, True):
                got = kernel_forward_launch(shape, md, bf16)
                check(got == forward_launch(shape, md, bf16),
                      f"corr_forward_launch {got} for {shape} md {md} bf16 {bf16}, "
                      f"forward_launch {forward_launch(shape, md, bf16)}")
                cases += 1
    too_many = (21846, 32, 8, 16)  # 21846 samples x 3 row-offset groups
    check(kernel_forward_launch(too_many, 4) is None, "the kernel took a grid beyond 65535")
    try:
        forward_launch(too_many, 4)
    except ValueError:
        pass
    else:
        check(False, "forward_launch took a grid beyond 65535")
    print(f"corr geometry: {cases} cases agree with forward_launch; per level at md 4: "
          f"{[tuple(forward_launch(shape, 4)) for shape in CORR_SHAPES]}")


def corr_bwd_geometry(torch):
    """The launch the built ``corr_backward`` reports for each shape, md and
    number of gradients against ``backward_launch``, and both refusing a grid
    beyond CUDA's z limit."""
    from opticalflowscivis_tpu_torch.ops.kernels.correlation import (
        backward_launch,
        kernel_backward_launch,
    )

    cases = 0
    for shape in CORR_SHAPES + (CORR_ODD_SHAPE, CORR_EDGE_SHAPE, CORR_VEC_EDGE_SHAPE):
        for md in (1, 2, 3, 4):
            for copies in (1, 2):
                got = kernel_backward_launch(shape, md, copies)
                check(got == backward_launch(shape, md, copies),
                      f"corr_backward_launch {got} for {shape} md {md} x{copies}, "
                      f"backward_launch {backward_launch(shape, md, copies)}")
                cases += 1
    too_many = (40000, 32, 8, 16)
    check(kernel_backward_launch(too_many, 4, 2) is None, "the kernel took a grid beyond 65535")
    try:
        backward_launch(too_many, 4, 2)
    except ValueError:
        pass
    else:
        check(False, "backward_launch took a grid beyond 65535")
    print(f"corr_bwd geometry: {cases} cases agree with backward_launch; "
          f"{list(CORR_SHAPES[-1])} md 4: {backward_launch(CORR_SHAPES[-1], 4)}")


def upflow_pairs(n: int, hw, seed: int, shift=(3, -5)):
    """``[n, 2, H, W, 3]`` pairs and their true flow ``[n, H, W, 2]``: a smooth
    random texture (noise on a 16 x 52 grid, upsampled) and the same texture
    moved by ``shift`` pixels, so that every pixel carries signal.  im2(p) =
    im1(p - shift), so the forward flow is +shift."""
    import torch
    import torch.nn.functional as F

    h, w = hw
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.uniform(0.05, 1.0, (n, 3, h // 16, w // 16)).astype(np.float32))
    im1 = F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=True).clamp(0, 1)
    im1 = im1.permute(0, 2, 3, 1).numpy()
    im2 = np.roll(im1, shift, axis=(1, 2))
    flow = np.broadcast_to(np.asarray(shift, np.float32), (n, h, w, 2)).copy()
    return np.stack([im1, im2], axis=1), flow


def upflow_config(tmp: str, name: str, bfloat16: bool, **kw):
    """``UPFlowTrainConfig`` with its defaults: full width, cost-volume
    normalisation per image and channel, batch 8, lr 1e-4."""
    from opticalflowscivis_tpu_torch.training import UPFlowTrainConfig

    return UPFlowTrainConfig(bfloat16=bfloat16, exp_dir=os.path.join(tmp, f"upflow_{name}"), **kw)


def close_enough(got, want, what: str) -> None:
    """Within ``CPU_TOL`` of the largest reference value: float32 convolutions
    in other orders through five decode levels, each of which doubles the flow
    it takes over."""
    err = float((got.float().cpu() - want.float().cpu()).abs().max())
    scale = max(1.0, float(want.abs().max()))
    print(f"{what}: max_abs_err={err:.3e} tol={CPU_TOL * scale:.3e} max|ref|={scale:.3e}")
    check(err <= CPU_TOL * scale, f"{what} disagrees")


def launch_delta(before: dict) -> dict:
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES

    return {k: LAUNCHES[k] - before[k] for k in before if LAUNCHES[k] != before[k]}


def phase_upflow_serving(torch, tmp: str):
    """``UPFlowTrainer.predict`` on 8 pairs at 256 x 832 x 3, seed-0 weights."""
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from opticalflowscivis_tpu_torch.training import UPFlowTrainer

    h, w = UPFLOW_HW
    pairs, _ = upflow_pairs(UPFLOW_BATCH, UPFLOW_HW, seed=0)
    trainers = {name: UPFlowTrainer(upflow_config(tmp, f"serve_{name}", name == "bf16"))
                for name in ("f32", "bf16")}
    reset_launches()  # the UPFlow serving path's run starts here
    flows = {}
    for name, tr in trainers.items():
        before = dict(LAUNCHES)
        parts, extras = tr.predict(pairs)
        torch.cuda.synchronize()
        delta = launch_delta(before)
        flows[name] = extras["flow_f"].float().cpu()
        print(f"predict {name} [{UPFLOW_BATCH},{h},{w},3]: launches={delta} "
              f"mean|flow_f|={float(flows[name].norm(dim=-1).mean()):.3f} "
              f"loss_total={float(parts['loss_total']):.5f}")
        # 5 cost volumes; 4 feature warps in the model (each writes its validity
        # mask in the same launch), then the occlusion check's 2 warps and the
        # photometric term's 2 in the losses
        check(delta == {"corr": 5, "warp2d": 8}, f"{name} predict launches {delta}")
        check(extras["flow_f"].shape == (UPFLOW_BATCH, h, w, 2)
              and extras["flow_b"].shape == (UPFLOW_BATCH, h, w, 2), f"{name} flow shapes")
        check(bool(torch.isfinite(extras["flow_f"]).all())
              and bool(torch.isfinite(extras["flow_b"]).all())
              and all(math.isfinite(float(v)) for v in parts.values()), f"{name} not finite")
    torch.cuda.synchronize()
    counts = {k: LAUNCHES[k] for k in ("corr", "warp2d")}  # read just after the run
    print(f"UPFlow serving path: launches={counts}")
    check(counts["corr"] == 10, "the UPFlow serving path missed the cost volume kernel")
    corr_layouts(torch, trainers, pairs)
    diff = (flows["bf16"] - flows["f32"]).abs()
    d_max, d_mean = float(diff.max()), float(diff.mean())
    top, mag = float(flows["f32"].abs().max()), float(flows["f32"].norm(dim=-1).mean())
    print(f"flow_f bf16 vs f32 max_abs_diff={d_max:.3e} (max|f32|={top:.3e}, "
          f"tol={UPFLOW_BF16_FLOW_MAX_TOL:g}*max) mean_abs_diff={d_mean:.3e} "
          f"(mean|f32|={mag:.3e}, tol={UPFLOW_BF16_FLOW_MEAN_TOL:g}*mean)")
    check(d_max <= UPFLOW_BF16_FLOW_MAX_TOL * top and d_mean <= UPFLOW_BF16_FLOW_MEAN_TOL * mag,
          "the bf16 UPFlow model's flow_f is too far from the float32 model's")

    # the same weights on the CPU (the plain path) at batch 1: the model alone,
    # on a 128 x 416 pair (a quarter of the plane keeps the CPU's share of this
    # script's time at a few seconds; every level still has more than one tile)
    tr = trainers["f32"]
    cpu = UPFlowTrainer(tr.cfg, device="cpu")
    cpu.net.load_state_dict(tr.net.state_dict())
    one, _ = upflow_pairs(1, (h // 2, w // 2), seed=3)
    with torch.no_grad():
        before = dict(LAUNCHES)
        got = tr._forward(*(tr.upload(one)[:, i] for i in (0, 1)))
        torch.cuda.synchronize()
        delta = launch_delta(before)
        want = cpu._forward(*(cpu.upload(one)[:, i] for i in (0, 1)))
    check(delta == {"corr": 5, "warp2d": 4}, f"batch-1 forward launches {delta}")
    PER_CALL["upflow_forward"] = delta
    close_enough(got["flow_f"], want["flow_f"], "cuda vs cpu UPFlow flow_f")
    close_enough(got["flow_b"], want["flow_b"], "cuda vs cpu UPFlow flow_b")
    for level, ((gf, _), (wf, _)) in enumerate(zip(got["flows"], want["flows"])):
        close_enough(gf, wf, f"cuda vs cpu UPFlow level {level} (finest first)")
    return counts, trainers


def corr_layouts(torch, trainers, pairs) -> dict:
    """One ``corr layouts`` line: the shape, dtype, strides and layout of the
    two maps the model hands ``cost_volume_kernel`` at each level (coarsest
    first) of a forward on ``pairs``, in f32 and bf16; "nchw" maps whose rows
    are a multiple of 4 elements take the kernel's vector path at md 4."""
    from opticalflowscivis_tpu_torch.models import upflow as upflow_model

    original = upflow_model.cost_volume_kernel
    seen = {}

    def layout(f):
        if f.is_contiguous():
            return "nchw"
        return "nhwc" if f.is_contiguous(memory_format=torch.channels_last) else "strided"

    def record(f1, f2, max_disp=4):
        seen[name].append({"shape": list(f1.shape), "dtype": str(f1.dtype).replace("torch.", ""),
                           "strides": [list(f1.stride()), list(f2.stride())],
                           "layout": [layout(f1), layout(f2)]})
        return original(f1, f2, max_disp)

    try:
        upflow_model.cost_volume_kernel = record
        for name, tr in trainers.items():
            seen[name] = []
            with torch.no_grad():
                tr._forward(*(tr.upload(pairs)[:, i] for i in (0, 1)))
    finally:
        upflow_model.cost_volume_kernel = original
    torch.cuda.synchronize()
    print("corr layouts " + json.dumps(seen))
    check(all(len(v) == 5 for v in seen.values()), f"expected 5 cost volumes a forward: {seen}")
    return seen


def phase_upflow_training(torch, tmp: str):
    """``UPFlowTrainer.fit`` at full width on textured, shifted 256 x 832 pairs."""
    from opticalflowscivis_tpu_torch.models import UPFlowNet
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from opticalflowscivis_tpu_torch.training import UPFlowTrainConfig, UPFlowTrainer

    b = UPFLOW_BATCH
    epochs, steps_per_epoch, n_val = 8, 2, 4
    pairs, flow = upflow_pairs(steps_per_epoch * b + n_val, UPFLOW_HW, seed=1)
    train, val, val_flow = pairs[:-n_val], pairs[-n_val:], flow[-n_val:]
    keys = ("corr", "corr_bwd", "warp2d", "warp2d_bwd")
    launches = dict.fromkeys(keys, 0)
    trainers = {}
    for name in ("f32", "bf16"):
        cfg = upflow_config(tmp, f"fit_{name}", name == "bf16")
        tr = UPFlowTrainer(cfg)
        reset_launches()  # the UPFlow training path's run starts here
        hist = tr.fit(train, epochs=epochs, log_every=0, val_pairs=val, val_flow=val_flow)
        torch.cuda.synchronize()
        counts = {k: LAUNCHES[k] for k in keys}  # read just after the run
        steps = epochs * steps_per_epoch
        print(f"upflow fit {name}: {steps} train steps + {epochs} validations at "
              f"[{b},{UPFLOW_HW[0]},{UPFLOW_HW[1]},3]: launches={counts} loss_total first epoch "
              f"{hist[0]['loss_total']:.6f} last {hist[-1]['loss_total']:.6f} val_epe first "
              f"{hist[0]['val_epe']:.4f} last {hist[-1]['val_epe']:.4f} "
              f"(zero flow {hist[-1]['val_epe_zero_flow']:.4f})")
        check(len(hist) == epochs and tr.state.step == steps, f"{name} upflow fit length")
        check(all(math.isfinite(v) for parts in hist for v in parts.values()),
              f"{name} upflow losses not finite")
        check(hist[-1]["loss_total"] < hist[0]["loss_total"],
              f"{name} upflow fit did not lower loss_total")
        # a train step: 5 cost volumes and their 5 backwards, 8 warps (see
        # predict) of which the 4 feature warps and the 2 photometric ones carry a
        # gradient; a validation: the model alone, 5 cost volumes and 4 warps
        expect = {"corr": 5 * (steps + epochs), "corr_bwd": 5 * steps,
                  "warp2d": 8 * steps + 4 * epochs, "warp2d_bwd": 6 * steps}
        check(counts == expect, f"{name}: launches {counts}, expected {expect}")
        for k in keys:
            launches[k] += counts[k]

        with open(os.path.join(cfg.exp_dir, "loss.json")) as f:
            rows = json.load(f)["loss"]
        check(len(rows) == epochs and all("val_epe" in row for row in rows),
              f"{name} upflow loss.json")
        fresh = UPFlowTrainer(cfg)
        fresh.init_state(steps_per_epoch)
        check(fresh.load_checkpoint() and fresh.state.step == steps, f"{name} upflow checkpoint")
        restored = fresh.net.state_dict()
        check(all(torch.equal(v, restored[k]) for k, v in tr.net.state_dict().items()),
              f"{name}: restored UPFlow weights differ")
        ours = tr.predict(val)[1]["flow_f"]
        close_enough(fresh.predict(val)[1]["flow_f"], ours,
                     f"checkpoint {name}: restored trainer's flow_f")
        trainers[name] = (tr, train)
    print(f"UPFlow training path: launches={launches}")
    check(all(v > 0 for v in launches.values()), "the UPFlow training path missed a kernel")
    for name, (tr, train) in trainers.items():
        # the 4 feature warps carry the features' gradient, the photometric
        # term's 2 warps of the input frames none
        record_warp2d_layouts(torch, f"upflow_{name}",
                              lambda tr=tr, train=train: tr.train_step(
                                  tr._batch(tr.upload(train[:b]))), 6, 4)
    print("warp2d layouts " + json.dumps(WARP2D_LAYOUTS))

    # the two-stream decode gives the flows of the stacked one from the same weights
    tr = trainers["f32"][0]
    streams = UPFlowNet(dataclasses.replace(tr.cfg.model, batch_directions=False), device="cuda")
    streams.load_state_dict(tr.net.state_dict())
    dev = tr.upload(val[:2])
    with torch.no_grad():
        before = dict(LAUNCHES)
        a = tr.net(dev[:, 0].movedim(-1, 1), dev[:, 1].movedim(-1, 1))
        mid = launch_delta(before)
        c = streams(dev[:, 0].movedim(-1, 1), dev[:, 1].movedim(-1, 1))
        torch.cuda.synchronize()
    both = launch_delta(before)
    second = {k: both[k] - mid[k] for k in both}
    print(f"decode forms: stacked launches {mid}, two streams {second}")
    check(mid == {"corr": 5, "warp2d": 4} and second == {"corr": 10, "warp2d": 8},
          f"decode forms launches {mid} {second}")
    close_enough(c["flow_f"], a["flow_f"], "two-stream vs stacked flow_f")
    close_enough(c["flow_b"], a["flow_b"], "two-stream vs stacked flow_b")

    # the ex_runner recipe: a second forward on the transformed pair
    ex = UPFlowTrainer(UPFlowTrainConfig.preset_ex_runner(
        exp_dir=os.path.join(tmp, "upflow_ex"), bfloat16=True))
    ex.init_state(steps_per_epoch)
    before = dict(LAUNCHES)
    parts = ex.train_step(ex._batch(ex.upload(train[:b])))
    torch.cuda.synchronize()
    delta = launch_delta(before)
    print(f"ex_runner train step: launches={delta} eq_loss={float(parts['eq_loss']):.5f} "
          f"oi_loss={float(parts['oi_loss']):.5f}")
    # two forwards' 4 + 4 feature warps, the losses' 4, the transform's 3
    check(delta == {"corr": 10, "corr_bwd": 10, "warp2d": 15, "warp2d_bwd": 11},
          f"ex_runner step launches {delta}")
    check(all(math.isfinite(float(v)) for v in parts.values()), "ex_runner parts not finite")
    return launches, trainers


def phase_upflow_step_vs_cpu(torch, tmp: str):
    """One full-width train step at batch 1 on a 128 x 256 textured pair from
    the same weights, card against CPU: loss parts and parameter gradients."""
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
    from opticalflowscivis_tpu_torch.training import UPFlowTrainer

    pairs, _ = upflow_pairs(1, (128, 256), seed=2)
    cfg = upflow_config(tmp, "step", False, batch_size=1)
    parts, grads = {}, {}
    for device in ("cuda", "cpu"):
        tr = UPFlowTrainer(cfg, device=device)
        tr.init_state()
        before = dict(LAUNCHES)
        parts[device] = {k: float(v) for k, v in
                         tr.train_step(tr._batch(tr.upload(pairs))).items()}
        delta = launch_delta(before)
        check(delta == ({"corr": 5, "corr_bwd": 5, "warp2d": 8, "warp2d_bwd": 6}
                        if device == "cuda" else {}), f"{device} upflow step launches {delta}")
        if device == "cuda":
            PER_CALL["upflow_train_step"] = delta
        grads[device] = {n: p.grad.detach().cpu() for n, p in tr.net.named_parameters()}
    for key, ref in parts["cpu"].items():
        print(f"upflow train step cuda vs cpu {key}: cuda={parts['cuda'][key]:.6e} "
              f"cpu={ref:.6e} tol={TRAIN_PARTS_TOL:g} rel")
        check(abs(parts["cuda"][key] - ref) <= TRAIN_PARTS_TOL * max(abs(ref), 1e-6),
              f"upflow train step {key} disagrees")
    largest = max(float(g.abs().max()) for g in grads["cpu"].values())
    worst, where = max((float((grads["cuda"][n] - g).abs().max()), n)
                       for n, g in grads["cpu"].items())
    print(f"upflow train step cuda vs cpu gradients: max_abs_diff={worst:.3e} at {where}, "
          f"largest gradient {largest:.3e}, ratio {worst / largest:.3e} tol={TRAIN_GRAD_TOL:g}")
    check(worst <= TRAIN_GRAD_TOL * largest, "upflow train step gradients disagree with the CPU")


def phase_upflow_cli(torch, tmp: str):
    """generate → train_upflow (1 epoch) → test_upflow, in process, on the card."""
    from opticalflowscivis_tpu_torch.cli.__main__ import main as cli
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES

    data = os.path.join(tmp, "cliu_d")
    common = ["--dataset", "rectangle2d_tex_pan", "--data_dir", data, "--results_dir",
              os.path.join(tmp, "cliu_r")]
    before = dict(LAUNCHES)
    cli(["generate", "--dataset", "rectangle2d_tex_pan", "--frames", "60", "--data_dir", data])
    cli(["train_upflow", "--epochs", "1", "--batch_size", "8", "--census_weight", "1.0",
         "--smooth1_weight", "0.1", *common])
    cli(["test_upflow", "--max_frames", "9", *common])
    torch.cuda.synchronize()
    run = os.path.join(tmp, "cliu_r", "rectangle2d_tex_pan", "upflow")
    with open(os.path.join(run, "loss.json")) as f:
        rows = json.load(f)["loss"]
    with open(os.path.join(run, "test_report.json")) as f:
        report = json.load(f)["scivis"]
    check(len(rows) == 1 and all(math.isfinite(v) for v in rows[0].values())
          and "val_epe" in rows[0], "cli train_upflow loss.json")
    check(os.path.isfile(os.path.join(run, "upflow.ckpt"))
          and os.path.isfile(os.path.join(run, "ckpt_meta.json")), "cli upflow checkpoint")
    check(set(report) == {"mean_flow_mag", "frames", "epe", "epe_zero_flow_baseline"}
          and all(math.isfinite(v) for v in report.values()), "cli test_upflow report")
    delta = launch_delta(before)
    print(f"cli upflow: generate, train_upflow, test_upflow ok; report={json.dumps(report)} "
          f"launches={delta}")
    check(all(delta.get(k, 0) > 0 for k in ("corr", "corr_bwd", "warp2d", "warp2d_bwd")),
          "the UPFlow CLI run missed a kernel")


def phase_upflow_times(torch, serving, training):
    """Forward and train step at 256 x 832 batch 8, and the two cost volume
    kernels at the finest level's shape, [16, 32, 64, 208] md 4."""
    from opticalflowscivis_tpu_torch.ops.correlation import cost_volume_plain
    from opticalflowscivis_tpu_torch.ops.kernels.correlation import (
        _launch_backward,
        cost_volume_kernel,
    )

    b = UPFLOW_BATCH
    times = {}
    sets = [upflow_pairs(b, UPFLOW_HW, seed=10 + i)[0] for i in range(2)]
    for name, tr in serving.items():
        dev = [tr.upload(p) for p in sets]

        def forward(i, tr=tr, dev=dev):
            with torch.no_grad():
                return tr._forward(dev[i % 2][:, 0], dev[i % 2][:, 1])

        ms, host_ms = cuda_and_host_ms(forward, iters=8)
        times[f"upflow_forward_ms_{name}"] = ms
        times[f"upflow_forward_pairs_per_sec_{name}"] = b * 1e3 / ms
        times[f"upflow_forward_pairs_per_sec_host_clock_{name}"] = b * 1e3 / host_ms
        profile_forward(torch, f"upflow_{name}", forward, iters=2)
    for name, (tr, train) in training.items():
        batches = [tr._batch(tr.upload(train[i * b : (i + 1) * b])) for i in range(2)]

        def step(i, tr=tr, batches=batches):
            return tr.train_step(batches[i % 2])

        ms, host_ms = cuda_and_host_ms(step, iters=6)
        times[f"upflow_train_step_ms_{name}"] = ms
        times[f"upflow_train_pairs_per_sec_{name}"] = b * 1e3 / ms
        times[f"upflow_train_pairs_per_sec_host_clock_{name}"] = b * 1e3 / host_ms
        profile_forward(torch, f"upflow_train_{name}", step, iters=2, unit="train_step")
    print("upflow times " + json.dumps(times))

    md = 4
    shape = CORR_SHAPES[-1]
    bb, c, h, w = shape
    d = (2 * md + 1) ** 2
    out = {}
    # the operations bound takes the card's peak for the operands' type: bf16
    # products have the tensor cores' rate as their limit, whether or not the
    # kernel uses them
    for dtype, size, peak in ((torch.float32, 4, F32_FLOPS_PER_S),
                              (torch.bfloat16, 2, BF16_FLOPS_PER_S)):
        name = str(dtype).replace("torch.", "")
        sets = []
        for i in range(4):
            f1, f2, grad = corr_inputs(torch, shape, dtype, 800 + i, False)
            sets.append((f1, f2, grad(md)))
        graphs = []
        for f1, f2, g in sets:
            a, bq = f1.clone().requires_grad_(True), f2.clone().requires_grad_(True)
            graphs.append((cost_volume_plain(a, bq, md), (a, bq), g))

        def kernel(i):
            return cost_volume_kernel(sets[i % 4][0], sets[i % 4][1], md)

        def plain(i):
            return cost_volume_plain(sets[i % 4][0], sets[i % 4][1], md)

        def bwd_kernel(i):
            return _launch_backward(*sets[i % 4], md)

        def bwd_plain(i):
            res, leaves, g = graphs[i % 4]
            return torch.autograd.grad(res, leaves, g, retain_graph=True)

        # bytes the function must move: f1 and f2 read, the volume written; the
        # backward reads f1, f2 and g and writes df1 and df2.  Operations: one
        # multiply-add per (pixel, channel, displacement), twice that backward.
        fwd_bytes = (2 * bb * c * h * w + bb * d * h * w) * size
        bwd_bytes = (4 * bb * c * h * w + bb * d * h * w) * size
        fwd_flops = 2 * bb * h * w * c * d
        for tag, fn, ref, nbytes, flops in (("corr", kernel, plain, fwd_bytes, fwd_flops),
                                            ("corr_bwd", bwd_kernel, bwd_plain, bwd_bytes,
                                             2 * fwd_flops)):
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / peak * 1e3
            kernel_ms = device_ms(fn, 40, only="corr_", launches=1)
            out[f"{tag}_{name}"] = {
                "kernel_ms": kernel_ms, "call_ms": cuda_ms(fn, 40),
                "plain_ms": device_ms(ref, 3),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes_bound_ms": bytes_ms, "operations_bound_ms": ops_ms, "bytes": nbytes,
                "operations": flops,
                "achieved_GBps": nbytes / (kernel_ms / 1e3) / 1e9,
                "achieved_TFLOPs": flops / (kernel_ms / 1e3) / 1e12,
                "library_ms": None,  # no single PyTorch call computes a cost volume
            }
    print("corr times " + json.dumps(out) + f"  (shape {list(shape)} md {md}; bound: H100 SXM "
          "3.35 TB/s, 67 TFLOP/s f32, 989 TFLOP/s bf16)")
    # the five model shapes, forward and backward, by CUDA events (with the host's call cost)
    levels = {}
    for shape in CORR_SHAPES:
        f1, f2, grad = corr_inputs(torch, shape, torch.float32, 900, False)
        g = grad(md)
        levels[str(list(shape))] = {
            "corr_call_ms": cuda_ms(lambda i: cost_volume_kernel(f1, f2, md), 40),
            "corr_bwd_call_ms": cuda_ms(lambda i: _launch_backward(f1, f2, g, md), 40),
        }
    print("corr per level " + json.dumps(levels))
    return times, out


def corr_kernel_times(torch) -> dict:
    """Device ms per call of ``corr`` and ``corr_bwd`` (both gradients) at the
    finest UPFlow level, [16, 32, 64, 208] md 4, in f32 and bf16, the two
    kernels' windows in turns; of ``corr`` and of ``corr_bwd`` at each of the
    five levels in f32, the levels' windows in turns; and of ``corr`` at the
    finest level on channels-last f32 maps (``interleaved_device_ms``:
    medians of 5 profiler windows of 40 calls over 4 input sets).  Each with
    its byte bound.  Only ``cost_volume_kernel`` and ``_launch_backward`` are
    called, which every version of the port has, so any checkout can be
    timed."""
    from opticalflowscivis_tpu_torch.ops.kernels.correlation import (
        _launch_backward,
        cost_volume_kernel,
    )

    md = 4
    d = (2 * md + 1) ** 2

    def bwd_bound_ms(shape, size):
        b, c, h, w = shape
        return (4 * b * c * h * w + b * d * h * w) * size / HBM_BYTES_PER_S * 1e3

    def fwd_bound_ms(shape, size):
        b, c, h, w = shape
        return (2 * b * c * h * w + b * d * h * w) * size / HBM_BYTES_PER_S * 1e3

    def input_sets(shape, dtype, seed, channels_last=False):
        sets = []
        for i in range(4):
            f1, f2, grad = corr_inputs(torch, shape, dtype, seed + i, channels_last)
            sets.append((f1, f2, grad(md)))
        return sets

    out = {}
    shape = CORR_SHAPES[-1]
    for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        sets = input_sets(shape, dtype, 800)
        timed = interleaved_device_ms({
            "corr": lambda i, sets=sets: cost_volume_kernel(sets[i % 4][0], sets[i % 4][1], md),
            "corr_bwd": lambda i, sets=sets: _launch_backward(*sets[i % 4], md),
        }, only="corr_", launches=1)
        name = str(dtype).replace("torch.", "")
        for kernel, bound in (("corr", fwd_bound_ms(shape, size)),
                              ("corr_bwd", bwd_bound_ms(shape, size))):
            ms = timed[kernel]["median_ms"]
            out[f"{kernel}_{name}"] = {"ms": ms, "windows_ms": timed[kernel]["windows_ms"],
                                       "bytes_bound_ms": bound, "bound_share": bound / ms}
        del sets
    level_sets = [input_sets(shape, torch.float32, 900 + 10 * level)
                  for level, shape in enumerate(CORR_SHAPES)]
    for kernel, call, bound_ms in (
            ("corr", lambda f1, f2, g: cost_volume_kernel(f1, f2, md), fwd_bound_ms),
            ("corr_bwd", lambda f1, f2, g: _launch_backward(f1, f2, g, md), bwd_bound_ms)):
        fns = {str(list(shape)): lambda i, sets=sets, call=call: call(*sets[i % 4])
               for shape, sets in zip(CORR_SHAPES, level_sets)}
        timed = interleaved_device_ms(fns, only="corr_", launches=1)
        out[f"{kernel}_float32_levels"] = {
            name: {"ms": t["median_ms"], "windows_ms": t["windows_ms"],
                   "bytes_bound_ms": bound_ms(json.loads(name), 4)}
            for name, t in timed.items()}
    del level_sets
    # channels-last maps at the finest level, each element read through its strides
    sets = input_sets(shape, torch.float32, 990, channels_last=True)
    timed = interleaved_device_ms(
        {"corr": lambda i: cost_volume_kernel(sets[i % 4][0], sets[i % 4][1], md)},
        only="corr_", launches=1)["corr"]
    out["corr_float32_nhwc"] = {"ms": timed["median_ms"], "windows_ms": timed["windows_ms"],
                                "bytes_bound_ms": fwd_bound_ms(shape, 4)}
    return out


def kernel_times_of(torch, root: str) -> int:
    """``--kernel-times ROOT``: the kernels' times alone, through the package
    of the checkout at ``root``, by this script's harness."""
    import opticalflowscivis_tpu_torch

    package = os.path.dirname(os.path.abspath(opticalflowscivis_tpu_torch.__file__))
    check(package == os.path.join(root, "opticalflowscivis_tpu_torch"),
          f"imported {package}, not the package under {root}")
    smi = card_line()
    print(smi)
    print(f"kernel times of {package}")
    fwd2, upflow = warp2d_forward_times(torch), phase_upflow_warp_times(torch)
    bwd2 = warp2d_backward_times(torch)
    fwd3, bwd3 = warp3d_times(torch)
    corr = corr_kernel_times(torch)
    print("corr kernel times " + json.dumps(corr))
    medians = {
        "warp2d": {k: fwd2[k] for k in ("kernel_ms", "library_ms")},
        "warp2d_smooth": {k: fwd2["smooth_flow"][k] for k in ("kernel_ms", "library_ms")},
        **{f"warp2d_upflow_{name}": {k: t[k] for k in ("kernel_ms", "with_mask_ms", "library_ms")}
           for name, t in upflow.items()},
        "warp3d": {k: fwd3[k] for k in ("kernel_ms", "library_ms")},
        "warp3d_smooth": {k: fwd3["smooth_flow"][k] for k in ("kernel_ms", "library_ms")},
        **{f"warp2d_bwd_{tag}": {k: t[k] for k in ("kernel_ms", "call_device_ms")}
           for tag, t in bwd2.items()},
        **{f"warp3d_bwd_{tag}": bwd3[tag]["kernel_ms"] for tag in bwd3},
        **{tag: t["ms"] for tag, t in corr.items() if not tag.endswith("_levels")},
        **{tag: {name: t["ms"] for name, t in levels.items()}
           for tag, levels in corr.items() if tag.endswith("_levels")},
    }
    print("kernel times " + json.dumps({"root": root, "card": smi, "ms": medians}))
    return 0


def main(argv: list) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA device",
              file=sys.stderr)
        return 1
    root = None
    if argv:
        check(len(argv) == 2 and argv[0] == "--kernel-times", f"unknown arguments {argv}")
        root = os.path.abspath(argv[1])
        sys.path.insert(0, root)
    import opticalflowscivis_tpu_torch  # noqa: F401  (fails when run outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if root is not None:
        return kernel_times_of(torch, root)

    t_start = time.perf_counter()
    smi = phase_card(torch)
    worst_f32 = phase_kernel_vs_plain(torch)
    worst_f32 = max(worst_f32, phase_warp2d_layouts_vs_plain(torch))
    worst_bwd_f32 = phase_backward_vs_plain(torch)
    phase_warp2d_bwd_layouts_vs_plain(torch)
    worst3d = phase_warp3d_vs_plain(torch)
    launches, interps = phase_main_path(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        train_launches, trainers = phase_training(torch, tmp)
        phase_train_step_vs_cpu(torch, tmp)
        phase_cli(torch, tmp)
        times, warp = phase_times(torch, interps)
        upflow_warp = phase_upflow_warp_times(torch)
        train_times, bwd = phase_train_times(torch, trainers)
        del interps, trainers  # free the 2-D models before the volumes
        torch.cuda.empty_cache()
        launches3d, interps3d = phase_serving3d(torch)
        train_launches3d, trainers3d = phase_training3d(torch, tmp)
        phase_train3d_step_checks(torch, tmp)
        phase_cli3d(torch, tmp)
        _, warp3, bwd3 = phase_times3d(torch, interps3d, trainers3d)
        del interps3d, trainers3d  # free the volumes before UPFlow
        torch.cuda.empty_cache()
        worst_corr = phase_corr_vs_plain(torch)
        upflow_serving, upflow_predictors = phase_upflow_serving(torch, tmp)
        upflow_launches, upflow_trainers = phase_upflow_training(torch, tmp)
        phase_upflow_step_vs_cpu(torch, tmp)
        phase_upflow_cli(torch, tmp)
        _, corr_times = phase_upflow_times(torch, upflow_predictors, upflow_trainers)

    source = "opticalflowscivis_tpu_torch/csrc/warp2d.cu"
    kernels = [{
        "name": "warp2d",
        "route": "cuda",
        "source": source,
        "replaces": "opticalflowscivis_tpu/ops/pallas/warp.py:217",
        "launches": launches + train_launches["warp2d"],
        "launches_serving_path": launches,
        "launches_training_path": train_launches["warp2d"],
        "launches_per_forward": PER_CALL["ifnet_2d_forward"]["warp2d"],
        "launches_per_train_step": PER_CALL["ifnet_2d_train_step"]["warp2d"],
        "launches_per_upflow_forward": PER_CALL["upflow_forward"]["warp2d"],
        "launches_per_upflow_train_step": PER_CALL["upflow_train_step"]["warp2d"],
        "max_abs_err": worst_f32,
        "ms": warp["kernel_ms"],
        "plain_ms": warp["plain_ms"],
        "bound_ms": warp["bound_ms"],
        "bound_by": warp["bound_by"],
        "library_ms": warp["library_ms"],
        "kernel_over_library": warp["kernel_over_library"],
        "upflow_finest_warp": {
            name: {k: t[k] for k in ("kernel_ms", "with_mask_ms", "library_ms",
                                     "kernel_over_library", "bound_ms", "bound_share")}
            for name, t in upflow_warp.items()},
        "shape": list(WARP_SHAPE),
        "card": smi,
    }, {
        # ms, bound and the other times are those of the call without an
        # image gradient (8 of the 10 calls of a RIFE-2D train step, `warp2d
        # layouts`); the call with it, and the cases where training runs it
        # (UPFlow's photometric warp and its four feature levels), beside them
        "name": "warp2d_bwd",
        "route": "cuda",
        "source": source,
        "replaces": "opticalflowscivis_tpu/ops/pallas/warp.py:274",
        "launches": train_launches["warp2d_bwd"],
        "launches_per_train_step": PER_CALL["ifnet_2d_train_step"]["warp2d_bwd"],
        "launches_per_upflow_train_step": PER_CALL["upflow_train_step"]["warp2d_bwd"],
        "max_abs_err": worst_bwd_f32,
        "ms": bwd["dflow_only"]["kernel_ms"],
        "plain_ms": bwd["dflow_only"]["plain_ms"],
        "bound_ms": bwd["dflow_only"]["bound_ms"],
        "bound_by": bwd["dflow_only"]["bound_by"],
        "library_ms": bwd["dflow_only"]["library_ms"],
        "with_dimg": {k: bwd["with_dimg"][k] for k in
                      ("kernel_ms", "call_device_ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms")},
        "cases": {tag: {k: t[k] for k in ("kernel_ms", "call_device_ms", "host_us_per_call",
                                          "bound_ms", "bound_share", "library_ms", "shape",
                                          "dtype", "flows", "dimg")}
                  for tag, t in bwd.items() if "flows" in t},
        "shape": list(TRAIN_SHAPE),
        "card": smi,
    }, {
        "name": "warp3d",
        "route": "cuda",
        "source": "opticalflowscivis_tpu_torch/csrc/warp3d.cu",
        "replaces": "opticalflowscivis_tpu/ops/warp.py:144",
        "launches": launches3d + train_launches3d["warp3d"],
        "launches_serving_path": launches3d,
        "launches_training_path": train_launches3d["warp3d"],
        "launches_per_forward": PER_CALL["ifnet_3d_forward"]["warp3d"],
        "launches_per_train_step": PER_CALL["ifnet_3d_train_step"]["warp3d"],
        "max_abs_err": worst3d["fwd"],
        "ms": warp3["kernel_ms"],
        "plain_ms": warp3["plain_ms"],
        "bound_ms": warp3["bound_ms"],
        "bound_by": warp3["bound_by"],
        "library_ms": warp3["library_ms"],
        "kernel_over_library": warp3["kernel_over_library"],
        "shape": list(VOLUME_SHAPE),
        "card": smi,
    }, {
        # as for warp2d_bwd: the call without an image gradient (all 8 calls of
        # a 3-D train step), the one with it beside it
        "name": "warp3d_bwd",
        "route": "cuda",
        "source": "opticalflowscivis_tpu_torch/csrc/warp3d.cu",
        "replaces": "opticalflowscivis_tpu/ops/warp.py:144",
        "launches": train_launches3d["warp3d_bwd"],
        "launches_per_train_step": PER_CALL["ifnet_3d_train_step"]["warp3d_bwd"],
        "max_abs_err": worst3d["bwd"],
        "ms": bwd3["dflow_only"]["kernel_ms"],
        "plain_ms": bwd3["dflow_only"]["plain_ms"],
        "bound_ms": bwd3["dflow_only"]["bound_ms"],
        "bound_by": bwd3["dflow_only"]["bound_by"],
        "library_ms": bwd3["dflow_only"]["library_ms"],
        "with_dimg": {k: bwd3["with_dimg"][k] for k in
                      ("kernel_ms", "call_device_ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms")},
        "cases": {tag: {k: t[k] for k in ("kernel_ms", "bound_ms", "bound_share", "shape",
                                          "dtype", "flows", "dimg")}
                  for tag, t in bwd3.items() if "flows" in t},
        "shape": list(VOLUME_SHAPE),
        "card": smi,
    }]
    corr_source = "opticalflowscivis_tpu_torch/csrc/corr.cu"
    corr_replaces = "opticalflowscivis_tpu/ops/pallas/correlation.py:126"
    for name, err, launches_n in (
            ("corr", worst_corr["fwd"], upflow_serving["corr"] + upflow_launches["corr"]),
            ("corr_bwd", worst_corr["bwd"], upflow_launches["corr_bwd"])):
        t = corr_times[f"{name}_float32"]
        kernels.append({
            # ms, bound and plain_ms in float32 at the finest level's shape; bf16 beside
            "name": name,
            "route": "cuda",
            "source": corr_source,
            "replaces": corr_replaces,
            "launches": launches_n,
            "launches_per_forward": PER_CALL["upflow_forward"].get(name, 0),
            "launches_per_train_step": PER_CALL["upflow_train_step"][name],
            "max_abs_err": err,
            "ms": t["kernel_ms"],
            "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "bfloat16": {k: corr_times[f"{name}_bfloat16"][k] for k in
                         ("kernel_ms", "call_ms", "plain_ms", "bound_ms", "bound_by")},
            "shape": list(CORR_SHAPES[-1]),
            "md": 4,
            "card": smi,
        })
    kernels[0]["launches"] += upflow_serving["warp2d"] + upflow_launches["warp2d"]
    kernels[0]["launches_upflow_paths"] = upflow_serving["warp2d"] + upflow_launches["warp2d"]
    kernels[1]["launches"] += upflow_launches["warp2d_bwd"]
    kernels[1]["launches_upflow_paths"] = upflow_launches["warp2d_bwd"]
    for k in kernels:
        k["bound_share"] = k["bound_ms"] / k["ms"]
    print(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
