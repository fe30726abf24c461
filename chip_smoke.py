#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times ROOT

Builds every Hopper kernel of the port from the sources in this checkout,
holds each kernel against its plain PyTorch version on the card, drives the
main paths at the full width of ``ifnet_2d`` (also with its Contextnet/Unet
refinement), ``ifnet_3d``, the pretrained RIFE zoo models and ``UPFlowNet``
and shows that each went through the kernels: interpolation serving
(``Interpolator``, ``interpolate_series``) and training (``Trainer.fit``, then
the CLI verbs generate → train → test → inference_video → select), on 2-D
frames and on 64^3 volumes, the ``train256`` module at 128^3, UPFlow flow
estimation (``UPFlowTrainer.predict``) and training (``UPFlowTrainer.fit``,
then ``train_upflow`` → ``test_upflow``) at 256 x 832, and UPFlow on KITTI-sized
frames: training from the device-resident frame store (``fit_kitti_hbm``) and
streamed (``fit_kitti``), and the Evaluation_bench (``evaluate_kitti``) at
384 x 1280; then training from the data sources beyond a fixed export: scenes
generated on the card (``fit_device_gen``, UPFlow and RIFE-3D), the Vimeo90K
stream (``fit_stream``) and the lattice-Boltzmann generator.  It compares each path with the same weights on the CPU or with
the plain kernels, and times them.

Phases, printed in order:
  1. card: ``nvidia-smi`` name and power limit, torch / CUDA versions, build time,
     each kernel's registers and spills (none allowed in ``corr_fwd_kernel``,
     ``corr_bwd_kernel``, ``warp3d_bwd_kernel`` (24 instances, 8 of them on
     a slab with its z offset) or ``warp2d_bwd_kernel``, each with its count
     of instances), and the warps' blocks per SM;
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
 4a. RIFE's Contextnet/Unet refinement: both 2-D kernels at the Contextnet
     levels of the serving and the training path (16-128 channels) and at the
     legacy zoo's context levels (32-256 channels), f32, bf16 features under
     an f32 flow and all bf16, the backward with ``dimg`` and its ``dflow``
     twice bit for bit; ``ifnet_2d(refine=True)`` at full width through
     ``Interpolator`` and ``interpolate_series`` (14 ``warp2d`` launches a
     forward), f32 and bf16, against the CPU; ``ifnet_3d(refine=True)`` (6
     ``warp3d`` launches: the context warps are the plain gather) against the
     CPU; ``Trainer.fit`` with refinement at batch 64 on 128^2 in f32 and
     bf16 (18 + 18 launches a train step, 10 of the backward calls with
     ``dimg``; 18 + 0 an eval step), checkpoint round trip with ``contextnet``
     and ``unet``, a train step against the CPU in 2-D and 3-D; refine
     forward pairs/s beside the plain model's, the refine train step's time,
     device time and ``warp2d_bwd`` share (``refine times``);
 4b. (run last, after phase 9a) the pretrained zoo: random HDv3 (c = 90),
     HD v1 and v2 (cs = (192, 128, 96, 48), c_fusion = 32) checkpoints in the
     upstream layout through ``load_pretrained_zoo`` and
     ``ZooInterpolator.pair`` on a 1080 x 1920 RGB pair (6 / 16 / 16
     ``warp2d`` launches), each against the CPU at 270 x 480, ms per
     1088 x 1920 pair with cuDNN's heuristics and autotuned, and a profile
     (``zoo times``), ``inference_img --zoo_dir`` and ``inference_video
     --zoo_dir``; ``vgg_perceptual_loss`` forward and backward at
     [8, 224, 224, 3] against the CPU in float64 and float32;
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
  9. KITTI multiview at full width (bf16, crop 256 x 832, batch 8): a frame
     store of 210 frames at 375 x 1242 from ``KittiHBMCache.from_frames``,
     the first batch cut on the card against numpy, ``fit_kitti_hbm`` for 16
     steps (5 ``corr`` / ``corr_bwd``, 6 ``warp2d``, 4 ``warp2d_bwd`` a step)
     and a second call on the same store, ``fit_kitti`` through a
     ``PrefetchSampler``, ``evaluate_kitti`` on 4 pairs against the plain
     kernels' report (bf16 and float32), the share of
     ``boundary_dilated_warp``, and ``corr``, ``corr_bwd`` and the masked
     ``warp2d`` at the five 384 x 1280 evaluation levels;
 9a. the data sources beyond a fixed export: ``box_density_device`` at 256^3,
     ``pan_pairs_device`` and ``multibox_pan_pairs_device`` at 128 x 128 on the
     card against the numpy generators, bit for bit;
     ``UPFlowTrainer.fit_device_gen`` at full width on generated 128 x 128
     pairs, batch 8, pan and multibox, f32 and bf16 (5 / 5 / 8 / 6 launches a
     step, a fresh scene each epoch, ``val_epe``, a resumed call that goes on
     with the epoch seeds and the step count, as many host-to-device copies a
     step as a step on pairs already on the card, a generator that never
     makes the host wait), its step beside ``fit``'s on the same pairs
     uploaded (``upflow device_gen times``), ``train_upflow
     --device_gen 64`` and ``test_upflow``; ``Trainer.fit_device_gen`` with
     ``box_density_device`` at [4, 64, 64, 64] (8 + 8 a step) and ``train256
     --device_gen`` at 256^3 as its own process; ``train --dataset vimeo2d``
     at the CLI's defaults on a written Vimeo-layout tree, ``fit_stream`` (10
     + 10 a step) and the host's sampling share of a streamed step (``vimeo
     times``); ``lattice_boltzmann_2d`` on the card against the CPU at
     400 x 100, ``generate --dataset lbs2d`` (33 000 steps) and 3000 steps of
     the vortex sets' simulation, timed (``lbs times``);
 9b. data parallelism, the sharded warp, the evaluation protocols, fastprep:
     ``scripts/dryrun_dp.py`` at full width (RIFE-2D ``fit`` at batch 64 on
     128 x 128, UPFlow ``fit`` at 256 x 832 batch 8, float32, cuDNN
     deterministic) as the plain trainers in this process, one NCCL rank
     under torchrun and two gloo ranks sharing the card: each step against
     the plain one (bit for bit, or within ``TRAIN_PARTS_TOL`` /
     ``TRAIN_GRAD_TOL``), ``loss.json``, the checkpoint's format, the launches
     a step, the step's time (``data parallel``);
     ``backward_warp3d_sharded`` at [1, 1, 256, 256, 256] r_z 8 over two gloo
     ranks (``scripts/sharded_warp.py``), border and zeros, forward and
     backward against ``warp3d`` on the whole volume, a rank's event times
     of the halo exchange and the sharded call (through the host) beside the
     unsharded call's (``sharded warp``), then the ``*_offset`` instances'
     device times on the haloed shard beside the instances without the
     offset, ``F.grid_sample``, the plain version and the bound
     (``sharded warp kernels on the haloed shard``);
     the evaluation protocols with RGB ``ifnet_2d`` (``bench_latency`` at
     480 x 640, ``bench_hd_yuv`` on a written 1080p sequence, ``multi`` 1 and
     2, ``bench_triplet_dirs``, ``bench_vimeo90k`` and ``bench_middlebury`` on
     written trees) against the same protocols with the plain kernels
     (``eval protocols``); ``fastprep`` on ``rectangle2d``'s train split bit
     for bit against numpy, both timed on the host (``fastprep (host)``);
 10. times (CUDA events, warm-up, inputs that vary from call to call) and
     profiles of all paths; each forward warp kernel against ``F.grid_sample``
     in turns (the median of 5 profiler windows of 40 calls each), also at
     UPFlow's finest feature warp; the 2-D backward where training runs it
     (``warp2d_bwd cases``: RIFE-2D's shape on iid and smooth flows, f32 and
     bf16, with ``dimg``; UPFlow's photometric warp and its four feature levels
     with ``dimg``, f32 and bf16 features), each with the call's device time,
     the host's µs per call, its bound and autograd through ``F.grid_sample``;
     the 3-D backward on iid and smooth flows, f32 and bf16, at 64^3 and
     256^3 (``warp3d_bwd cases``);
 11. one ``{"kernels": [...]}`` line.
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
def cudnn_benchmark(torch):
    """cuDNN choosing each convolution's algorithm by timing the candidates on
    its first call (``torch.backends.cudnn.benchmark``) instead of by its
    heuristics."""
    before = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = before


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
    # the optional modules the readers (cv2) and the panels (matplotlib) need
    found = {}
    for name in ("cv2", "matplotlib", "PIL"):
        try:
            found[name] = getattr(__import__(name), "__version__", "present")
        except ImportError:
            found[name] = None
    print("host modules " + json.dumps(found))
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
    # border or zeros padding; those with dimg also on a slab with its z
    # offset (the sharded warp's)
    bwd3 = {k: v for k, v in ptxas.items() if k.startswith("warp3d_bwd_kernel")}
    check(len(bwd3) == 24 and all(v.get("spill_stores") == 0 for v in bwd3.values()),
          f"warp3d_bwd_kernel's 24 instances should build without spills: {bwd3}")
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


def upflow_warp_case(torch, shape, padding: str, dtype, cl: bool, seed: int) -> float:
    """UPFlow's warp (unbounded, a float32 flow) at ``shape`` [B, H, W, C]
    against ``warp2d_plain``, and its fused validity mask bit for bit against
    the warp of ones; returns the largest error."""
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
    from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d, warp2d_with_mask
    from opticalflowscivis_tpu_torch.ops.warp import warp2d_plain

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
    return err


def phase_kernel_vs_plain(torch):
    from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d
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
                    err = upflow_warp_case(torch, shape, padding, dtype, cl, seed)
                    if dtype == torch.float32:
                        worst_f32 = max(worst_f32, err)
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


def profile_forward(torch, name: str, fn, iters: int = 3, unit: str = "forward") -> dict:
    """Device time by kernel over ``iters`` forwards (or train steps), and the
    busy share of the window's wall time (torch.profiler, CUPTI); printed and
    returned."""
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

    record = {
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
    }
    print("profile " + json.dumps(record))
    return record


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
    """generate → train (1 epoch) → test → inference_video → select (the linear
    baseline, then the checkpoint), in process, on the card."""
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
    # time-step selection: the linear baseline, then through the checkpoint
    selections = {}
    for flag in ("--linear", None):
        cli(["select", "--dataset", "rectangle2d", "--factor", "2", "--factors", "2,4,8",
             *([flag] if flag else []), *dirs])
        with open(os.path.join(tmp, "cli_r", "selection_rectangle2d.json")) as f:
            selections[flag or "model"] = json.load(f)
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
    for name, sel in selections.items():
        print(f"cli select {name}: selected {sel['n_selected']} of the interpolated frames, "
              f"threshold {sel['psnr_threshold']} dB, curve {json.dumps(sel['curve'])}")
        check(isinstance(sel["selected_timesteps"], list)
              and all(t % 2 == 1 for t in sel["selected_timesteps"])
              and set(sel["curve"]) <= {"2", "4", "8"} and "2" in sel["curve"],
              f"cli select {name} report")
    delta = {k: LAUNCHES[k] - before[k] for k in ("warp2d", "warp2d_bwd")}
    print(f"cli: generate, train, test, inference_video, select ok; launches={delta}")
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

    def record(img, flow, grad_out, r_z, r_yx, padding, need_dimg, z_offset=0):
        seen[name].append({
            "shape": list(img.shape), "dtype": str(img.dtype).replace("torch.", ""),
            "flow_strides": list(flow.stride()), "grad_strides": list(grad_out.stride()),
            "rows": [rows(flow), rows(grad_out)], "need_dimg": bool(need_dimg),
            "radii": [r_z, r_yx], "padding": padding})
        return original(img, flow, grad_out, r_z, r_yx, padding, need_dimg, z_offset)

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


def corr_case(torch, shape, md: int, dtype, cl: bool, seed: int, needs_all: bool,
              worst: dict) -> None:
    """``corr`` against ``cost_volume_plain`` and ``corr_bwd`` against autograd
    through it on one case (``needs_all``: also with each gradient alone), at
    the tolerances of ``PERF.md`` §2; the worst errors go into ``worst``."""
    from opticalflowscivis_tpu_torch.ops.correlation import cost_volume_plain
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
    from opticalflowscivis_tpu_torch.ops.kernels.correlation import cost_volume_kernel

    def grads(fn, f1, f2, g, md, needs):
        a = f1.detach().clone(memory_format=torch.preserve_format).requires_grad_(needs != "f2")
        b = f2.detach().clone(memory_format=torch.preserve_format).requires_grad_(needs != "f1")
        fn(a, b, md).backward(g)
        return a.grad, b.grad

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
    for needs in (("both", "f1", "f2") if needs_all else ("both",)):
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


def phase_corr_vs_plain(torch):
    """``corr`` against ``cost_volume_plain`` and ``corr_bwd`` against autograd
    through it: the five model shapes and an odd one, md 4 and 2 (the odd shape
    also md 1 and 3: every md the kernels are built for), f32 and bf16,
    contiguous and channels-last; the odd shape, and two on the backward
    tile's edges (at md 1 and 3, and at md 4 with rows of a multiple of 4),
    also with each gradient alone.  Then channel
    slices of wider maps, two runs of each kernel bit for bit, and the
    launch geometries against ``forward_launch`` and ``backward_launch``."""
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
    from opticalflowscivis_tpu_torch.ops.kernels.correlation import cost_volume_kernel

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
                    corr_case(torch, shape, md, dtype, cl, seed, odd, worst)
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


# KITTI multiview: 10 sequences of 21 frames at KITTI's 375 x 1242 (210
# frames, 200 pairs, 0.59 GB in bf16), cut from the CLI's default of 1000
# pairs (--hbm_cache) to keep this phase within the script's time
KITTI_FRAME_HW = (375, 1242)
KITTI_SEQUENCES, KITTI_FRAMES = 10, 21
KITTI_SHIFT = (3, -5)  # px a frame; the forward flow of every pair
KITTI_CROP, KITTI_RHO = (256, 832), 8
KITTI_STEPS = 16
KITTI_EVAL_PAIRS = 4
# the Evaluation_bench pads KITTI-2015's frames to 384 x 1280 at batch 1: the
# five cost volumes [B, C, H, W] (both directions stacked, coarsest first) and
# the feature warps [B, H, W, C] of the same levels
KITTI_EVAL_CORR = ((2, 196, 6, 20), (2, 128, 12, 40), (2, 96, 24, 80), (2, 64, 48, 160),
                   (2, 32, 96, 320))
KITTI_EVAL_WARPS = tuple((b, h, w, c) for b, c, h, w in KITTI_EVAL_CORR)
# kernels' report against the plain versions' on the same trainer: float32
# as the CPU comparisons (CPU_TOL of the larger of 1 and the score); bf16
# features at the bf16 model's mean-flow bound
KITTI_REPORT_TOL = {"float32": CPU_TOL, "bfloat16": UPFLOW_BF16_FLOW_MEAN_TOL}


def kitti_frames(torch, seed: int):
    """``(frames, raw)``: ``[S * T, H, W, 3]`` float32 frames normalized as
    KITTI training wants them (``kitti_photometric_normalize``), and the first
    sequence in [0, 1].  Each sequence is a smooth multi-octave texture (noise
    on grids of 8, 32 and 128 px, upsampled) seen through a window that moves
    by ``KITTI_SHIFT`` a frame: frame t+1 at p is frame t at p - shift."""
    import torch.nn.functional as F

    from opticalflowscivis_tpu_torch.data import kitti_photometric_normalize

    h, w = KITTI_FRAME_HW
    n, t = KITTI_SEQUENCES, KITTI_FRAMES
    dy, dx = KITTI_SHIFT
    big = (h + abs(dy) * (t - 1), w + abs(dx) * (t - 1))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tex = torch.zeros((n, 3) + big, device="cuda")
    for cell, amp in ((8, 0.125), (32, 0.25), (128, 0.5)):
        coarse = torch.rand((n, 3, big[0] // cell + 2, big[1] // cell + 2), generator=gen,
                            device="cuda")
        tex += amp * F.interpolate(coarse, size=big, mode="bicubic", align_corners=True)
    tex = (tex / 0.875).clamp(0, 1)
    oy, ox = max(dy, 0) * (t - 1), max(dx, 0) * (t - 1)
    seq = torch.stack([tex[:, :, oy - dy * f : oy - dy * f + h, ox - dx * f : ox - dx * f + w]
                       for f in range(t)], dim=1)  # [n, t, 3, h, w]
    raw = seq.permute(0, 1, 3, 4, 2).reshape(n * t, h, w, 3).cpu().numpy()
    return kitti_photometric_normalize(raw), raw[:t]


def kitti_eval_samples(raw):
    """``KITTI_EVAL_PAIRS`` samples as ``load_kitti_eval_pairs`` yields them:
    consecutive frames in [0, 1] with their known flow, valid everywhere in
    ``flow_occ`` and, in ``flow_noc``, where the shift stays in the frame."""
    h, w = KITTI_FRAME_HW
    dy, dx = KITTI_SHIFT
    flow = np.broadcast_to(np.asarray(KITTI_SHIFT, np.float32), (h, w, 2)).copy()
    ys, xs = np.mgrid[0:h, 0:w]
    noc = ((ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w))
    noc = noc[..., None].astype(np.float32)
    occ = np.ones((h, w, 1), np.float32)
    return [(f"{i:06d}", raw[i], raw[i + 1], flow, occ, flow * noc, noc)
            for i in range(KITTI_EVAL_PAIRS)]


def numpy_kitti_batch(frames, pid, offs, flip, swap, crop, rho) -> dict:
    """A KITTI training batch cut in numpy from ``frames`` (indexable by frame
    number, each ``[H, W, 3]``) as ``KittiPairDataset.sample`` cuts it: the
    raw window around each crop, flipped, the frames swapped."""
    ch, cw = crop
    out = {k: [] for k in ("im1", "im2", "im1_raw", "im2_raw")}
    for (a, b), (y0, x0), fl, sw in zip(pid, offs, flip, swap):
        r1, r2 = (frames[int(i)][y0 - rho : y0 + ch + rho, x0 - rho : x0 + cw + rho]
                  for i in (a, b))
        if fl:
            r1, r2 = r1[:, ::-1], r2[:, ::-1]
        if sw:
            r1, r2 = r2, r1
        for k, r in (("1", r1), ("2", r2)):
            out[f"im{k}_raw"].append(r)
            out[f"im{k}"].append(r[rho : rho + ch, rho : rho + cw])
    batch = {k: np.stack(v).astype(np.float32) for k, v in out.items()}
    batch["start"] = np.full((len(pid), 2), float(rho), np.float32)
    return batch


class StoreSampler:
    """``sample(batch)`` over a ``KittiHBMCache``'s host frames, the draws of
    ``KittiHBMCache.draw`` cut as ``KittiPairDataset`` cuts them: the
    streamed path's dataset without PNG files."""

    def __init__(self, cache, seed: int):
        self.cache, self.rng = cache, np.random.default_rng(seed)

    def sample(self, batch: int) -> dict:
        c = self.cache
        return numpy_kitti_batch(c.frames, *c.draw(self.rng, batch), c.crop, c.rho)


@contextlib.contextmanager
def plain_kernels(torch):
    """The UPFlow model's and losses' kernel wrappers replaced by their plain
    PyTorch versions (``cost_volume_plain``, ``warp2d_plain`` and its mask as
    the warp of ones), for a report to hold the kernels' against."""
    from opticalflowscivis_tpu_torch.models import upflow as upflow_model
    from opticalflowscivis_tpu_torch.ops.correlation import cost_volume_plain
    from opticalflowscivis_tpu_torch.ops.kernels import warp as kernel_warp
    from opticalflowscivis_tpu_torch.ops.warp import warp2d_plain

    def with_mask(img, flow, padding="zeros"):
        ones = torch.ones((img.shape[0], 1) + tuple(img.shape[2:]), dtype=img.dtype,
                          device=img.device)
        return warp2d_plain(img, flow, 0, padding), warp2d_plain(ones, flow, 0, "zeros")

    swaps = [(upflow_model, "cost_volume_kernel", cost_volume_plain),
             (upflow_model, "warp2d", warp2d_plain), (upflow_model, "warp2d_with_mask", with_mask),
             (kernel_warp, "warp2d", warp2d_plain), (kernel_warp, "warp2d_with_mask", with_mask)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def kitti_reports_agree(torch, tr, samples, what: str) -> dict:
    """``evaluate_kitti`` of ``tr`` through the kernels, and again through
    their plain versions (no launch), each score within ``KITTI_REPORT_TOL``
    of the larger of 1 and the plain report's."""
    from opticalflowscivis_tpu_torch.cli.__main__ import evaluate_kitti
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES

    dtype = "bfloat16" if tr.cfg.bfloat16 else "float32"
    with deterministic_cudnn(torch):
        got = evaluate_kitti(tr, samples)
        before = dict(LAUNCHES)
        with plain_kernels(torch):
            want = evaluate_kitti(tr, samples)
        check(dict(LAUNCHES) == before, "the plain versions launched a kernel")
    tol = KITTI_REPORT_TOL[dtype]
    worst = max(abs(got[k] - want[k]) / max(1.0, abs(want[k])) for k in want)
    print(f"kitti eval {what} {dtype}: kernels {json.dumps(got)} plain {json.dumps(want)} "
          f"worst rel diff {worst:.3e} tol={tol:g}")
    check(set(got) == set(want) and all(math.isfinite(v) for v in got.values()),
          f"kitti eval {what}: report not finite")
    check(worst <= tol, f"kitti eval {what} {dtype}: the kernels' report disagrees")
    return got


def kitti_eval_kernels(torch) -> dict:
    """``corr`` and ``corr_bwd`` at the five cost volumes of a 384 x 1280
    evaluation pair and the masked ``warp2d`` at the same levels, f32 and
    bf16, against their plain versions at ``PERF.md`` §2's tolerances."""
    worst = {"fwd": 0.0, "bwd": 0.0, "bwd_bf16_rel": 0.0, "fwd_cases": 0, "bwd_cases": 0}
    warp_worst = 0.0
    seed = 1200
    for corr_shape, warp_shape in zip(KITTI_EVAL_CORR, KITTI_EVAL_WARPS):
        for dtype in (torch.float32, torch.bfloat16):
            seed += 1
            corr_case(torch, corr_shape, 4, dtype, False, seed, True, worst)
            for padding in ("zeros", "border"):
                err = upflow_warp_case(torch, warp_shape, padding, dtype, False, seed)
                if dtype == torch.float32:
                    warp_worst = max(warp_worst, err)
    out = {"corr": worst["fwd"], "corr_bwd": worst["bwd"],
           "corr_bwd_bf16_rel": worst["bwd_bf16_rel"], "warp2d": warp_worst}
    print("kitti eval kernels vs plain " + json.dumps(out))
    return out


def phase_kitti(torch, tmp: str):
    """KITTI multiview at full width (``UPFlowTrainConfig()``, bf16, crop
    256 x 832, batch 8): the frame store from ``KittiHBMCache.from_frames``,
    the first batch cut on the card against numpy, ``fit_kitti_hbm`` for
    ``KITTI_STEPS`` steps and a second call on the same store, ``fit_kitti``
    through a ``PrefetchSampler``, ``evaluate_kitti`` against the plain
    kernels' report, and the kernels at the 384 x 1280 evaluation levels."""
    from opticalflowscivis_tpu_torch.cli.__main__ import evaluate_kitti
    from opticalflowscivis_tpu_torch.data import KittiHBMCache, PrefetchSampler, device_batch
    from opticalflowscivis_tpu_torch.ops import warp as ops_warp
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from opticalflowscivis_tpu_torch.training import UPFlowTrainer

    t0 = time.perf_counter()
    frames, raw = kitti_frames(torch, seed=12)
    n, t = KITTI_SEQUENCES, KITTI_FRAMES
    pairs = [(s * t + f, s * t + f + 1) for s in range(n) for f in range(t - 1)]
    cache = KittiHBMCache.from_frames(frames, pairs, crop=KITTI_CROP, rho=KITTI_RHO)
    del frames
    samples = kitti_eval_samples(raw)
    print(f"kitti frames: {cache.frames.shape} {len(cache)} pairs, built in "
          f"{time.perf_counter() - t0:.1f} s")
    check(cache.frames.shape == (n * t,) + KITTI_FRAME_HW + (3,) and len(cache) == n * (t - 1),
          "kitti cache shape")

    cfg = upflow_config(tmp, "kitti", True)
    check(cfg.batch_size == 8 and cfg.bfloat16, "kitti: UPFlowTrainConfig's defaults")
    tr = UPFlowTrainer(cfg)
    tr.init_state()
    h2d0 = time.perf_counter()
    store = tr.kitti_store(cache)
    torch.cuda.synchronize()
    store_bytes = store.numel() * store.element_size()
    print(f"kitti store: {list(store.shape)} {store.dtype} {store_bytes / 1e9:.3f} GB, "
          f"uploaded in {time.perf_counter() - h2d0:.2f} s")
    check(store.dtype == torch.bfloat16 and tuple(store.shape) == cache.frames.shape,
          "kitti store type")

    # the first batch fit_kitti_hbm draws, cut on the card, against numpy crops
    # of the same store's frames
    drawn = cache.draw(np.random.default_rng(cfg.seed + 2), cfg.batch_size)
    got = device_batch(store, *(torch.from_numpy(np.asarray(a)) for a in drawn),
                       cache.crop, cache.rho)
    used = {int(i): store[int(i)].float().cpu().numpy() for i in np.unique(drawn[0])}
    want = numpy_kitti_batch(used, *drawn, cache.crop, cache.rho)
    for k, v in want.items():
        check(got[k].dtype == torch.float32 and np.array_equal(got[k].cpu().numpy(), v),
              f"kitti: the batch cut on the card differs from numpy's ({k})")
    print(f"kitti first batch: pid {drawn[0].tolist()} offs {drawn[1].tolist()} flip "
          f"{drawn[2].astype(int).tolist()} swap {drawn[3].astype(int).tolist()}: equal to numpy")

    zero_epe = float(np.mean([np.linalg.norm(s[3], axis=-1).mean() for s in samples]))
    with deterministic_cudnn(torch):
        before_fit = evaluate_kitti(tr, samples)

    # the main path: fit_kitti_hbm from the store
    keys = ("corr", "corr_bwd", "warp2d", "warp2d_bwd")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the KITTI training path's run starts here
    spe = KITTI_STEPS // 2
    hist = tr.fit_kitti_hbm(cache, spe, epochs=2, log_every=spe)
    torch.cuda.synchronize()
    counts = {k: LAUNCHES[k] for k in keys}  # read just after the run
    peak = torch.cuda.max_memory_allocated()
    print(f"kitti fit_kitti_hbm: {KITTI_STEPS} steps launches={counts} loss_total "
          f"{hist[0]['loss_total']:.5f} -> {hist[-1]['loss_total']:.5f} peak memory "
          f"{peak / 1e9:.2f} GB")
    check(tr.state.step == KITTI_STEPS and len(hist) == 2
          and all(math.isfinite(v) for parts in hist for v in parts.values()),
          "kitti fit_kitti_hbm losses")
    check(all(counts[k] > 0 for k in keys), "the KITTI training path missed a kernel")
    check(all(counts[k] % KITTI_STEPS == 0 for k in keys), f"kitti launches {counts}")
    per_step = {k: v // KITTI_STEPS for k, v in counts.items()}
    ptr = store.data_ptr()
    again = tr.fit_kitti_hbm(cache, 1, epochs=1, log_every=0)
    check(tr.kitti_store(cache).data_ptr() == ptr and math.isfinite(again[0]["loss_total"]),
          "kitti: a second fit_kitti_hbm call uploaded the store again")
    with open(os.path.join(cfg.exp_dir, "loss.json")) as f:
        check(len(json.load(f)["loss"]) == 3, "kitti loss.json")
    check(os.path.isfile(tr.checkpoint_path()), "kitti checkpoint")

    # one step's launches, and its time from the store (the batch cut included)
    rng = np.random.default_rng(99)

    def kitti_step(i):
        drawn = [torch.from_numpy(np.asarray(a)) for a in cache.draw(rng, cfg.batch_size)]
        return tr.train_step(device_batch(store, *drawn, cache.crop, cache.rho))

    before = dict(LAUNCHES)
    kitti_step(0)
    torch.cuda.synchronize()
    step_delta = launch_delta(before)
    PER_CALL["kitti_train_step"] = step_delta
    # the photometric term's two warps are boundary_dilated_warp's plain
    # gathers: the 4 feature warps (with their gradient) and the occlusion
    # check's 2 are the kernels'
    print(f"kitti train step launches {step_delta}")
    check(step_delta == per_step == {"corr": 5, "corr_bwd": 5, "warp2d": 6, "warp2d_bwd": 4},
          f"kitti step launches {step_delta}, per step of the run {per_step}")
    step_ms, step_host_ms = cuda_and_host_ms(kitti_step, iters=8)
    profile_forward(torch, "upflow_kitti_train_bf16", kitti_step, iters=2, unit="train_step")
    step_device_ms = device_ms(kitti_step, 2)

    # boundary_dilated_warp's forward and backward at the step's shapes, as
    # the photometric term calls it twice a step: its device time over the
    # step's
    b = cfg.batch_size
    ch, cw = KITTI_CROP
    batch = device_batch(store, *(torch.from_numpy(np.asarray(a)) for a in cache.draw(rng, b)),
                         cache.crop, cache.rho)
    flows = [(torch.randn((b, ch, cw, 2), device="cuda") * 4).requires_grad_(True)
             for _ in range(2)]
    grad = torch.randn((b, ch, cw, 3), device="cuda")

    def photometric_warps(i):
        for raw_img, fl in zip((batch["im2_raw"], batch["im1_raw"]), flows):
            ops_warp.boundary_dilated_warp(raw_img, fl, batch["start"]).backward(grad)

    bdw_ms = device_ms(photometric_warps, 5)
    times = {
        "kitti_train_step_ms": step_ms, "kitti_train_step_host_ms": step_host_ms,
        "kitti_train_pairs_per_sec": b * 1e3 / step_ms,
        "kitti_train_step_device_ms": step_device_ms,
        "boundary_dilated_warp_device_ms_per_step": bdw_ms,
        "boundary_dilated_warp_share": bdw_ms / step_device_ms,
        "store_bytes": store_bytes, "peak_memory_bytes": peak,
    }

    # the streamed path: fit_kitti through two prefetch threads
    sampler = PrefetchSampler(batch_size=b, workers=2, depth=2,
                              make_dataset=lambda w: StoreSampler(cache, seed=50 + w))
    try:
        before = dict(LAUNCHES)
        hist = tr.fit_kitti(sampler, 2, epochs=1, log_every=0)
        torch.cuda.synchronize()
        streamed = launch_delta(before)
    finally:
        sampler.close()
    print(f"kitti fit_kitti: 2 streamed steps launches={streamed} "
          f"loss_total {hist[0]['loss_total']:.5f}")
    check(math.isfinite(hist[0]["loss_total"]) and streamed == {k: 2 * v for k, v in
                                                                per_step.items()},
          f"kitti fit_kitti launches {streamed}")

    # the Evaluation_bench on 4 pairs at 375 x 1242 (padded to 384 x 1280)
    after = kitti_reports_agree(torch, tr, samples, "after training")
    f32 = UPFlowTrainer(upflow_config(tmp, "kitti_f32", False))
    f32.init_state()
    f32.net.load_state_dict(tr.net.state_dict())
    kitti_reports_agree(torch, f32, samples, "after training")
    print(f"kitti eval epe_all before {before_fit['epe_all']:.4f} after {after['epe_all']:.4f} "
          f"(zero flow {zero_epe:.4f}; information, no bound)")
    one = np.stack([samples[0][1], samples[0][2]])[None]
    eval_ms = cuda_ms(lambda i: tr.predict(one), iters=8)
    t1 = time.perf_counter()
    evaluate_kitti(tr, samples)
    times["kitti_eval_pair_ms"] = eval_ms
    times["kitti_eval_pair_host_ms"] = (time.perf_counter() - t1) * 1e3 / len(samples)
    times["kitti_eval_epe_before"] = before_fit["epe_all"]
    times["kitti_eval_epe_after"] = after["epe_all"]
    times["kitti_eval_epe_zero_flow"] = zero_epe
    print("kitti times " + json.dumps(times))
    eval_kernels = kitti_eval_kernels(torch)
    return counts, eval_kernels, times


DEVICE_GEN_HW = (128, 128)  # the CLI's device-gen grid (UPFlow) and its pan box
DEVICE_GEN_BOX = (60, 80)
DEVICE_GEN_BOXES = ((40, 50), (30, 25), (20, 35))  # rectangles_2d's defaults
DEVICE_GEN_EPOCHS, DEVICE_GEN_STEPS = 3, 2  # UPFlow fit_device_gen: epochs x steps
GRID_256 = (256, 256, 256)
VIMEO_HW = (256, 448)  # Vimeo90K's frames, [H, W]
VIMEO_STEPS = 4
LBS_STEPS_CPU = 200  # card against CPU at 400 x 100: steps of the short run
LBS_TOL = 1e-4  # of every channel (density normalised to [0, 1], |u| <= 0.4): the
#   sums over the nine populations run in other orders on each device; the CPU
#   port against the JAX package measured 3.6e-6 after 200 steps
LBS_TIMED_STEPS = 3000  # steps of vortex2d / vortex2d_fast's simulation timed here


def count_htod(torch, fn, iters: int = 2) -> int:
    """Host-to-device copies in a profiler window of ``iters`` calls of ``fn(i)``."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages() if "Memcpy HtoD" in ev.key)


def synchronizing_calls(torch, fn) -> int:
    """Calls in ``fn(0)`` that make the host wait for the card, as torch's
    sync debug mode reports them (a prototype: it does not see every kind)."""
    import warnings

    fn(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn(0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing" in str(w.message) for w in caught)


def phase_generators(torch):
    """The device generators on the card against the numpy generators, bit
    for bit: ``box_density_device`` at 256^3, ``pan_pairs_device`` and
    ``multibox_pan_pairs_device`` at 128 x 128 with 3 channels."""
    from opticalflowscivis_tpu_torch.data import device_synthetic as ds
    from opticalflowscivis_tpu_torch.data import (
        group_tuples,
        rectangle_2d,
        rectangle_3d,
        rectangles_2d,
    )

    box3 = tuple(g // 4 for g in GRID_256)
    pos = ds.tuple_positions(np.random.default_rng(21), 2, GRID_256, box3)
    got = ds.box_density_device(torch.from_numpy(pos).cuda(), GRID_256, box3)
    want = group_tuples(rectangle_3d(n_frames=6, grid=GRID_256, box=box3, seed=21,
                                     with_flow=False), 1)
    check(torch.equal(got, torch.from_numpy(want).cuda()),
          "box_density_device differs from rectangle_3d at 256^3")
    n = 9
    hw, box, boxes = DEVICE_GEN_HW, DEVICE_GEN_BOX, DEVICE_GEN_BOXES
    tex, big, bt, ct = ds.pan_scene_host(np.random.default_rng(22), n, hw, box)
    bp, cp = ds.pan_pair_positions(bt, ct, np.arange(n - 1))
    pan = ds.pan_pairs_device(*(torch.from_numpy(a).cuda() for a in (tex, big, bp, cp)), hw, 3)
    ref = rectangle_2d(n_frames=n, grid=hw, box=box, seed=22, background="pan")
    texs, big, bts, ct = ds.multibox_pan_scene_host(np.random.default_rng(23), n, hw, boxes)
    bp, cp = ds.multibox_pan_pair_positions(bts, ct, np.arange(n - 1))
    multi = ds.multibox_pan_pairs_device([torch.from_numpy(t).cuda() for t in texs],
                                         *(torch.from_numpy(a).cuda() for a in (big, bp, cp)),
                                         hw, 3)
    ref_multi = rectangles_2d(n_frames=n, grid=hw, boxes=boxes, seed=23, background="pan",
                              pan_vel_max=8)
    for name, (im1, im2, flow), arr in (("pan", pan, ref), ("multibox", multi, ref_multi)):
        frames = np.repeat(arr[..., :1], 3, axis=-1)
        check(all(np.array_equal(a.cpu().numpy(), b) for a, b in
                  ((im1, frames[:-1]), (im2, frames[1:]), (flow, arr[:-1, ..., 1:]))),
              f"{name}_pairs_device differs from the numpy generator")
    print(f"generators on the card: box_density_device [2,3,256,256,256,1], pan_pairs_device "
          f"and multibox_pan_pairs_device [{n - 1},{hw[0]},{hw[1]},3] equal the numpy "
          "generators bit for bit")


def pan_device_gen(multibox: bool, n: int, record: list):
    """``(gen_fn, pos_sampler)`` of ``train_upflow --device_gen n`` at batch
    ``n`` on ``rectangle2d_tex_pan`` (or, with ``multibox``,
    ``rectangles2d_tex_pan8``): a fresh 128 x 128 scene every epoch;
    ``record`` collects the epochs sampled and their box positions."""
    from opticalflowscivis_tpu_torch.cli.__main__ import _pan_device_gen
    from opticalflowscivis_tpu_torch.data import get_spec

    spec = get_spec("rectangles2d_tex_pan8" if multibox else "rectangle2d_tex_pan")
    gen_fn, sampler, _ = _pan_device_gen(spec, n, n)

    def pos_sampler(epoch):
        const, pos = sampler(epoch)
        record.append((epoch, pos["box"]))
        return const, pos

    return gen_fn, pos_sampler


def phase_upflow_device_gen(torch, tmp: str):
    """``UPFlowTrainer.fit_device_gen`` at ``UPFlowTrainConfig()``'s full
    width on generated 128 x 128 pairs, batch 8, pan and multibox, f32 and
    bf16: launches, no frame crossing from the host, a fresh scene each epoch,
    ``val_epe``, a resumed call; its step beside ``fit``'s on the same pairs
    uploaded; then ``train_upflow --device_gen 64`` and ``test_upflow``."""
    from opticalflowscivis_tpu_torch.cli.__main__ import main as cli
    from opticalflowscivis_tpu_torch.data import rectangle_2d
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from opticalflowscivis_tpu_torch.training import UPFlowTrainer, frames_to_pairs

    b, spe, epochs = UPFLOW_BATCH, DEVICE_GEN_STEPS, DEVICE_GEN_EPOCHS
    val = rectangle_2d(n_frames=b + 1, grid=DEVICE_GEN_HW, box=DEVICE_GEN_BOX, seed=24,
                       background="pan")
    val_pairs, val_flow = frames_to_pairs(val[..., :1], in_channels=3), val[:-1, ..., 1:]
    keys = ("corr", "corr_bwd", "warp2d", "warp2d_bwd")
    launches = dict.fromkeys(keys, 0)
    per_step = PER_CALL["upflow_train_step"]
    times = {}
    for multibox in (False, True):
        for bf16 in (False, True):
            name = f"{'multibox' if multibox else 'pan'}_{'bf16' if bf16 else 'f32'}"
            cfg = upflow_config(tmp, f"gen_{name}", bf16)
            record = []
            gen_fn, pos_sampler = pan_device_gen(multibox, spe * b, record)
            tr = UPFlowTrainer(cfg)
            reset_launches()  # this device-gen path's run starts here
            hist = tr.fit_device_gen(gen_fn, pos_sampler, spe, epochs=epochs, log_every=0,
                                     val_pairs=val_pairs, val_flow=val_flow)
            torch.cuda.synchronize()
            counts = {k: LAUNCHES[k] for k in keys}  # read just after the run
            steps = epochs * spe
            # a validation: the model alone on 8 pairs, 5 cost volumes and 4 warps
            expect = {k: per_step.get(k, 0) * steps for k in keys}
            expect["corr"] += 5 * epochs
            expect["warp2d"] += 4 * epochs
            print(f"upflow device_gen {name}: {steps} steps at [{b},{DEVICE_GEN_HW[0]},"
                  f"{DEVICE_GEN_HW[1]},3] launches={counts} loss_total {hist[0]['loss_total']:.5f}"
                  f" -> {hist[-1]['loss_total']:.5f} val_epe {hist[0]['val_epe']:.4f} -> "
                  f"{hist[-1]['val_epe']:.4f} (zero flow {hist[-1]['val_epe_zero_flow']:.4f})")
            check(counts == expect, f"{name}: launches {counts}, expected {expect}")
            check(len(hist) == epochs and tr.state.step == steps
                  and all(math.isfinite(v) for h in hist for v in h.values()),
                  f"{name}: device-gen history")
            check([e for e, _ in record] == list(range(epochs))
                  and not any(np.array_equal(record[i][1], record[i + 1][1])
                              for i in range(epochs - 1)), f"{name}: a fresh scene each epoch")
            for k in keys:
                launches[k] += counts[k]

            again = []
            _, resumed_sampler = pan_device_gen(multibox, spe * b, again)
            resumed = UPFlowTrainer(cfg)
            hist2 = resumed.fit_device_gen(gen_fn, resumed_sampler, spe, epochs=1, log_every=0,
                                           resume=True, val_pairs=val_pairs, val_flow=val_flow)
            check([e for e, _ in again] == [epochs] and resumed.state.step == steps + spe
                  and math.isfinite(hist2[0]["val_epe"]),
                  f"{name}: resume did not continue the epoch seeds and the step count")

            # one step from the device positions against one on the same
            # generated pairs already on the card: the generator adds no copy
            const, pos = pos_sampler(epochs + 1)
            const = {k: ([torch.from_numpy(t).cuda() for t in v] if isinstance(v, list)
                         else torch.from_numpy(v).cuda()) for k, v in const.items()}
            pos = {k: torch.from_numpy(v).cuda() for k, v in pos.items()}

            def gen_step(i, tr=tr, gen_fn=gen_fn, const=const, pos=pos):
                sl = {k: v[(i % spe) * b : (i % spe + 1) * b] for k, v in pos.items()}
                im1, im2, _ = gen_fn(const, sl)
                return tr.train_step({"im1": im1.float(), "im2": im2.float()})

            im1, im2, _ = gen_fn(const, {k: v[:b] for k, v in pos.items()})
            resident = {"im1": im1.float(), "im2": im2.float()}
            host = np.stack([im1.cpu().numpy(), im2.cpu().numpy()], axis=1)
            htod_gen = count_htod(torch, gen_step)
            htod_resident = count_htod(torch, lambda i: tr.train_step(resident))
            check(htod_gen == htod_resident,
                  f"{name}: a device-gen step copied {htod_gen} times from the host, a step "
                  f"on pairs on the card {htod_resident}")
            before = dict(LAUNCHES)
            gen_step(0)
            torch.cuda.synchronize()
            check(launch_delta(before) == per_step, f"{name}: step launches")

            def fit_step(i, tr=tr, host=host):
                return tr.train_step(tr._batch(tr.upload(host)))

            # in turns (gen, fit, fit, gen), each the mean of its two loops
            runs = {"gen": [], "fit": []}
            for which in ("gen", "fit", "fit", "gen"):
                runs[which].append(cuda_and_host_ms(gen_step if which == "gen" else fit_step,
                                                    iters=10))
            (ms, host_ms), (fit_ms, fit_host_ms) = (
                tuple(statistics.mean(v) for v in zip(*runs[k])) for k in ("gen", "fit"))
            dev_ms = device_ms(gen_step, 4)

            def gen_only(i, gen_fn=gen_fn, const=const, pos=pos):
                return gen_fn(const, {k: v[(i % spe) * b : (i % spe + 1) * b]
                                      for k, v in pos.items()})

            gen_dev_ms = device_ms(gen_only, 20)
            gen_syncs = synchronizing_calls(torch, gen_only)
            check(gen_syncs == 0, f"{name}: the generator made the host wait {gen_syncs} times")
            times[name] = {
                "step_ms": ms, "step_host_ms": host_ms, "step_device_ms": dev_ms,
                "busy_share": dev_ms / ms, "fit_uploaded_step_ms": fit_ms,
                "fit_uploaded_step_host_ms": fit_host_ms,
                "generator_device_ms": gen_dev_ms, "generator_device_share": gen_dev_ms / dev_ms,
                "generator_host_us": host_us_per_call(torch, gen_only),
                "htod_copies_per_2_steps": htod_gen,
                "step_synchronizing_calls": synchronizing_calls(torch, gen_step),
                "resident_step_synchronizing_calls": synchronizing_calls(
                    torch, lambda i: tr.train_step(resident)),
            }
            del tr, resumed
    print("upflow device_gen times " + json.dumps(times))

    # the CLI: train_upflow --device_gen 64 (8 steps of 8), then test_upflow
    data = os.path.join(tmp, "cligen_d")
    common = ["--dataset", "rectangle2d_tex_pan", "--data_dir", data, "--results_dir",
              os.path.join(tmp, "cligen_r")]
    before = dict(LAUNCHES)
    cli(["generate", "--dataset", "rectangle2d_tex_pan", "--frames", "60", "--data_dir", data])
    cli(["train_upflow", "--epochs", "1", "--device_gen", "64", "--census_weight", "1.0",
         "--smooth1_weight", "0.1", *common])
    cli(["test_upflow", "--max_frames", "9", *common])
    torch.cuda.synchronize()
    run = os.path.join(tmp, "cligen_r", "rectangle2d_tex_pan", "upflow")
    with open(os.path.join(run, "loss.json")) as f:
        rows = json.load(f)["loss"]
    with open(os.path.join(run, "test_report.json")) as f:
        report = json.load(f)["scivis"]
    delta = launch_delta(before)
    print(f"cli upflow device_gen: train_upflow --device_gen 64, test_upflow ok; "
          f"report={json.dumps(report)} launches={delta}")
    check(len(rows) == 1 and math.isfinite(rows[0]["val_epe"]), "cli device_gen loss.json")
    check(all(math.isfinite(v) for v in report.values()), "cli device_gen test_upflow report")
    check(delta.get("corr_bwd") == 5 * 8 and delta.get("warp2d_bwd") == 6 * 8,
          f"cli device_gen: 8 train steps expected, launches {delta}")
    return launches, times


def phase_rife3d_device_gen(torch, tmp: str):
    """``Trainer.fit_device_gen`` with ``box_density_device`` at [4,64,64,64]
    in process (8 + 8 launches a step), then ``train256 --device_gen`` at
    256^3, full resolution, as its own process."""
    from opticalflowscivis_tpu_torch.data import box_density_device, tuple_positions
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from opticalflowscivis_tpu_torch.training import Trainer

    b, z, y, x, _ = VOLUME_SHAPE
    grid = (z, y, x)
    box = tuple(g // 4 for g in grid)  # train256's box
    spe, epochs, n_val = 2, 2, 4
    tr = Trainer(train3d_config(os.path.join(tmp, "gen3d"), False, batch=b))
    seen = []

    def pos_sampler(epoch):
        seen.append(epoch)
        return tuple_positions(np.random.default_rng(60 + epoch), spe * b, grid, box)

    keys = ("warp3d", "warp3d_bwd")
    reset_launches()  # the 3-D device-gen path's run starts here
    hist = tr.fit_device_gen(lambda p: box_density_device(p, grid, box), pos_sampler,
                             tuple_positions(np.random.default_rng(7), n_val, grid, box),
                             spe, epochs=epochs, log_every=0)
    torch.cuda.synchronize()
    counts = {k: LAUNCHES[k] for k in keys}  # read just after the run
    steps = spe * epochs
    expect = {"warp3d": 8 * steps + 8 * epochs, "warp3d_bwd": 8 * steps}
    print(f"rife3d device_gen: {steps} steps at [{b},{z},{y},{x},1] launches={counts} "
          f"loss_G {hist[0]['loss_G']:.5f} -> {hist[-1]['loss_G']:.5f}")
    check(counts == expect and seen == list(range(epochs)), f"rife3d device_gen {counts}")
    check(all(math.isfinite(v) for h in hist for v in h.values()), "rife3d device_gen losses")
    del tr
    torch.cuda.empty_cache()

    out = os.path.join(tmp, "t256gen")
    cmd = [sys.executable, "-m", "opticalflowscivis_tpu_torch.scripts.train256", "--grid", "256",
           "--device_gen", "4", "--epochs", "2", "--val_tuples", "2", "--out", out]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"train256 --device_gen exited {res.returncode}:\n"
          f"{res.stderr[-2000:]}")
    report = json.loads(res.stdout.strip().splitlines()[-1])
    report["process_seconds"] = time.perf_counter() - t0
    print("train256 device_gen " + json.dumps(report))
    check(report["grid"] == 256 and report["steps"] == 8 and report["device_gen"]
          and not report["coarse_final"] and report["val_set"] == "seed7_positions",
          "train256 --device_gen report")
    check(all(math.isfinite(report[k]) for k in ("seconds_per_step", "train_step_seconds",
                                                 "val_psnr_model", "val_psnr_linear"))
          and report["cuda_peak_bytes"] > 0, "train256 --device_gen numbers")
    return counts


def write_vimeo_tree(root: str, n_train: int, n_test: int, seed: int) -> None:
    """A Vimeo90K-layout tree: ``sequences/<id>/im{1,2,3}.png`` at 448 x 256
    grayscale, a smooth random texture moved by a few pixels a frame, and the
    two list files."""
    import cv2
    import torch
    import torch.nn.functional as F

    h, w = VIMEO_HW
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n_train + n_test):
        dy, dx = (int(v) for v in rng.integers(-4, 5, 2))
        coarse = torch.from_numpy(rng.uniform(0, 1, (1, 1, h // 8 + 2, w // 8 + 2)))
        tex = F.interpolate(coarse, size=(h + 16, w + 16), mode="bicubic", align_corners=True)
        tex = (tex[0, 0].clamp(0, 1).numpy() * 255).astype(np.uint8)
        name = f"{i // 4:05d}/{i % 4 + 1:04d}"
        d = os.path.join(root, "sequences", name)
        os.makedirs(d)
        for f in range(3):
            oy, ox = 8 + dy * (f - 1), 8 + dx * (f - 1)
            cv2.imwrite(os.path.join(d, f"im{f + 1}.png"), tex[oy : oy + h, ox : ox + w])
        names.append(name)
    with open(os.path.join(root, "tri_trainlist.txt"), "w") as f:
        f.write("\n".join(names[:n_train]) + "\n")
    with open(os.path.join(root, "tri_testlist.txt"), "w") as f:
        f.write("\n".join(names[n_train:]) + "\n")


def phase_vimeo(torch, tmp: str):
    """``train --dataset vimeo2d`` at the CLI's defaults (224 x 224 crops,
    batch 16, ``ifnet_2d`` at full width) on a written Vimeo-layout tree; then
    in process ``Trainer.fit_stream`` on the same crops, 10 + 10 launches a
    step, and the step time with the host's sampling share of it."""
    import argparse

    from opticalflowscivis_tpu_torch.cli.__main__ import _build_cfg
    from opticalflowscivis_tpu_torch.cli.__main__ import main as cli
    from opticalflowscivis_tpu_torch.data import VimeoDataset
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from opticalflowscivis_tpu_torch.training import ModelConfig, Trainer

    root = os.path.join(tmp, "vimeo")
    write_vimeo_tree(root, n_train=16, n_test=2, seed=25)
    dirs = ["--data_dir", os.path.join(tmp, "vim_d"), "--results_dir",
            os.path.join(tmp, "vim_r"), "--log_dir", os.path.join(tmp, "vim_l")]
    before = dict(LAUNCHES)
    cli(["train", "--dataset", "vimeo2d", "--vimeo_root", root, "--steps_per_epoch",
         str(VIMEO_STEPS), "--epochs", "1", *dirs])
    torch.cuda.synchronize()
    delta = launch_delta(before)
    with open(os.path.join(tmp, "vim_r", "vimeo2d", "2x", "flownet", "loss.json")) as f:
        final = json.load(f)["val_loss"][-1]
    print(f"cli train vimeo2d: {VIMEO_STEPS} steps launches={delta}")
    check(all(math.isfinite(v) for v in final) and delta.get("warp2d_bwd") == 10 * VIMEO_STEPS,
          f"cli vimeo2d: loss.json {final}, launches {delta}")

    args = argparse.Namespace(dataset="vimeo2d", exp=1, data_dir=dirs[1], results_dir=dirs[3],
                              log_dir=os.path.join(tmp, "vim_l2"), model_name="flownet",
                              config_json=None, epochs=1, batch_size=None)
    cfg = _build_cfg(args)
    check(cfg.batch_size is None and cfg.model == ModelConfig.preset_2d(),
          "vimeo2d: the CLI's config is not ifnet_2d at full width")
    tr = Trainer(cfg)
    ds = VimeoDataset(root, split="train", seed=3)
    val = VimeoDataset(root, split="test").sample(2)
    reset_launches()  # the Vimeo path's run starts here
    hist = tr.fit_stream(lambda: ds.sample(16), val, VIMEO_STEPS, epochs=1, log_every=0)
    torch.cuda.synchronize()
    counts = {k: LAUNCHES[k] for k in ("warp2d", "warp2d_bwd")}  # read just after the run
    print(f"vimeo fit_stream: {VIMEO_STEPS} steps at [16,224,224,1] launches={counts} "
          f"loss_G {hist[0]['loss_G']:.5f}")
    check(counts["warp2d_bwd"] == 10 * VIMEO_STEPS and counts["warp2d"] >= 10 * VIMEO_STEPS
          and math.isfinite(hist[0]["loss_G"]), f"vimeo fit_stream launches {counts}")
    before = dict(LAUNCHES)
    tr.train_step(tr.upload(ds.sample(16)))
    torch.cuda.synchronize()
    step = launch_delta(before)
    PER_CALL["vimeo_train_step"] = step
    check(step == {"warp2d": 10, "warp2d_bwd": 10}, f"vimeo step launches {step}")

    sample_s = []

    def stream_step(i):
        t0 = time.perf_counter()
        batch = ds.sample(16)
        sample_s.append(time.perf_counter() - t0)
        return tr.train_step(tr.upload(batch))

    ms, host_ms = cuda_and_host_ms(stream_step, iters=8)
    sample_ms = 1e3 * statistics.mean(sample_s[-8:])
    times = {"step_ms": ms, "step_host_ms": host_ms, "host_sample_ms": sample_ms,
             "host_sample_share": sample_ms / host_ms}
    print("vimeo times " + json.dumps(times))
    return counts, times


def phase_lbs(torch, tmp: str):
    """``lattice_boltzmann_2d`` on the card against the CPU at 400 x 100, a
    short run; ``generate --dataset lbs2d`` (the registry's 33 000 steps),
    timed; ``LBS_TIMED_STEPS`` steps of vortex2d's and vortex2d_fast's
    simulation (inlet 0.1), timed."""
    from opticalflowscivis_tpu_torch.cli.__main__ import main as cli
    from opticalflowscivis_tpu_torch.data.lbs import lattice_boltzmann_2d

    short = dict(n_steps=LBS_STEPS_CPU, skip=LBS_STEPS_CPU // 2, sample_every=10)
    for inflow_u in (0.0, 0.1):
        card = lattice_boltzmann_2d(inflow_u=inflow_u, **short)
        cpu = lattice_boltzmann_2d(inflow_u=inflow_u, device="cpu", **short)
        err = float(np.abs(card - cpu).max())
        print(f"lbs card vs cpu at 400x100, {LBS_STEPS_CPU} steps, inflow_u={inflow_u}: "
              f"max_abs_err={err:.3e} tol={LBS_TOL}")
        check(card.shape == cpu.shape == (LBS_STEPS_CPU // 20, 100, 400, 3) and err <= LBS_TOL,
              "lattice_boltzmann_2d on the card disagrees with the CPU")
    t0 = time.perf_counter()
    cli(["generate", "--dataset", "lbs2d", "--data_dir", os.path.join(tmp, "lbs")])
    full_s = time.perf_counter() - t0
    import pickle

    with open(os.path.join(tmp, "lbs", "lbs2d.pkl"), "rb") as f:
        arr = pickle.load(f)
    check(arr.shape == (3000, 100, 400, 3) and np.isfinite(arr).all(), "generate lbs2d")
    times = {"lbs2d_generate_s": full_s, "lbs2d_ms_per_step": full_s * 1e3 / 33000}
    for name, every in (("vortex2d", 20), ("vortex2d_fast", 60)):
        t0 = time.perf_counter()
        part = lattice_boltzmann_2d(n_steps=LBS_TIMED_STEPS, skip=LBS_TIMED_STEPS - 10 * every,
                                    sample_every=every, inflow_u=0.1)
        times[f"{name}_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / LBS_TIMED_STEPS
        check(part.shape == (10, 100, 400, 3) and np.isfinite(part).all(), f"{name} steps")
    print("lbs times " + json.dumps(times) + f"  ({LBS_TIMED_STEPS} steps each for the vortex "
          "sets, not their full 34 000 / 94 000)")
    return times


# -- phase 9b: data parallelism, the sharded 3-D warp, the evaluation protocols, fastprep --

DP_TIME_STEPS = 3  # timed train steps on the first batch, after the recorded one
DP_TIMEOUT_S = 300
# a train step's launches, each rank's as the one device's
DP_STEP_LAUNCHES = {"rife": {"warp2d": 10, "warp2d_bwd": 10},
                    "upflow": {"corr": 5, "corr_bwd": 5, "warp2d": 8, "warp2d_bwd": 6}}
SHARDED_SIZE = 256  # [1, 1, 256, 256, 256] f32 over 2 ranks: Z_local 128
SHARDED_R_Z = 8
HD_HW = (1080, 1920)
HD_FRAMES = 5
PROTOCOL_HW = (256, 448)  # the triplet and Vimeo trees' frames
MIDDLEBURY_HW = (388, 584)  # the Other set's frame size
# scores of the kernels' protocol against the plain kernels': both forwards
# agree within F32_TOL, then the prediction is rounded to uint8, where a value
# on a level's edge may round the other way
PROTOCOL_PSNR_TOL = 1e-2  # dB, also Y-PSNR
PROTOCOL_SSIM_TOL = 1e-4
PROTOCOL_IE_TOL = 2e-3  # the report keeps 3 decimals


def torchrun(nproc: int, module: str, args: list, what: str) -> str:
    """``torchrun --standalone --nproc_per_node nproc -m module args`` from the
    checkout; its output, or a failure with the end of it."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "-m", module, *args]
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=DP_TIMEOUT_S)
    check(res.returncode == 0, f"{what}: exit {res.returncode}\n{res.stdout[-3000:]}\n"
                               f"{res.stderr[-3000:]}")
    return res.stdout


def dp_against(want: dict, got: dict, what: str) -> dict:
    """A data-parallel step's parts and gradients against the one-device
    step's: bit for bit, or within TRAIN_PARTS_TOL (relative) and
    TRAIN_GRAD_TOL (of the largest gradient)."""
    parts = max(abs(got["parts"][k] - v) / max(abs(v), 1e-12)
                for k, v in want["parts"].items() if v)
    scale = max(float(g.abs().max()) for g in want["grads"].values())
    grads = max(float((got["grads"][k] - g).abs().max()) for k, g in want["grads"].items())
    bitwise = all(got["parts"][k] == v for k, v in want["parts"].items()) and all(
        bool((got["grads"][k] == g).all()) for k, g in want["grads"].items())
    check(set(got["grads"]) == set(want["grads"]), f"{what}: other parameters have gradients")
    check(bitwise or (parts <= TRAIN_PARTS_TOL and grads <= TRAIN_GRAD_TOL * scale),
          f"{what}: parts {parts:.3e} (tol {TRAIN_PARTS_TOL}), gradients {grads:.3e} of "
          f"{scale:.3e} (tol {TRAIN_GRAD_TOL})")
    return {"bitwise": bitwise, "parts_rel_err": parts, "grad_err_of_largest": grads / scale}


def phase_data_parallel(torch, tmp: str) -> dict:
    """9b, data parallelism at full width through ``scripts/dryrun_dp.py``:
    RIFE-2D ``fit`` at batch 64 on 128x128 and UPFlow ``fit`` at 256 x 832
    batch 8, float32, cuDNN deterministic.  The plain trainers in this process
    (no process group), one NCCL rank under torchrun, and two gloo ranks
    sharing the card: each data-parallel step against the plain one, the
    fit's ``loss.json`` and checkpoint, the launches a step, the step's
    time."""
    from opticalflowscivis_tpu_torch.scripts import dryrun_dp

    torch.cuda.empty_cache()
    module = "opticalflowscivis_tpu_torch.scripts.dryrun_dp"
    common = ["--size", "full", "--deterministic", "--time_steps", str(DP_TIME_STEPS)]
    runs = {"plain": os.path.join(tmp, "dp_plain"), "nccl_1": os.path.join(tmp, "dp_nccl1"),
            "gloo_2": os.path.join(tmp, "dp_gloo2")}
    with deterministic_cudnn(torch):
        dryrun_dp.run(runs["plain"], "full", None, None, DP_TIME_STEPS)
    torch.cuda.empty_cache()
    torchrun(1, module, ["--out", runs["nccl_1"], *common], "dp one NCCL rank")
    torchrun(2, module, ["--out", runs["gloo_2"], "--backend", "gloo", *common],
             "dp two gloo ranks on one card")
    rec = {name: {m: torch.load(os.path.join(d, m, "step.pt"), weights_only=False)
                  for m in ("rife", "upflow")} for name, d in runs.items()}
    report, launches = {}, {}
    for model, loss_rel, key in (("rife", "res/rectangle2d/2x/flownet/loss.json", "val_loss"),
                                 ("upflow", "loss.json", "loss")):
        want = rec["plain"][model]
        with open(os.path.join(runs["plain"], model, loss_rel)) as f:
            want_loss = json.load(f)[key][-1]
        for name in ("nccl_1", "gloo_2"):
            got = rec[name][model]
            row = dp_against(want, got, f"dp {name} {model}")
            with open(os.path.join(runs[name], model, loss_rel)) as f:
                got_loss = json.load(f)[key][-1]
            pairs = (list(zip(want_loss, got_loss)) if key == "val_loss" else
                     [(v, got_loss[k]) for k, v in want_loss.items()])
            # after the fit's Adam steps, of the record's largest value (the total):
            # Adam divides each gradient by its own running size, so the last
            # digits a gradient may differ in (the `dimg` atomics) move a weight
            # whose gradient nearly cancels by a part of a step
            loss_err = max(abs(b - a) for a, b in pairs) / max(abs(a) for a, _ in pairs)
            print(f"dp {name} {model}: loss.json {pairs}")
            check(loss_err <= TRAIN_PARTS_TOL, f"dp {name} {model}: loss.json {loss_err:.3e}")
            ckpt = ("log/rectangle2d/flownet.ckpt" if model == "rife" else "upflow.ckpt")
            a = torch.load(os.path.join(runs["plain"], model, ckpt), weights_only=True)
            b = torch.load(os.path.join(runs[name], model, ckpt), weights_only=True)
            check(a["model"].keys() == b["model"].keys() and a["step"] == b["step"],
                  f"dp {name} {model}: the checkpoint is not the one-device format")
            step = {k: v for k, v in got["launches"].items() if v}
            check(step == DP_STEP_LAUNCHES[model] and got["launches"] == want["launches"],
                  f"dp {name} {model}: launches a step {step}, plain {want['launches']}")
            row.update(loss_json_rel_err=loss_err, step_ms=got["step_ms"],
                       plain_step_ms=want["step_ms"],
                       launches_per_step={k: v for k, v in got["launches"].items() if v})
            report[f"{model}_{name}"] = row
            for k, v in got["launches_run"].items():
                launches[k] = launches.get(k, 0) + v
        PER_CALL[f"dp_{model}_train_step"] = {k: v for k, v in want["launches"].items() if v}
    print("data parallel " + json.dumps(report) + f"  (float32; gloo_2's launches are rank "
          "0's, its half of each step)")
    return launches


def phase_sharded_warp(torch, tmp: str) -> tuple[dict, dict]:
    """9b, ``backward_warp3d_sharded`` at [1, 1, 256, 256, 256] f32, r_z 8,
    over 2 gloo ranks sharing the card (``scripts/sharded_warp.py``): border
    and zeros, forward and backward, against ``warp3d`` on the whole volume;
    one ``warp3d`` and one ``warp3d_bwd`` launch a rank a call; the halo
    exchange's, the sharded and the unsharded calls' event times; then
    ``sharded_kernel_times`` in this process."""
    out = os.path.join(tmp, "sharded")
    torchrun(2, "opticalflowscivis_tpu_torch.scripts.sharded_warp",
             ["--out", out, "--size", str(SHARDED_SIZE), "--r_z", str(SHARDED_R_Z),
              "--backend", "gloo"], "sharded warp over two gloo ranks")
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    launches = {}
    worst = {"fwd": 0.0, "bwd": 0.0}
    for res in ranks:
        for padding in ("border", "zeros"):
            e = res[f"err_{padding}"]
            bwd = max(e["dimg"] / e["dimg_scale"], e["dflow"] / e["dflow_scale"])
            worst["fwd"], worst["bwd"] = max(worst["fwd"], e["fwd"]), max(worst["bwd"], bwd)
            check(e["fwd"] <= F32_TOL and bwd <= BWD_F32_TOL,
                  f"sharded warp rank {res['rank']} {padding}: {e}")
            n = res[f"launches_{padding}"]
            check(n == {"warp3d": 1, "warp3d_bwd": 1},
                  f"sharded warp rank {res['rank']} {padding}: launches {n}")
            for k, v in n.items():
                launches[k] = launches.get(k, 0) + v
    # CUDA events around calls whose halo goes through the host (gloo), while
    # the other rank works on the same card: wall times of a rank, not device
    # times of the exchange or the kernels
    times = {f"rank{res['rank']}": res["ms"] for res in ranks}
    print(f"sharded warp [1,1,{SHARDED_SIZE}^3] r_z {SHARDED_R_Z}, 2 gloo ranks on one card: "
          f"worst fwd {worst['fwd']:.3e} (tol {F32_TOL}), worst bwd {worst['bwd']:.3e} of the "
          f"largest gradient (tol {BWD_F32_TOL}); a rank's event times through the host (ms) "
          + json.dumps(times))
    shard = sharded_kernel_times(torch)
    return launches, {"worst": worst, "rank_event_ms": times, "haloed_shard_kernels": shard}


def sharded_kernel_times(torch) -> dict:
    """The ``*_offset`` instances alone at the haloed shard the sharded warp
    hands them, [1, 1, Z_local + 2·mz, 256, 256] f32 border (the two ranks'
    shards of ``scripts/sharded_warp.py``'s volume in turns, z offsets -mz
    and Z_local - mz), device ms by the profiler (median of 5 windows of 40
    calls): the forward and the backward with ``dimg`` beside the instances
    without the offset on the same slab, ``F.grid_sample`` on the haloed
    shard (autograd through it for the backward), the plain version and the
    bound of each call's own bytes and operations."""
    import torch.nn.functional as F

    from opticalflowscivis_tpu_torch.ops.kernels.warp import _launch3d, _launch3d_backward
    from opticalflowscivis_tpu_torch.ops.warp import warp3d_plain
    from opticalflowscivis_tpu_torch.scripts.sharded_warp import _inputs

    r_z, mz, size = SHARDED_R_Z, SHARDED_R_Z + 1, SHARDED_SIZE
    z_local = size // 2
    img, flow, g = _inputs(size, 0, torch.device("cuda"))
    shards = []
    for rank in range(2):
        z0 = rank * z_local
        lo, hi = max(z0 - mz, 0), min(z0 + z_local + mz, size)
        # the halo_exchange's "edge" fill at the volume's ends
        img_h = torch.cat([img[:, :, :1].expand(-1, -1, mz - (z0 - lo), -1, -1),
                           img[:, :, lo:hi],
                           img[:, :, -1:].expand(-1, -1, mz - (hi - z0 - z_local), -1, -1)],
                          dim=2).contiguous()
        flow_h = F.pad(flow[:, :, z0:z0 + z_local], (0, 0, 0, 0, mz, mz))
        g_h = F.pad(g[:, :, z0:z0 + z_local], (0, 0, 0, 0, mz, mz))
        shards.append((img_h, flow_h, g_h, z0 - mz))
    del img, flow, g
    zh = z_local + 2 * mz
    check(all(s[0].shape[2] == zh for s in shards), "haloed shards of the wrong depth")

    def grid(flow_h):
        """``F.grid_sample``'s grid on the haloed shard (r_z clip, r_yx 0)."""
        fz = torch.where(flow_h[:, 0].abs() < r_z, flow_h[:, 0],
                         torch.sign(flow_h[:, 0].detach()) * r_z)
        zs, ys, xs = (torch.arange(n, device="cuda", dtype=torch.float32) for n in (zh, size, size))
        return torch.stack([2.0 * (xs.view(1, 1, 1, -1) + flow_h[:, 2]) / (size - 1) - 1.0,
                            2.0 * (ys.view(1, 1, -1, 1) + flow_h[:, 1]) / (size - 1) - 1.0,
                            2.0 * (zs.view(1, -1, 1, 1) + fz) / (zh - 1) - 1.0], dim=-1)

    def library_fwd(im, fl):
        return F.grid_sample(im, grid(fl), mode="bilinear", padding_mode="border",
                             align_corners=True)

    grids = [(s[0], grid(s[1])) for s in shards]
    lib_err = float((library_fwd(*shards[0][:2])
                     - _launch3d(*shards[0][:2], r_z, 0, "border", shards[0][3])).abs().max())
    check(lib_err <= 1e-4, f"F.grid_sample on the haloed shard differs ({lib_err:.3e})")
    fwd = interleaved_device_ms({
        "offset": lambda i: _launch3d(*shards[i % 2][:2], r_z, 0, "border", shards[i % 2][3]),
        "no_offset": lambda i: _launch3d(*shards[i % 2][:2], r_z, 0, "border"),
        "library": lambda i: F.grid_sample(*grids[i % 2], mode="bilinear",
                                           padding_mode="border", align_corners=True),
    }, only={"offset": "warp3d_kernel", "no_offset": "warp3d_kernel", "library": "sampler"},
        launches=1)
    vox = zh * size * size
    fwd_bytes, fwd_flops = vox * (4 + 12 + 4), vox * (45 + 24 + 16)
    bwd_bytes, bwd_flops = warp3d_backward_work((1, zh, size, size, 1), 4, True)
    graphs = []
    for img_h, flow_h, g_h, _ in shards:
        im, fl = img_h.clone().requires_grad_(True), flow_h.clone().requires_grad_(True)
        graphs.append((library_fwd(im, fl), (im, fl), g_h))
    bwd = interleaved_device_ms({
        "offset": lambda i: _launch3d_backward(
            *shards[i % 2][:3], r_z, 0, "border", True, shards[i % 2][3]),
        "no_offset": lambda i: _launch3d_backward(*shards[i % 2][:3], r_z, 0, "border", True),
    }, only="warp3d_bwd_kernel", launches=1)
    bwd["library"] = {"median_ms": device_ms(lambda i: torch.autograd.grad(
        graphs[i % 2][0], graphs[i % 2][1], graphs[i % 2][2], retain_graph=True), 20)}
    del graphs

    def plain_bwd(i):
        im, fl = (t.clone().requires_grad_(True) for t in shards[i % 2][:2])
        out = warp3d_plain(im, fl, r_z, 0, "border", shards[i % 2][3])
        return torch.autograd.grad(out, (im, fl), shards[i % 2][2])

    res = {}
    for name, t, nbytes, flops, plain in (
            ("forward", fwd, fwd_bytes, fwd_flops, lambda i: warp3d_plain(
                *shards[i % 2][:2], r_z, 0, "border", shards[i % 2][3])),
            ("backward_with_dimg", bwd, bwd_bytes, bwd_flops, plain_bwd)):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        res[name] = {
            "offset_kernel_ms": t["offset"]["median_ms"],
            "no_offset_kernel_ms": t["no_offset"]["median_ms"],
            "library_ms": t["library"]["median_ms"],
            "plain_ms": device_ms(plain, 5),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "windows_ms": {k: v.get("windows_ms") for k, v in t.items()},
        }
        res[name]["bound_share"] = res[name]["bound_ms"] / res[name]["offset_kernel_ms"]
    res["shape"] = [1, 1, zh, size, size]
    print("sharded warp kernels on the haloed shard " + json.dumps(res)
          + "  (device ms, profiler; bound: H100 SXM 3.35 TB/s, 67 TFLOP/s f32)")
    return res


@contextlib.contextmanager
def plain_ifnet_warps():
    """The IFNet's ``warp2d`` kernel wrapper replaced by ``warp2d_plain``."""
    from opticalflowscivis_tpu_torch.models import ifnet as ifnet_module
    from opticalflowscivis_tpu_torch.ops.warp import warp2d_plain

    saved = ifnet_module.warp2d
    ifnet_module.warp2d = warp2d_plain
    try:
        yield
    finally:
        ifnet_module.warp2d = saved


def textured_frames(n: int, hw, seed: int, shift=(2, 3)) -> list:
    """``n`` uint8 RGB frames: a smooth random texture moved by ``shift`` px a
    frame (frame k at k·shift)."""
    import torch
    import torch.nn.functional as F

    h, w = hw
    rng = np.random.default_rng(seed)
    pad = max(abs(shift[0]), abs(shift[1])) * n
    coarse = torch.from_numpy(rng.uniform(0, 255, (1, 3, (h + 2 * pad) // 16 + 2,
                                                     (w + 2 * pad) // 16 + 2)).astype(np.float32))
    tex = F.interpolate(coarse, size=(h + 2 * pad, w + 2 * pad), mode="bicubic",
                        align_corners=True).clamp(0, 255)[0].permute(1, 2, 0).numpy()
    return [tex[pad + k * shift[0]: pad + k * shift[0] + h,
                pad + k * shift[1]: pad + k * shift[1] + w].astype(np.uint8) for k in range(n)]


def write_protocol_trees(root: str) -> None:
    """A triplet-dir tree (2 triplets), a Vimeo90K test tree (2) and a
    Middlebury Other tree (12 sequences, frames 10 and 11 and the truth),
    from textures moved a few pixels a frame; PNGs through cv2."""
    import cv2

    from opticalflowscivis_tpu_torch.evalsuite.benchmarks import _MIDDLEBURY

    def triplet(seed, hw):
        f = textured_frames(3, hw, seed)
        return [np.ascontiguousarray(x[..., ::-1]) for x in (f[0], f[2], f[1])]  # BGR

    for i in range(2):
        d = os.path.join(root, "triplets", f"seq{i}")
        os.makedirs(d)
        for name, img in zip(("frame_00.png", "frame_02.png", "frame_01_gt.png"),
                             triplet(40 + i, PROTOCOL_HW)):
            cv2.imwrite(os.path.join(d, name), img)
    names = ["00001/0001", "00002/0007"]
    for i, tri in enumerate(names):
        d = os.path.join(root, "vimeo", "sequences", tri)
        os.makedirs(d)
        for name, img in zip(("im1.png", "im3.png", "im2.png"), triplet(50 + i, PROTOCOL_HW)):
            cv2.imwrite(os.path.join(d, name), img)
    with open(os.path.join(root, "vimeo", "tri_testlist.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    for i, name in enumerate(_MIDDLEBURY):
        f0, f1, mid = triplet(60 + i, MIDDLEBURY_HW)
        for sub, fname, img in (("other-data", "frame10.png", f0),
                                ("other-data", "frame11.png", f1),
                                ("other-gt-interp", "frame10i11.png", mid)):
            os.makedirs(os.path.join(root, sub, name), exist_ok=True)
            cv2.imwrite(os.path.join(root, sub, name, fname), img)


def phase_eval_protocols(torch, tmp: str) -> dict:
    """9b, the evaluation protocols on the card with ``ifnet_2d`` at full width
    on RGB frames (seed 0, float32): ``bench_latency`` at 480 x 640 x 3,
    ``bench_hd_yuv`` on a written 1080p sequence (``multi`` 1 and 2),
    ``bench_triplet_dirs``, ``bench_vimeo90k`` and ``bench_middlebury`` on
    written trees; each report against the same protocol with the plain
    kernels, and the kernels' launches."""
    from opticalflowscivis_tpu_torch.data.yuv_io import YUVWriter
    from opticalflowscivis_tpu_torch.evalsuite import benchmarks as bench
    from opticalflowscivis_tpu_torch.inference import Interpolator
    from opticalflowscivis_tpu_torch.models import ifnet_2d
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    root = os.path.join(tmp, "protocols")
    write_protocol_trees(root)
    hd_name = "HD_dataset/HD1080p_GT/toy.yuv"
    os.makedirs(os.path.join(root, os.path.dirname(hd_name)))
    with YUVWriter(os.path.join(root, hd_name)) as w:
        for frame in textured_frames(HD_FRAMES, HD_HW, seed=70):
            w.write(frame)
    interp = Interpolator(ifnet_2d(in_channels=3), pad_multiple=32)

    def protocols():
        hd = dict(max_index=HD_FRAMES - 1, name_list=[(hd_name, *HD_HW)])
        return {
            "triplet_dirs": bench.bench_triplet_dirs(interp, os.path.join(root, "triplets")),
            "vimeo90k": bench.bench_vimeo90k(interp, os.path.join(root, "vimeo")),
            "middlebury": bench.bench_middlebury(interp, os.path.join(root, "other-data"),
                                                 os.path.join(root, "other-gt-interp")),
            "hd_yuv_2x": bench.bench_hd_yuv(interp, root, multi=1, **hd),
            "hd_yuv_4x": bench.bench_hd_yuv(interp, root, multi=2, **hd),
        }

    with deterministic_cudnn(torch):
        reset_launches()  # the protocols' run starts here
        got = protocols()
        torch.cuda.synchronize()
        launches = {k: v for k, v in LAUNCHES.items() if v}  # read just after the run
        with plain_ifnet_warps():
            want = protocols()
    # forwards: 2 + 2 + 12 pairs, 2 + 3 at 1088 x 1920; 6 warps each
    check(launches == {"warp2d": 6 * 21}, f"protocol launches {launches}")
    for name in ("triplet_dirs", "vimeo90k"):
        g, w = got[name], want[name]
        check(g["n"] == w["n"] == 2 and abs(g["psnr"] - w["psnr"]) <= PROTOCOL_PSNR_TOL
              and abs(g["ssim"] - w["ssim"]) <= PROTOCOL_SSIM_TOL, f"{name}: {g} vs plain {w}")
    check(set(got["middlebury"]) == set(want["middlebury"]) and all(
        abs(got["middlebury"][k] - v) <= PROTOCOL_IE_TOL for k, v in want["middlebury"].items()),
        f"middlebury: {got['middlebury']} vs plain {want['middlebury']}")
    for name in ("hd_yuv_2x", "hd_yuv_4x"):
        check(abs(got[name]["mean"] - want[name]["mean"]) <= PROTOCOL_PSNR_TOL,
              f"{name}: {got[name]} vs plain {want[name]}")
    latency = bench.bench_latency(interp, (480, 640, 3))
    with plain_ifnet_warps():
        plain_latency = bench.bench_latency(interp, (480, 640, 3))
    report = {"kernels": got, "plain": want, "latency": latency, "plain_latency": plain_latency,
              "launches": launches}
    print("eval protocols " + json.dumps(report))
    return launches


def phase_fastprep() -> dict:
    """9b, ``data.fastprep`` on the train split of the registry's largest 2-D
    series (``rectangle2d``: 2205 of 3000 frames of 128 x 128 x 3 float32),
    stride-3 resample, both flips, 3-tuples: bit for bit against the numpy
    pipeline, both timed by the host's clock (a host figure, not the card's)."""
    from opticalflowscivis_tpu_torch.data import (
        flip_augment,
        group_tuples,
        rectangle_2d,
        temporal_resample,
    )
    from opticalflowscivis_tpu_torch.data.fastprep import load_library, prepare_tuples_native
    from opticalflowscivis_tpu_torch.data.registry import get_spec

    spec = get_spec("rectangle2d")
    series = rectangle_2d()[spec.train[0][0] : spec.train[0][1]]
    load_library()  # the g++ build is not timed
    t0 = time.perf_counter()
    native = prepare_tuples_native(series, exp=1, resample_stride=spec.resample_stride)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = group_tuples(flip_augment(temporal_resample(series, spec.resample_stride)), 1)
    numpy_s = time.perf_counter() - t0
    check(native.shape == ref.shape and np.array_equal(native, ref),
          "fastprep differs from the numpy pipeline")
    times = {"series_mb": series.nbytes / 1e6, "tuples_mb": native.nbytes / 1e6,
             "native_s": native_s, "numpy_s": numpy_s, "speedup": numpy_s / native_s}
    print(f"fastprep (host) {list(series.shape)} -> {list(native.shape)}, bit for bit: "
          + json.dumps(times))
    return times


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


# -- slice 13: RIFE's refinement, the pretrained zoo, the perceptual loss ------------

# [B, H, W, C] of the feature maps a Contextnet warps (1/2 to 1/16 of the
# frame): at the serving path's [32, 160, 224] and the training path's
# [64, 128, 128]
REFINE_SERVING_LEVELS = ((32, 80, 112, 16), (32, 40, 56, 32), (32, 20, 28, 64),
                         (32, 10, 14, 128))
REFINE_TRAIN_LEVELS = ((64, 64, 64, 16), (64, 32, 32, 32), (64, 16, 16, 64), (64, 8, 8, 128))
# the legacy zoo's context maps of a 1088 x 1920 pair at c_fusion = 32 (1/4 to 1/32)
ZOO_CONTEXT_LEVELS = ((1, 272, 480, 32), (1, 136, 240, 64), (1, 68, 120, 128),
                      (1, 34, 60, 256))
ZOO_HW = (1080, 1920)  # padded to 1088 x 1920 by both zoo paddings (32 and 64)
ZOO_CPU_HW = (270, 480)  # the CPU comparison's frames
# the widths the JAX package's zoo models default to
ZOO_HDV3_C = 90
ZOO_CS = (192, 128, 96, 48)
ZOO_C_FUSION = 32
ZOO_WARPS = {"hdv3": 6, "hdv1": 16, "hdv2": 16}  # warp2d launches per pair
REFINE_EPOCHS = 6
PERCEPTUAL_SHAPE = (8, 224, 224, 3)
# the perceptual loss and d/dx against the CPU's in float64.  In float64, card
# and CPU: the loss within 1e-9 and d/dx within 1e-6 (relative L2), float64
# convolutions in other summation orders.  In float32 d/dx is not a smooth
# function of rounding: a pre-activation within rounding of 0 or two values
# of a max-pool window within rounding of each other route a gradient
# differently, and the difference spreads back through the receptive field
# (the CPU's float32 d/dx differs from its float64 one by 1.3e-3 relative L2
# at [4, 112, 112, 3]; the card's float32 d/dx differed from the CPU's float32
# one by 6.3e-3 on an H100 at [8, 224, 224, 3], the loss by 4e-7).  So the
# card's float32 d/dx may lie no further from the float64 one than twice the
# CPU's float32 d/dx does (plus 1e-4), and its float32 loss within 1e-5.
PERCEPTUAL_F64_LOSS_TOL = 1e-9
PERCEPTUAL_F64_GRAD_TOL = 1e-6
PERCEPTUAL_F32_LOSS_TOL = 1e-5


def refine_kernel_case(torch, shape, img_dtype, flow_dtype, seed: int) -> dict:
    """``warp2d`` and its backward with ``dimg`` (unbounded, border, as the
    Contextnet warps) at ``shape`` [B, H, W, C] against the plain version,
    the backward's ``dflow`` twice bit for bit; the float32 errors."""
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
    from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d
    from opticalflowscivis_tpu_torch.ops.warp import warp2d_plain

    img, flow4, g = backward_inputs(torch, shape, img_dtype, seed, False,
                                    scale=min(10.0, shape[1] / 2), flow_dtype=flow_dtype)
    flow = flow4[:, 2:4]
    out = warp2d(img, flow, 0, "border")
    ref = warp2d_plain(img, flow, 0, "border")
    torch.cuda.synchronize()
    check(out.dtype == img_dtype and out.shape == ref.shape, "kernel output type")
    diff = (out.float() - ref.float()).abs()
    fwd_err = float(diff.max())
    f32 = img_dtype == torch.float32
    fwd_ok = fwd_err <= F32_TOL if f32 else bool((diff <= bf16_ulp(ref.float())).all())

    before = LAUNCHES["warp2d_bwd"]
    dimg, dflow = warp_grads(torch, warp2d, img, flow4, g, 0, "border", True)
    torch.cuda.synchronize()
    check(LAUNCHES["warp2d_bwd"] == before + 1, "backward launch count")
    dimg_ref, dflow_ref = warp_grads(torch, warp2d_plain, img, flow4, g, 0, "border", True)
    check(dimg.dtype == img_dtype and dflow.dtype == flow4.dtype, "gradient types")
    tol = BWD_F32_TOL if f32 else BWD_BF16_TOL
    bwd_ok, shown, bwd_err = True, [], 0.0
    for what, got, want in (("dflow", dflow, dflow_ref), ("dimg", dimg, dimg_ref)):
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        bwd_ok = bwd_ok and err <= tol * scale
        bwd_err = max(bwd_err, err)
        shown.append(f"{what}_err={err:.3e} (max|ref|={scale:.3e})")
    same = dflow_repeats(torch, img, flow, g, 0, "border", True)
    name = f"{str(img_dtype)[6:]} img, {str(flow4.dtype)[6:]} flow"
    print(f"refine warp2d {list(shape)} border r= 0 {name:26s} fwd_err={fwd_err:.3e} "
          f"tol={f'{F32_TOL:g}' if f32 else '1 bf16 ulp'}; bwd with dimg {' '.join(shown)} "
          f"tol={tol:g}*max|ref| dflow repeats bit-equal={same} "
          f"{'ok' if fwd_ok and bwd_ok and same else 'FAIL'}")
    check(fwd_ok, f"warp2d disagrees with plain at {shape} ({name})")
    check(bwd_ok, f"warp2d backward disagrees with plain at {shape} ({name})")
    check(same, f"two warp2d backward runs differ at {shape} ({name})")
    return {"fwd": fwd_err if f32 else 0.0, "bwd": bwd_err if f32 else 0.0}


def phase_refine_kernels(torch) -> dict:
    """Both 2-D kernels at the Contextnet levels of the serving and the
    training path and at the legacy zoo's context levels, f32, bf16 features
    under an f32 flow, and all bf16 (the bf16 model's own warps)."""
    worst = {"fwd": 0.0, "bwd": 0.0}
    seed = 1300
    modes = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
             (torch.bfloat16, torch.bfloat16))
    for shape in REFINE_SERVING_LEVELS + REFINE_TRAIN_LEVELS + ZOO_CONTEXT_LEVELS:
        for img_dtype, flow_dtype in modes:
            seed += 1
            errs = refine_kernel_case(torch, shape, img_dtype, flow_dtype, seed)
            worst = {k: max(worst[k], errs[k]) for k in worst}
    print("refine kernels worst float32 errors " + json.dumps(worst))
    return worst


def launches_only(torch, fn, allowed: dict):
    """``fn()``'s result and the launches it made, checked against ``allowed``
    (kernel -> count; every other kernel 0)."""
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES

    before = dict(LAUNCHES)
    res = fn()
    torch.cuda.synchronize()
    delta = {k: LAUNCHES[k] - before[k] for k in before if LAUNCHES[k] != before[k]}
    check(delta == allowed, f"launches {delta}, expected {allowed}")
    return res


def cpu_agrees(what: str, got, want) -> None:
    for name, x, y in zip(("merged", "flow", "mask"), got, want):
        err = float(np.abs(x - y).max())
        tol = CPU_TOL * max(1.0, float(np.abs(y).max()))
        print(f"cuda vs cpu {what} {name}: max_abs_err={err:.3e} tol={tol:.3e} "
              f"max|cpu|={np.abs(y).max():.3e}")
        check(err <= tol, f"cuda {what} {name} disagrees with the CPU plain path")


def phase_refine_serving(torch):
    """``ifnet_2d(refine=True)`` at full width through ``Interpolator`` and
    ``interpolate_series`` (14 ``warp2d`` launches a forward), f32 and bf16,
    against the CPU; ``ifnet_3d(refine=True)``, whose context warps stay off
    the kernels (6 ``warp3d`` launches a forward)."""
    from opticalflowscivis_tpu_torch.data import rectangle_2d
    from opticalflowscivis_tpu_torch.inference import Interpolator, interpolate_series
    from opticalflowscivis_tpu_torch.models import ifnet_2d, ifnet_3d
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    b, h, w, c = WARP_SHAPE
    interps = {name: Interpolator(ifnet_2d(dtype=dtype, device="cuda", seed=0, refine=True))
               for name, dtype in (("f32", None), ("bf16", torch.bfloat16))}
    rng = np.random.default_rng(13)
    a = rng.random((b, h, w, c), dtype=np.float32)
    z = rng.random((b, h, w, c), dtype=np.float32)
    series = rectangle_2d(n_frames=33, grid=(h, w), seed=0)[..., :1]

    reset_launches()  # the refine serving path's run starts here
    for name, interp in interps.items():
        merged, flow, mask = launches_only(torch, lambda: interp.pair(a, z), {"warp2d": 14})
        print(f"refine pair {name} [{b},{h},{w},{c}]: warp2d launches=14")
        check(merged.shape == (b, h, w, c) and flow.shape == (b, h, w, 4)
              and mask.shape == (b, h, w, 1), f"refine {name} output shapes")
        check(all(np.isfinite(x).all() for x in (merged, flow, mask)), f"refine {name} not finite")
        check(float(merged.min()) >= 0.0 and float(merged.max()) <= 1.0, "refined frame off [0, 1]")
    PER_CALL["refine_forward"] = {"warp2d": 14}
    cpu_model = ifnet_2d(device="cpu", seed=0, refine=True)
    cpu_model.load_state_dict(interps["f32"].model.state_dict())
    cpu = Interpolator(cpu_model, device="cpu").pair(a[:2], z[:2])
    gpu = launches_only(torch, lambda: interps["f32"].pair(a[:2], z[:2]), {"warp2d": 14})
    cpu_agrees("refine", gpu, cpu)
    for factor in (2, 4):
        recon, _ = launches_only(torch, lambda: interpolate_series(interps["f32"], series, factor),
                                 {"warp2d": 14 * int(math.log2(factor))})
        check(recon.shape == (33, h, w, 1) and np.isfinite(recon).all(), "refine series output")
        print(f"refine series x{factor}: warp2d launches={14 * int(math.log2(factor))}")
    torch.cuda.synchronize()
    launches = {"warp2d": LAUNCHES["warp2d"]}  # read just after the 2-D refine serving run
    print(f"refine serving path: launches={launches}")
    check(launches["warp2d"] > 0, "the refine serving path never launched warp2d")

    reset_launches()  # the 3-D refine serving run starts here
    vb = 2
    vols = [np.random.default_rng(s).random((vb,) + VOLUME_SHAPE[1:], dtype=np.float32)
            for s in (1, 2)]
    model3 = ifnet_3d(device="cuda", seed=0, refine=True)
    merged, flow, mask = launches_only(torch, lambda: Interpolator(model3).pair(*vols),
                                       {"warp3d": 6})
    check(merged.shape == (vb,) + VOLUME_SHAPE[1:] and np.isfinite(merged).all(),
          "3-D refine output")
    cpu3 = ifnet_3d(device="cpu", seed=0, refine=True)
    cpu3.load_state_dict(model3.state_dict())
    cpu_agrees("refine 3-D", (merged[:1], flow[:1], mask[:1]),
               Interpolator(cpu3, device="cpu").pair(vols[0][:1], vols[1][:1]))
    torch.cuda.synchronize()
    launches["warp3d"] = LAUNCHES["warp3d"]
    PER_CALL["refine3d_forward"] = {"warp3d": 6}
    print(f"refine 3-D pair {[vb, *VOLUME_SHAPE[1:]]}: warp3d launches=6, warp2d 0 (the "
          "context warps are the plain gather)")
    return launches, interps


def refine_train_config(torch, tmp: str, bfloat16: bool):
    """``train_config`` with ``refine=True``: ``ifnet_2d`` at full width and
    the Contextnet/Unet, batch 64 at 128^2."""
    from opticalflowscivis_tpu_torch.training import ModelConfig

    name = "bf16" if bfloat16 else "f32"
    return dataclasses.replace(
        train_config(torch, tmp, bfloat16), model=ModelConfig(bfloat16=bfloat16, refine=True),
        log_dir=os.path.join(tmp, f"log_refine_{name}"),
        results_dir=os.path.join(tmp, f"res_refine_{name}"))


def phase_refine_training(torch, tmp: str):
    """``Trainer.fit`` with refinement at full width on 128x128 rectangle
    tuples, f32 and bf16: 18 + 18 launches a train step (10 of the backward
    calls with ``dimg``), 18 + 0 an eval step, checkpoint round trip with
    ``contextnet`` and ``unet``; one step against the CPU; a 3-D refine step
    against the CPU."""
    from opticalflowscivis_tpu_torch.data import group_tuples, rectangle_2d
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from opticalflowscivis_tpu_torch.training import Trainer

    b, h, w, _ = TRAIN_SHAPE
    steps_per_epoch, n_val = 4, 16
    frames = rectangle_2d(n_frames=3 * (steps_per_epoch * b + n_val), grid=(h, w), box=(60, 80),
                          seed=3)
    tuples = group_tuples(frames, 1).astype(np.float32)
    train, val = tuples[: steps_per_epoch * b], tuples[steps_per_epoch * b:]
    launches = {"warp2d": 0, "warp2d_bwd": 0}
    trainers = {}
    for bfloat16 in (False, True):
        name = "bf16" if bfloat16 else "f32"
        cfg = refine_train_config(torch, tmp, bfloat16)
        tr = Trainer(cfg)
        reset_launches()  # the refine training path's run starts here
        hist = tr.fit(train, val, epochs=REFINE_EPOCHS, log_every=0)
        torch.cuda.synchronize()
        counts = {k: LAUNCHES[k] for k in launches}  # read just after the run
        steps, evals = REFINE_EPOCHS * steps_per_epoch, REFINE_EPOCHS
        print(f"refine fit {name}: {steps} train steps + {evals} eval steps at [{b},{h},{w},1]: "
              f"launches={counts} loss_G first eval {hist[0]['loss_G']:.6f} "
              f"last {hist[-1]['loss_G']:.6f}")
        check(all(math.isfinite(v) for parts in hist for v in parts.values()),
              f"refine {name} losses not finite")
        check(hist[-1]["loss_G"] < hist[0]["loss_G"], f"refine {name} fit did not lower loss_G")
        check(counts["warp2d"] == 18 * (steps + evals),
              f"refine {name}: {counts['warp2d']} forward launches, expected 18 a step")
        check(counts["warp2d_bwd"] == 18 * steps,
              f"refine {name}: {counts['warp2d_bwd']} backward launches, expected 18 a step")
        for key in launches:
            launches[key] += counts[key]
        with open(os.path.join(tr.results_dir, "loss.json")) as f:
            check(len(json.load(f)["val_loss"]) == REFINE_EPOCHS, f"refine {name} loss.json")
        saved = torch.load(tr.checkpoint_path(), map_location="cpu", weights_only=True)["model"]
        check(any(k.startswith("contextnet.") for k in saved)
              and any(k.startswith("unet.") for k in saved), "checkpoint without the refinement")
        fresh = Trainer(cfg)
        fresh.init_state(total_steps=steps)
        check(fresh.load_checkpoint() and fresh.state.step == steps, f"refine {name} load")
        restored = fresh.model.state_dict()
        check(all(torch.equal(v, restored[k]) for k, v in tr.model.state_dict().items()),
              f"refine {name}: restored weights differ")
        with deterministic_cudnn(torch):
            ours, theirs = tr.evaluate(val, b), fresh.evaluate(val, b)
        rel = max(abs(ours[k] - theirs[k]) / max(abs(ours[k]), 1e-12) for k in ours)
        tol = 1e-6 if not bfloat16 else 1e-3
        print(f"refine checkpoint {name}: restored step {fresh.state.step}, contextnet and unet "
              f"weights equal, evaluate rel diff {rel:.3e} tol={tol:g}")
        check(rel <= tol, f"refine {name}: the restored trainer evaluates differently")
        launches_only(torch, lambda tr=tr: tr.evaluate(val, b), {"warp2d": 18})
        record_warp2d_layouts(torch, f"refine_{name}",
                              lambda tr=tr: tr.train_step(tr.upload(train[:b])), 18, 10)
        trainers[name] = (tr, train)
    PER_CALL["refine_eval_step"] = {"warp2d": 18}
    print(f"refine training path: launches={launches}")

    # one step from the same weights, card against CPU, on textured frames
    tuples2 = group_tuples(rectangle_2d(n_frames=6, grid=(h, w), box=(60, 80), seed=1), 1)
    tuples2 = tuples2.astype(np.float32)
    tuples2[..., 0] += np.random.default_rng(0).uniform(0.05, 0.3, tuples2.shape[:-1]).astype(
        np.float32)
    cfg = refine_train_config(torch, tmp, bfloat16=False)
    parts, grads = {}, {}
    for device in ("cuda", "cpu"):
        tr = Trainer(cfg, device=device)
        tr.init_state(total_steps=10)
        expected = {"warp2d": 18, "warp2d_bwd": 18} if device == "cuda" else {}
        parts[device] = launches_only(
            torch, lambda tr=tr: {k: float(v) for k, v in tr.train_step(tr.upload(tuples2)).items()},
            expected)
        grads[device] = {n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()}
    PER_CALL["refine_train_step"] = {"warp2d": 18, "warp2d_bwd": 18}
    compare_step("refine", parts, grads)

    # 3-D: the context warps are the plain gather, the model's warps the kernels
    grid = VOLUME_SHAPE[1:4]
    tuples3 = textured_volume_tuples(1, grid, seed=2)
    cfg3 = train3d_config(tmp, False, batch=1, refine=True)
    parts, grads = {}, {}
    for device in ("cuda", "cpu"):
        tr = Trainer(cfg3, device=device)
        tr.init_state(total_steps=10)
        expected = {"warp3d": 8, "warp3d_bwd": 8} if device == "cuda" else {}
        parts[device] = launches_only(
            torch, lambda tr=tr: {k: float(v) for k, v in tr.train_step(tr.upload(tuples3)).items()},
            expected)
        grads[device] = {n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()}
    PER_CALL["refine3d_train_step"] = {"warp3d": 8, "warp3d_bwd": 8}
    compare_step("refine 3-D", parts, grads)
    return launches, trainers


def compare_step(what: str, parts: dict, grads: dict) -> None:
    """One train step's loss parts and gradients, card against CPU."""
    for key, ref in parts["cpu"].items():
        print(f"{what} train step cuda vs cpu {key}: cuda={parts['cuda'][key]:.6e} "
              f"cpu={ref:.6e} tol={TRAIN_PARTS_TOL:g} rel")
        check(abs(parts["cuda"][key] - ref) <= TRAIN_PARTS_TOL * max(abs(ref), 1e-6),
              f"{what} train step {key} disagrees")
    largest = max(float(g.abs().max()) for g in grads["cpu"].values())
    worst, where = max((float((grads["cuda"][n] - g).abs().max()), n)
                       for n, g in grads["cpu"].items())
    print(f"{what} train step cuda vs cpu gradients: max_abs_diff={worst:.3e} at {where}, "
          f"largest gradient {largest:.3e}, ratio {worst / largest:.3e} tol={TRAIN_GRAD_TOL:g}")
    check(worst <= TRAIN_GRAD_TOL * largest, f"{what} train step gradients disagree")


def phase_refine_times(torch, interps, trainers) -> dict:
    """Refine forward pairs/s beside the plain ``ifnet_2d``'s from the same
    seed, in turns in one call; the refine train step's ms, its device time
    and ``warp2d_bwd``'s share of it."""
    from opticalflowscivis_tpu_torch.inference import Interpolator
    from opticalflowscivis_tpu_torch.models import ifnet_2d

    b, h, w, c = WARP_SHAPE
    times = {}
    sets = []
    for i in range(4):
        g = torch.Generator(device="cuda").manual_seed(1300 + i)
        sets.append((torch.rand((b, c, h, w), generator=g, device="cuda"),
                     torch.rand((b, c, h, w), generator=g, device="cuda")))
    for name, interp in interps.items():
        dtype = torch.bfloat16 if name == "bf16" else None
        plain = Interpolator(ifnet_2d(dtype=dtype, device="cuda", seed=0))
        for turn in ("plain", "refine", "refine", "plain"):
            which = plain if turn == "plain" else interp
            ms = cuda_ms(lambda i, which=which: which.forward(*sets[i % 4]), iters=20)
            times.setdefault(f"{turn}_pairs_per_sec_{name}", []).append(b / (ms / 1e3))
        prof = profile_forward(torch, f"refine_{name}", lambda i: interp.forward(*sets[i % 4]))
        times[f"refine_forward_device_ms_{name}"] = prof["device_ms_per_forward"]
    tb = TRAIN_SHAPE[0]
    for name, (tr, train) in trainers.items():
        batches = [tr.upload(train[i * tb:(i + 1) * tb]) for i in range(4)]

        def step(i, tr=tr, batches=batches):
            return tr.train_step(batches[i % 4])

        ms, host = cuda_and_host_ms(step, iters=10)
        times[f"refine_train_step_ms_{name}"] = ms
        times[f"refine_train_step_ms_host_clock_{name}"] = host
        times[f"refine_train_pairs_per_sec_{name}"] = tb * 1e3 / ms
        prof = profile_forward(torch, f"refine_train_{name}", step, unit="train_step")
        times[f"refine_train_step_device_ms_{name}"] = prof["device_ms_per_train_step"]
        times[f"refine_train_busy_share_{name}"] = prof["busy_share"]
        times[f"refine_train_warp2d_bwd_share_{name}"] = prof["warp2d_bwd_share"]
        times[f"refine_train_warp2d_share_{name}"] = prof["warp2d_share"]
    print("refine times " + json.dumps(times))
    return times


def write_zoo_checkpoints(torch, root: str) -> dict:
    """Random checkpoints in the upstream layout (the port's modules carry
    the upstream keys) at the JAX package's default widths: HDv3 at c = 90,
    HD v1 and v2 at ``cs = (192, 128, 96, 48)``, ``c_fusion = 32``."""
    from opticalflowscivis_tpu_torch.models.ifnet_hd import IFNetHDv3
    from opticalflowscivis_tpu_torch.models.ifnet_hd_legacy import RIFEHDLegacy

    dirs = {}
    for kind in ("hdv3", "hdv1", "hdv2"):
        d = os.path.join(root, kind)
        os.makedirs(d, exist_ok=True)
        if kind == "hdv3":
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(3)
                net = IFNetHDv3(c=ZOO_HDV3_C)
            torch.save(net.state_dict(), os.path.join(d, "flownet.pkl"))
        else:
            net = RIFEHDLegacy(int(kind[-1]), ZOO_C_FUSION, ZOO_CS).init(seed=int(kind[-1]))
            for part, file in (("flownet", "flownet"), ("contextnet", "contextnet"),
                               ("fusionnet", "unet")):
                torch.save(getattr(net, part).state_dict(), os.path.join(d, f"{file}.pkl"))
        dirs[kind] = d
    return dirs


def zoo_frames(torch, hw, seed: int):
    """An RGB pair ``[1, H, W, 3]``: a smooth random texture and the same
    texture moved by (3, -5) px."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(seed)
    coarse = torch.rand((1, 3, hw[0] // 16 + 2, hw[1] // 16 + 2), generator=gen)
    tex = F.interpolate(coarse, size=(hw[0] + 16, hw[1] + 16), mode="bilinear",
                        align_corners=True)[0].permute(1, 2, 0).numpy()
    return tex[None, 8:8 + hw[0], 8:8 + hw[1]].copy(), tex[None, 5:5 + hw[0], 13:13 + hw[1]].copy()


def phase_zoo(torch, tmp: str):
    """``load_pretrained_zoo`` and ``ZooInterpolator.pair`` on one 1080 x 1920
    RGB pair for HDv3, HD v1 and HD v2 (6 / 16 / 16 ``warp2d`` launches a
    pair), each against the CPU at 270 x 480, the ms per 1088 x 1920 pair;
    then ``inference_img --zoo_dir`` and ``inference_video --zoo_dir``."""
    from opticalflowscivis_tpu_torch.cli.__main__ import main as cli
    from opticalflowscivis_tpu_torch.data import rectangle_2d
    from opticalflowscivis_tpu_torch.inference import load_pretrained_zoo
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    dirs = write_zoo_checkpoints(torch, os.path.join(tmp, "zoo"))
    a, z = zoo_frames(torch, ZOO_HW, seed=0)
    ca, cz = zoo_frames(torch, ZOO_CPU_HW, seed=1)
    times = {}
    reset_launches()  # the zoo paths' run starts here
    for kind, d in dirs.items():
        zoo = load_pretrained_zoo(d)
        check(zoo.kind == kind, f"{d} detected as {zoo.kind}")
        n = ZOO_WARPS[kind]
        pred, flow, mask = launches_only(torch, lambda: zoo.pair(a, z), {"warp2d": n})
        nflow = 2 if kind == "hdv1" else 4
        check(pred.shape == (1,) + ZOO_HW + (3,) and flow.shape == (1,) + ZOO_HW + (nflow,)
              and mask.shape == (1,) + ZOO_HW + (1,), f"{kind} output shapes")
        check(all(np.isfinite(x).all() for x in (pred, flow, mask)), f"{kind} not finite")
        check(float(pred.min()) >= 0.0 and float(pred.max()) <= 1.0, f"{kind} frame off [0, 1]")
        PER_CALL[f"zoo_{kind}_pair"] = {"warp2d": n}
        print(f"zoo {kind} pair [1,{ZOO_HW[0]},{ZOO_HW[1]},3] (padded to a multiple of "
              f"{zoo.pad_multiple}): "
              f"warp2d launches={n}, max|flow|={np.abs(flow).max():.3f}")
        cpu = load_pretrained_zoo(d, device="cpu").pair(ca, cz)
        gpu = launches_only(torch, lambda: zoo.pair(ca, cz), {"warp2d": n})
        cpu_agrees(f"zoo {kind} [1,{ZOO_CPU_HW[0]},{ZOO_CPU_HW[1]},3]", gpu, cpu)
        pads = [zoo._to_tensor(zoo._pad(x + 1e-3 * i)[0]) for i in range(2) for x in (a, z)]
        m = zoo.pad_multiple
        check(tuple(pads[0].shape[2:]) == tuple(-(-s // m) * m for s in ZOO_HW), f"{kind} padding")
        ms, host = cuda_and_host_ms(lambda i: zoo.forward(pads[2 * (i % 2)], pads[2 * (i % 2) + 1]),
                                    iters=5, warmup=2)
        times[f"{kind}_ms_per_pair"] = ms
        times[f"{kind}_ms_per_pair_host_clock"] = host
        prof = profile_forward(torch, f"zoo_{kind}", lambda i: zoo.forward(*pads[2 * (i % 2):][:2]),
                               iters=1)
        times[f"{kind}_device_ms_per_pair"] = prof["device_ms_per_forward"]
        with cudnn_benchmark(torch):  # the algorithms cuDNN's heuristics did not pick
            times[f"{kind}_ms_per_pair_cudnn_benchmark"] = cuda_ms(
                lambda i: zoo.forward(*pads[2 * (i % 2):][:2]), iters=5, warmup=2)
        t0 = time.perf_counter()
        zoo.pair(a, z)
        times[f"{kind}_pair_call_ms"] = (time.perf_counter() - t0) * 1e3
    # the verbs, on a generated rectangle2d series and two of its frames
    data, res = os.path.join(tmp, "zoo_d"), os.path.join(tmp, "zoo_r")
    cli(["generate", "--dataset", "rectangle2d", "--frames", "33", "--data_dir", data])
    frames = rectangle_2d(n_frames=2, seed=4)[..., 0]
    for i in range(2):
        np.save(os.path.join(tmp, f"zoo_img{i}.npy"), frames[i].astype(np.float32))
    for kind, d in dirs.items():
        out = os.path.join(tmp, f"zoo_out_{kind}")
        cli(["inference_img", "--zoo_dir", d, "--img0", os.path.join(tmp, "zoo_img0.npy"),
             "--img1", os.path.join(tmp, "zoo_img1.npy"), "--out_dir", out, "--n_exp", "2"])
        check(sorted(os.listdir(out)) == [f"img{i}.png" for i in range(5)],
              f"inference_img --zoo_dir {kind}")
        cli(["inference_video", "--zoo_dir", d, "--dataset", "rectangle2d", "--data_dir", data,
             "--results_dir", os.path.join(res, kind), "--factors", "2,4", "--max_frames", "9"])
        with open(os.path.join(res, kind, "rectangle2d", "interp_report.json")) as f:
            report = json.load(f)
        check(set(report) == {"2", "4"} and all(math.isfinite(v) for row in report.values()
                                                for v in row.values()),
              f"inference_video --zoo_dir {kind} report")
        print(f"cli zoo {kind}: inference_img wrote 5 frames; inference_video {json.dumps(report)}")
    torch.cuda.synchronize()
    launches = {"warp2d": LAUNCHES["warp2d"]}  # read just after the zoo paths' run
    check(launches["warp2d"] > 0 and sum(LAUNCHES.values()) == launches["warp2d"],
          f"the zoo paths' launches {dict(LAUNCHES)}")
    print(f"zoo paths: launches={launches}")
    print("zoo times " + json.dumps(times))
    return launches, times


def phase_perceptual(torch) -> dict:
    """``vgg_perceptual_loss`` forward and backward at [8, 224, 224, 3] on
    random VGG19 weights, card against CPU in float64 and float32 (see
    ``PERCEPTUAL_F64_GRAD_TOL``), and its time."""
    from opticalflowscivis_tpu_torch.losses import vgg_perceptual_loss
    from opticalflowscivis_tpu_torch.losses.perceptual import init_params

    rng = np.random.default_rng(5)
    x = rng.random(PERCEPTUAL_SHAPE)
    y = rng.random(PERCEPTUAL_SHAPE)
    out = {}
    for device in ("cuda", "cpu"):
        for dtype in (torch.float64, torch.float32):
            params = init_params(seed=0, dtype=dtype, device=device)
            xt = torch.from_numpy(x).to(device, dtype).requires_grad_(True)
            yt = torch.from_numpy(y).to(device, dtype).requires_grad_(True)
            loss = launches_only(torch, lambda: vgg_perceptual_loss(params, xt, yt), {})
            loss.backward()
            check(yt.grad is None, "the perceptual loss passed a gradient into y")
            out[device, dtype] = (float(loss.detach()), xt.grad.cpu().double())
    ref, ref_grad = out["cpu", torch.float64]

    def against_f64(device, dtype):
        loss, grad = out[device, dtype]
        return abs(loss - ref) / abs(ref), float((grad - ref_grad).norm() / ref_grad.norm())

    f64 = against_f64("cuda", torch.float64)
    f32, cpu32 = against_f64("cuda", torch.float32), against_f64("cpu", torch.float32)
    print(f"perceptual {list(PERCEPTUAL_SHAPE)} against the CPU's float64: card float64 loss "
          f"rel diff {f64[0]:.3e} tol={PERCEPTUAL_F64_LOSS_TOL:g}, d/dx relative L2 "
          f"{f64[1]:.3e} tol={PERCEPTUAL_F64_GRAD_TOL:g}; card float32 loss {f32[0]:.3e} "
          f"tol={PERCEPTUAL_F32_LOSS_TOL:g}, d/dx {f32[1]:.3e} (the CPU's float32: loss "
          f"{cpu32[0]:.3e}, d/dx {cpu32[1]:.3e}; tol 2x that + 1e-4)")
    check(f64[0] <= PERCEPTUAL_F64_LOSS_TOL and f64[1] <= PERCEPTUAL_F64_GRAD_TOL,
          "float64 perceptual loss or d/dx disagrees with the CPU")
    check(f32[0] <= PERCEPTUAL_F32_LOSS_TOL, "float32 perceptual loss disagrees with the CPU")
    check(f32[1] <= 2 * cpu32[1] + 1e-4, "float32 perceptual d/dx strays from the float64 one")
    params = init_params(seed=0)
    xs = [torch.from_numpy(x + 1e-3 * i).float().cuda().requires_grad_(True) for i in range(2)]
    yd = torch.from_numpy(y).float().cuda()

    def fwd_bwd(i):
        vgg_perceptual_loss(params, xs[i % 2], yd).backward()

    times = {"perceptual_fwd_bwd_ms": cuda_ms(fwd_bwd, iters=5, warmup=2)}
    print("perceptual times " + json.dumps(times))
    return times


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
        del interps, trainers  # free the 2-D models before the refinement
        torch.cuda.empty_cache()
        refine_worst = phase_refine_kernels(torch)
        refine_serving, refine_interps = phase_refine_serving(torch)
        refine_training, refine_trainers = phase_refine_training(torch, tmp)
        phase_refine_times(torch, refine_interps, refine_trainers)
        del refine_interps, refine_trainers  # free them before the volumes
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
        del upflow_predictors, upflow_trainers  # free the UPFlow models before KITTI
        torch.cuda.empty_cache()
        kitti_launches, kitti_eval_errs, _ = phase_kitti(torch, tmp)
        torch.cuda.empty_cache()
        phase_generators(torch)
        gen_launches, _ = phase_upflow_device_gen(torch, tmp)
        gen_launches.update(phase_rife3d_device_gen(torch, tmp))
        torch.cuda.empty_cache()
        vimeo_launches, _ = phase_vimeo(torch, tmp)
        torch.cuda.empty_cache()
        phase_lbs(torch, tmp)
        torch.cuda.empty_cache()
        dp_launches = phase_data_parallel(torch, tmp)
        sharded_launches, sharded = phase_sharded_warp(torch, tmp)
        protocol_launches = phase_eval_protocols(torch, tmp)
        phase_fastprep()
        torch.cuda.empty_cache()
        # last: the HD v2 zoo forward's profile holds about 10^5 kernel events,
        # after which an H100's profiler windows lost events (17 of 40)
        zoo_launches, _ = phase_zoo(torch, tmp)
        phase_perceptual(torch)

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
    # the KITTI training path (fit_kitti_hbm from the store), and the worst
    # float32 error at the 384 x 1280 evaluation levels
    by_name = {k["name"]: k for k in kernels}
    for name in ("warp2d", "warp2d_bwd", "corr", "corr_bwd"):
        by_name[name]["launches"] += kitti_launches[name]
        by_name[name]["launches_kitti_path"] = kitti_launches[name]
        by_name[name]["launches_per_kitti_train_step"] = PER_CALL["kitti_train_step"][name]
    for name in ("warp2d", "corr", "corr_bwd"):
        by_name[name]["kitti_eval_max_abs_err"] = kitti_eval_errs[name]
    # RIFE's refinement (2-D serving and training; the 3-D one's model warps)
    # and the pretrained zoo; the worst float32 errors at the Contextnet and
    # the legacy context levels
    refine_paths = {"warp2d": refine_serving["warp2d"] + refine_training["warp2d"],
                    "warp2d_bwd": refine_training["warp2d_bwd"],
                    "warp3d": refine_serving["warp3d"]}
    for name, n in refine_paths.items():
        by_name[name]["launches"] += n
        by_name[name]["launches_refine_paths"] = n
    by_name["warp2d"]["launches"] += zoo_launches["warp2d"]
    by_name["warp2d"]["launches_zoo_paths"] = zoo_launches["warp2d"]
    by_name["warp2d"]["launches_per_refine_forward"] = PER_CALL["refine_forward"]["warp2d"]
    by_name["warp2d"]["launches_per_refine_eval_step"] = PER_CALL["refine_eval_step"]["warp2d"]
    for name in ("warp2d", "warp2d_bwd"):
        by_name[name]["launches_per_refine_train_step"] = PER_CALL["refine_train_step"][name]
    by_name["warp2d_bwd"]["refine_train_step_calls_with_dimg"] = sum(
        c["need_dimg"] for c in WARP2D_LAYOUTS["refine_f32"])
    by_name["warp2d"]["launches_per_zoo_pair"] = {
        kind: PER_CALL[f"zoo_{kind}_pair"]["warp2d"] for kind in ZOO_WARPS}
    by_name["warp2d"]["refine_levels_max_abs_err"] = refine_worst["fwd"]
    by_name["warp2d_bwd"]["refine_levels_max_abs_err"] = refine_worst["bwd"]
    # the device-generated training paths (UPFlow on pan pairs, RIFE-3D on
    # boxes) and the Vimeo stream through fit_stream
    for name in by_name:
        n_gen, n_vimeo = gen_launches.get(name, 0), vimeo_launches.get(name, 0)
        by_name[name]["launches"] += n_gen + n_vimeo
        by_name[name]["launches_device_gen_paths"] = n_gen
        by_name[name]["launches_vimeo_path"] = n_vimeo
    for name in ("warp2d", "warp2d_bwd"):
        by_name[name]["launches_per_vimeo_train_step"] = PER_CALL["vimeo_train_step"][name]
    # phase 9b: the data-parallel dry runs (the NCCL rank's and gloo rank 0's
    # runs), the sharded 3-D warp (both ranks) and the evaluation protocols
    for name in by_name:
        n_dp, n_sharded = dp_launches.get(name, 0), sharded_launches.get(name, 0)
        n_eval = protocol_launches.get(name, 0)
        by_name[name]["launches"] += n_dp + n_sharded + n_eval
        by_name[name]["launches_dp_paths"] = n_dp
        by_name[name]["launches_sharded_warp"] = n_sharded
        by_name[name]["launches_eval_protocols"] = n_eval
        for model in ("rife", "upflow"):
            by_name[name][f"launches_per_dp_{model}_train_step"] = (
                PER_CALL[f"dp_{model}_train_step"].get(name, 0))
    for name in ("warp3d", "warp3d_bwd"):
        by_name[name]["sharded_warp"] = {
            "shape": [1, 1, SHARDED_SIZE, SHARDED_SIZE, SHARDED_SIZE], "r_z": SHARDED_R_Z,
            "ranks": 2, "backend": "gloo, one card", **sharded}
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
