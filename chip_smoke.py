#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds every Hopper kernel of the port from the sources in this checkout,
holds each kernel against its plain PyTorch version on the card, drives the
two main paths at the full width of ``ifnet_2d`` and shows that each went
through the kernels: interpolation serving (``Interpolator``,
``interpolate_series``) and training (``Trainer.fit``, then the CLI verbs
generate → train → test → inference_video).  It compares both with the same
weights on the CPU, and times them.

Phases, printed in order:
  1. card: ``nvidia-smi`` name and power limit, torch / CUDA versions, build time;
  2. kernel vs plain on the card, forward and backward, every case against a
     stated tolerance;
  3. serving path at full width, f32 and bf16, with launch counts, the CPU
     comparison and the series metrics against the linear baseline;
  4. training path at full width, f32 and bf16: ``fit`` lowers ``loss_G``,
     10 forward and 10 backward launches per train step (10 / 0 per eval
     step), ``loss.json``, checkpoint round trip; one train step against the
     CPU; the CLI verbs;
  5. times (CUDA events, warm-up, inputs that vary from call to call) and
     profiles of both paths;
  6. one ``{"kernels": [...]}`` line.
The last line is ``{"ok": true, "device": {...}}``.  Any failure raises, so
the script exits nonzero and prints no result; it also does so without a
CUDA device or without the port beside it.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# H100 SXM published peaks (NVIDIA data sheet), used for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

WARP_SHAPE = (32, 160, 224, 1)  # [B, H, W, C] of the serving path's warps
TRAIN_SHAPE = (64, 128, 128, 1)  # [B, H, W, C] of the training path's warps
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


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke failed: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn(i)`` by CUDA events."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def is_kernel(ev, device_type) -> bool:
    """A device-side profiler event that is work of the card, not an
    annotated range (``Optimizer.step#...``), whose span would count the
    kernels under it twice and the gaps between them as device time."""
    annotated = getattr(ev, "is_user_annotation", False) or ev.key.startswith("Optimizer.")
    return ev.device_type == device_type.CUDA and not annotated


def device_ms(fn, iters: int, only: str | None = None) -> float:
    """Mean device milliseconds per call of ``fn(i)``: the time the card's
    kernels ran, from torch.profiler (CUPTI), without the host's launch cost
    that a back-to-back CUDA-event timing of a short kernel also measures.
    ``only`` keeps the kernels whose name holds that string."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    total_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                   if is_kernel(ev, DeviceType) and (only is None or only in ev.key))
    check(total_us > 0, "the profiler recorded no device time")
    return total_us / iters / 1e3


def bf16_ulp(x):
    """One bf16 ulp at the magnitude of each element of ``x`` (float32 tensor)."""
    import torch

    mag = x.abs().clamp_min(2.0**-126)
    return torch.pow(2.0, torch.floor(torch.log2(mag)) - 7)


def warp_inputs(shape, dtype, seed: int, scale: float = 10.0, channels_last=False):
    """Image and a (dy, dx) flow that is a channel slice of a 4-channel flow,
    as the model passes it (NCHW, or the channels-last layout cuDNN may
    produce); N(0, scale) flows, some beyond ±16."""
    import torch

    b, h, w, c = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand((b, c, h, w), generator=g, device="cuda").to(dtype)
    flow4 = (torch.randn((b, 4, h, w), generator=g, device="cuda") * scale).to(dtype)
    if channels_last:
        flow4 = flow4.contiguous(memory_format=torch.channels_last)
    return img, flow4[:, 2:4]


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}")
    from opticalflowscivis_tpu_torch.ops.kernels.build import build

    t0 = time.perf_counter()
    libs = build(["warp2d"])  # one source holds the forward and the backward kernel
    print(f"kernel build: {time.perf_counter() - t0:.2f} s  "
          f"{[str(p.relative_to(REPO)) for p in libs.values()]}")
    return smi


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
    return worst_f32


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
        "kernel_launches": sum(n for _, _, n in kernels) // iters,
        "top": [{"kernel": k[:70], "share": t / max(total, 1e-9), "launches": n // iters}
                for k, t, n in top],
    }))


def phase_times(torch, interps):
    import torch.nn.functional as F

    from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d
    from opticalflowscivis_tpu_torch.ops.warp import warp2d_plain

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

    # warp at the main path's shape: f32, border, r=16, flow a 2-channel slice
    sets = [warp_inputs(WARP_SHAPE, torch.float32, 200 + i) for i in range(4)]

    def kernel(i):
        return warp2d(*sets[i % 4], 16, "border")

    def plain(i):
        return warp2d_plain(*sets[i % 4], 16, "border")

    ys = torch.arange(h, device="cuda", dtype=torch.float32).view(1, h, 1)
    xs = torch.arange(w, device="cuda", dtype=torch.float32).view(1, 1, w)
    grids = []
    for img, flow in sets:
        gx = 2.0 * (xs + flow[:, 1]) / (w - 1) - 1.0
        gy = 2.0 * (ys + flow[:, 0]) / (h - 1) - 1.0
        grids.append((img, torch.stack([gx, gy], dim=-1)))

    def library(i):
        return F.grid_sample(*grids[i % 4], mode="bilinear", padding_mode="border",
                             align_corners=True)

    kernel_ms, plain_ms, library_ms = (device_ms(f, 40) for f in (kernel, plain, library))
    # back-to-back calls timed by CUDA events: device time or the host's
    # per-call cost, whichever is larger
    call_ms = {name: cuda_ms(f, 40) for name, f in
               (("kernel", kernel), ("plain", plain), ("library", library))}
    px = b * h * w
    bytes_moved = px * (4 * c + 8 + 4 * c)  # img read, (dy, dx) read, out written
    flops = px * (24 + 7 * c)  # clip, coords, floor, fractions, 4 weights; 4 taps/ch
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    warp = {
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": bytes_moved,
        "back_to_back_call_ms": call_ms,
        "achieved_GBps": bytes_moved / (kernel_ms / 1e3) / 1e9,
    }
    print("times " + json.dumps(times))
    print("warp2d times " + json.dumps(warp) + "  (bound: H100 SXM 3.35 TB/s, 67 TFLOP/s f32)")
    return times, warp


def backward_inputs(torch, shape, dtype, seed: int, channels_last: bool):
    """Image, 4-channel flow (the warp takes its last two channels) and an
    incoming gradient; flow and gradient in NCHW or channels-last layout."""
    b, h, w, c = shape
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand((b, c, h, w), generator=gen, device="cuda").to(dtype)
    # off-integer flows: at an integer coordinate the bilinear weights have a kink
    flow4 = torch.randn((b, 4, h, w), generator=gen, device="cuda") * 10.0
    flow4 = (torch.round(flow4 * 4) / 4 + 0.11).to(dtype).contiguous(memory_format=fmt)
    g = torch.randn((b, c, h, w), generator=gen, device="cuda").to(dtype)
    return img, flow4, g.contiguous(memory_format=fmt)


def warp_grads(torch, fn, img, flow4, g, r, padding, img_grad: bool):
    """(dimg or None, dflow [B, 2, H, W]) of ``fn`` through autograd."""
    im = img.detach().clone().requires_grad_(img_grad)
    fl = flow4.detach().clone(memory_format=torch.preserve_format).requires_grad_(True)
    fn(im, fl[:, 2:4], r, padding).backward(g)
    return im.grad, fl.grad[:, 2:4]


def phase_backward_vs_plain(torch):
    """The backward kernel against autograd through the plain version."""
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
                        name = str(dtype).replace("torch.", "")
                        shown = " ".join(f"{k}_err={e:.3e} (max|ref|={m:.3e})"
                                         for k, (e, m) in errs.items())
                        print(f"warp2d_bwd {list(shape)} {padding:6s} r={r:2d} {name:8s} "
                              f"{'nhwc' if cl else 'nchw'} img_grad={int(img_grad)} {shown} "
                              f"tol={tol:g}*max|ref| {'ok' if ok else 'FAIL'}")
                        check(ok, f"warp2d backward disagrees with plain ({shape}, {padding}, "
                                  f"r={r}, {name}, img_grad={img_grad})")
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
    epochs, steps_per_epoch, n_val = 9, 4, 16
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
        counts = dict(LAUNCHES)  # read just after the run
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

        ours = tr.evaluate(val, b)
        again, theirs = rel_diff(ours, tr.evaluate(val, b)), rel_diff(ours, fresh.evaluate(val, b))
        # the same trainer evaluated twice sets the scale: in bf16 the card's
        # convolutions do not repeat bit for bit from run to run
        tol = 1e-6 if not bfloat16 else 1e-3
        print(f"checkpoint {name}: restored step {fresh.state.step}, weights equal, evaluate "
              f"rel diff {theirs:.3e} (same trainer twice: {again:.3e}) tol={tol:g}")
        check(theirs <= tol, f"{name}: the restored trainer evaluates differently")
        trainers[name] = (tr, train)
    print(f"training path: launches={launches}")
    check(all(v > 0 for v in launches.values()), "the training path missed a kernel")
    return launches, trainers


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
        delta = {k: LAUNCHES[k] - before[k] for k in before}
        check(delta == ({"warp2d": 10, "warp2d_bwd": 10} if device == "cuda"
                        else {"warp2d": 0, "warp2d_bwd": 0}), f"{device} step launches {delta}")
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
    delta = {k: LAUNCHES[k] - before[k] for k in before}
    print(f"cli: generate, train, test, inference_video ok; launches={delta}")
    check(all(v > 0 for v in delta.values()), "the CLI run missed a kernel")


def phase_train_times(torch, trainers):
    """Train steps per second, a profile of three steps, and the backward
    kernel alone against its plain version, its bound and ``F.grid_sample``."""
    import torch.nn.functional as F

    from opticalflowscivis_tpu_torch.ops.kernels.warp import _launch_backward
    from opticalflowscivis_tpu_torch.ops.warp import warp2d_plain

    b, h, w, c = TRAIN_SHAPE
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

    # the backward kernel at the training path's shape: f32, border, r = 16
    sets = [backward_inputs(torch, TRAIN_SHAPE, torch.float32, 300 + i, False) for i in range(4)]

    def clipped_grid(flow):
        fl = torch.where(flow.abs() < 16, flow, torch.sign(flow.detach()) * 16)
        ys = torch.arange(h, device="cuda", dtype=torch.float32).view(1, h, 1)
        xs = torch.arange(w, device="cuda", dtype=torch.float32).view(1, 1, w)
        gx = 2.0 * (xs + fl[:, 1]) / (w - 1) - 1.0
        gy = 2.0 * (ys + fl[:, 0]) / (h - 1) - 1.0
        return torch.stack([gx, gy], dim=-1)

    out = {}
    px = b * h * w
    for with_dimg in (False, True):
        graphs = {"plain": [], "library": []}
        for img, flow4, g in sets:
            for kind in graphs:
                im = img.clone().requires_grad_(with_dimg)
                fl = flow4[:, 2:4].clone().requires_grad_(True)
                if kind == "plain":
                    res = warp2d_plain(im, fl, 16, "border")
                else:
                    res = F.grid_sample(im, clipped_grid(fl), mode="bilinear",
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
        # bytes the function must move: image, flow and g read, dflow written,
        # and with dimg that written too; the design also zero-fills the f32
        # accumulator and reads it back under the atomics
        function_bytes = px * (4 * c + 8 + 4 * c + 8 + (4 * c if with_dimg else 0))
        design_bytes = function_bytes + (px * 8 * c if with_dimg else 0)
        flops = px * (30 + 16 * c + (8 * c if with_dimg else 0))
        bytes_ms = function_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        kernel_only = device_ms(kernel, 40, only="warp2d_bwd_kernel")
        out[tag] = {
            "kernel_ms": kernel_only,
            "call_device_ms": device_ms(kernel, 40),  # with the zero-fill
            "plain_ms": device_ms(through("plain"), 20),
            "library_ms": device_ms(through("library"), 20),
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
    return times, out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA device",
              file=sys.stderr)
        return 1
    import opticalflowscivis_tpu_torch  # noqa: F401  (fails when run outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    smi = phase_card(torch)
    worst_f32 = phase_kernel_vs_plain(torch)
    worst_bwd_f32 = phase_backward_vs_plain(torch)
    launches, interps = phase_main_path(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        train_launches, trainers = phase_training(torch, tmp)
        phase_train_step_vs_cpu(torch, tmp)
        phase_cli(torch, tmp)
        times, warp = phase_times(torch, interps)
        train_times, bwd = phase_train_times(torch, trainers)

    source = "opticalflowscivis_tpu_torch/csrc/warp2d.cu"
    kernels = [{
        "name": "warp2d",
        "route": "cuda",
        "source": source,
        "replaces": "opticalflowscivis_tpu/ops/pallas/warp.py:217",
        "launches": launches + train_launches["warp2d"],
        "launches_serving_path": launches,
        "launches_training_path": train_launches["warp2d"],
        "launches_per_forward": 6,
        "launches_per_train_step": 10,
        "max_abs_err": worst_f32,
        "ms": warp["kernel_ms"],
        "plain_ms": warp["plain_ms"],
        "bound_ms": warp["bound_ms"],
        "bound_by": warp["bound_by"],
        "library_ms": warp["library_ms"],
        "shape": list(WARP_SHAPE),
        "card": smi,
    }, {
        # ms, bound and the other times are those of the call without an
        # image gradient (8 of the 10 calls of a train step)
        "name": "warp2d_bwd",
        "route": "cuda",
        "source": source,
        "replaces": "opticalflowscivis_tpu/ops/pallas/warp.py:274",
        "launches": train_launches["warp2d_bwd"],
        "launches_per_train_step": 10,
        "max_abs_err": worst_bwd_f32,
        "ms": bwd["dflow_only"]["kernel_ms"],
        "plain_ms": bwd["dflow_only"]["plain_ms"],
        "bound_ms": bwd["dflow_only"]["bound_ms"],
        "bound_by": bwd["dflow_only"]["bound_by"],
        "library_ms": bwd["dflow_only"]["library_ms"],
        "with_dimg": {k: bwd["with_dimg"][k] for k in
                      ("kernel_ms", "call_device_ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms")},
        "shape": list(TRAIN_SHAPE),
        "card": smi,
    }]
    print(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
