"""Standard VFI evaluation protocols — ports of ``Flow-2D/benchmark/*``.

The counterpart of the reference package's ``evalsuite/benchmarks.py``.  Each
function takes an interpolator (any object with ``pair`` and
``pad_multiple``: ``inference.Interpolator`` around a trained IFNet, or
``inference.ZooInterpolator`` around a pretrained zoo model) plus a dataset
root and returns the protocol's metrics:

- ``bench_triplet_dirs``  ⇔ UCF101.py / ATD12K-style: directories with
  (frame_00, frame_02, frame_01_gt) pngs → mean PSNR/SSIM, with the reference's
  round-to-uint8 quantization before scoring (UCF101.py:32-35).
- ``bench_vimeo90k``      ⇔ Vimeo90K.py: the tri_testlist triplets.
- ``bench_middlebury``    ⇔ MiddleBury_Other.py: interpolation error (IE — mean
  abs diff in the 255 range) over the 12 Other sequences.
- ``bench_latency``       ⇔ testtime.py:17-29: timed forwards at 1x480x640
  after warm-up, on inputs that live on the device and change from call to
  call; CUDA events on the card, the host's clock on the CPU.
- ``bench_hd_yuv``        ⇔ HD.py / HD_multi_4X.py: Y-PSNR on raw yuv420
  sequences through ``inference.interpolate_recursive``.

These are the evaluation protocols of the interpolation literature, not the
port's performance benchmark.  PNGs are read with cv2, imported where a
reader needs it.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from opticalflowscivis_tpu_torch.data.yuv_io import YUVReader, rgb2yuv
from opticalflowscivis_tpu_torch.evalsuite.metrics import calculate_ssim
from opticalflowscivis_tpu_torch.inference import interpolate_recursive


def _load_rgb(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img[..., ::-1].astype(np.float32) / 255.0


def _score_pair(pred: np.ndarray, gt: np.ndarray) -> tuple[float, float]:
    pred = np.round(pred * 255.0) / 255.0  # uint8 quantization (UCF101.py:33)
    psnr = -10 * math.log10(max(float(((gt - pred) ** 2).mean()), 1e-12))
    ssim = calculate_ssim(pred * 255.0, gt * 255.0)
    return psnr, ssim


def _score_triplets(interp, triplets) -> dict:
    """Mean PSNR / SSIM of ``interp.pair`` over ``(img0, img1, gt)`` paths."""
    psnrs, ssims = [], []
    for p0, p1, pg in triplets:
        img0, img1, gt = _load_rgb(p0), _load_rgb(p1), _load_rgb(pg)
        pred, _, _ = interp.pair(img0[None], img1[None])
        p, s = _score_pair(pred[0], gt)
        psnrs.append(p)
        ssims.append(s)
    return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)), "n": len(psnrs)}


def bench_triplet_dirs(
    interp,
    root: str,
    frame0: str = "frame_00.png",
    frame1: str = "frame_02.png",
    gt_name: str = "frame_01_gt.png",
    limit: int = 0,
) -> dict:
    dirs = sorted(os.listdir(root))
    if limit:
        dirs = dirs[:limit]
    return _score_triplets(interp, [
        tuple(os.path.join(root, d, name) for name in (frame0, frame1, gt_name))
        for d in dirs])


def bench_vimeo90k(interp, root: str, limit: int = 0) -> dict:
    """Vimeo90K's test list (``tri_testlist.txt``): im1 and im3 in, im2 scored."""
    with open(os.path.join(root, "tri_testlist.txt")) as f:
        triplets = [line.strip() for line in f if line.strip()]
    if limit:
        triplets = triplets[:limit]
    return _score_triplets(interp, [
        tuple(os.path.join(root, "sequences", tri, name)
              for name in ("im1.png", "im3.png", "im2.png"))
        for tri in triplets])


_MIDDLEBURY = ["Beanbags", "Dimetrodon", "DogDance", "Grove2", "Grove3",
               "Hydrangea", "MiniCooper", "RubberWhale", "Urban2", "Urban3",
               "Venus", "Walking"]


def bench_middlebury(interp, data_root: str, gt_root: str) -> dict:
    """Interpolation error (mean abs diff, 255 range) per sequence."""
    ies = {}
    for name in _MIDDLEBURY:
        img0 = _load_rgb(os.path.join(data_root, name, "frame10.png"))
        img1 = _load_rgb(os.path.join(data_root, name, "frame11.png"))
        gt = _load_rgb(os.path.join(gt_root, name, "frame10i11.png"))
        pred, _, _ = interp.pair(img0[None], img1[None])
        ie = float(np.mean(np.abs(pred[0] - gt) * 255.0))
        ies[name] = round(ie, 3)
    ies["mean"] = round(float(np.mean(list(ies.values()))), 3)
    return ies


LATENCY_PAIRS = 4  # distinct input pairs bench_latency cycles through


def bench_latency(
    interp, shape: tuple[int, int, int] = (480, 640, 3), warmup: int = 10,
    iters: int = 50,
) -> dict:
    """testtime.py's protocol: the best of 3 mean latencies of the model's
    forward (``interp.forward`` on channels-first device tensors) on a
    1 x ``shape`` pair padded to ``interp.pad_multiple``.

    The inputs are made on the device once, ``LATENCY_PAIRS`` distinct pairs
    from a seed, and each call takes the next one, so that no two consecutive calls
    see the same input and no host upload is timed.  On the card the time is
    read from CUDA events around ``iters`` calls after ``warmup`` calls; on
    the CPU from the host's clock."""
    m = interp.pad_multiple
    padded = tuple(s + (-s) % m for s in shape[:-1])
    device = interp.device
    gen = torch.Generator(device="cpu").manual_seed(0)
    pairs = [
        tuple(torch.rand((1, shape[-1]) + padded, generator=gen).to(device) for _ in range(2))
        for _ in range(LATENCY_PAIRS)
    ]

    def run(n: int, start: int) -> None:
        for i in range(start, start + n):
            interp.forward(*pairs[i % len(pairs)])

    run(max(warmup, 1), 0)
    best = float("inf")
    for r in range(3):
        if device.type == "cuda":
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            begin.record()
            run(iters, r)
            end.record()
            end.synchronize()
            seconds = begin.elapsed_time(end) / 1000.0
        else:
            t0 = time.perf_counter()
            run(iters, r)
            seconds = time.perf_counter() - t0
        best = min(best, seconds / iters)
    return {"mean_latency_ms": round(best * 1000, 3),
            "pairs_per_sec": round(1.0 / best, 2)}


# ---- HD yuv benchmarks (benchmark/HD.py, HD_multi_4X.py) -------------------

HD_NAME_LIST = [
    ("HD_dataset/HD720p_GT/parkrun_1280x720_50.yuv", 720, 1280),
    ("HD_dataset/HD720p_GT/shields_1280x720_60.yuv", 720, 1280),
    ("HD_dataset/HD720p_GT/stockholm_1280x720_60.yuv", 720, 1280),
    ("HD_dataset/HD1080p_GT/BlueSky.yuv", 1080, 1920),
    ("HD_dataset/HD1080p_GT/Kimono1_1920x1080_24.yuv", 1080, 1920),
    ("HD_dataset/HD1080p_GT/ParkScene_1920x1080_24.yuv", 1080, 1920),
    ("HD_dataset/HD1080p_GT/sunflower_1080p25.yuv", 1080, 1920),
    ("HD_dataset/HD544p_GT/Sintel_Alley2_1280x544.yuv", 544, 1280),
    ("HD_dataset/HD544p_GT/Sintel_Market5_1280x544.yuv", 544, 1280),
    ("HD_dataset/HD544p_GT/Sintel_Temple1_1280x544.yuv", 544, 1280),
    ("HD_dataset/HD544p_GT/Sintel_Temple2_1280x544.yuv", 544, 1280),
]


def _hd_pad(h: int) -> int:
    """Replication-pad rows so /32 shapes hold (HD.py:65-70)."""
    return 24 if h == 720 else 4 if h == 1080 else 16


def _y_psnr(gt_rgb: np.ndarray, out_rgb: np.ndarray) -> float:
    """Y-channel PSNR with the reference's 128-offset diff (HD.py:80-83)."""
    diff = (rgb2yuv(gt_rgb / 255.0)[..., 0] * 255
            - rgb2yuv(out_rgb / 255.0)[..., 0] * 255)
    mse = float(np.mean(diff ** 2))
    return 20 * math.log10(255.0 / math.sqrt(max(mse, 1e-12)))


def bench_hd_yuv(
    interp, root: str, multi: int = 1, max_index: int = 100,
    name_list=None,
) -> dict:
    """HD yuv suite: 2x midpoint (``multi=1``, HD.py:47-88) or 4x
    (``multi=2``, HD_multi_4X.py:64-103 non-arbitrary recursive path).

    Frames are replication-padded in rows, interpolated, uint8-rounded, and
    scored with Y-channel PSNR; the summary groups 544p/720p/1080p means like
    HD_multi_4X.py:105.
    """
    per_seq = {}
    step = 2 ** multi
    for name, h, w in (name_list or HD_NAME_LIST):
        path = os.path.join(root, name)
        if not os.path.exists(path):
            continue
        pad = _hd_pad(h)
        psnrs = []
        with YUVReader(path, h, w) as reader:
            for index in range(0, max_index, step):
                i0, ok0 = reader.read(index)
                i1, ok1 = reader.read(index + step)
                if not (ok0 and ok1):
                    break
                gts = []
                for k in range(1, step):
                    g, okg = reader.read(index + k)
                    if okg:
                        gts.append(g)
                a = np.pad(i0.astype(np.float32) / 255.0,
                           ((pad, pad), (0, 0), (0, 0)), mode="edge")
                b = np.pad(i1.astype(np.float32) / 255.0,
                           ((pad, pad), (0, 0), (0, 0)), mode="edge")
                mids = interpolate_recursive(interp, a[None], b[None], step - 1)
                for g, m in zip(gts, mids):
                    out = np.round(
                        np.clip(m[0][pad:-pad], 0, 1) * 255).astype(np.uint8)
                    psnrs.append(_y_psnr(g.astype(np.float64), out))
        if psnrs:
            per_seq[name] = round(float(np.mean(psnrs)), 3)
    groups: dict[str, list] = {}
    for (name, h, _w) in (name_list or HD_NAME_LIST):
        if name in per_seq:
            groups.setdefault(f"{h}p", []).append(per_seq[name])
    summary = {k: round(float(np.mean(v)), 3) for k, v in groups.items() if v}
    if per_seq:
        summary["mean"] = round(float(np.mean(list(per_seq.values()))), 3)
    return {"per_sequence": per_seq, **summary}
