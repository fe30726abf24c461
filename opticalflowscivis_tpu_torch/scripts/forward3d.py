"""Time the student-only ``ifnet_3d`` forward on one volume pair.

    python -m opticalflowscivis_tpu_torch.scripts.forward3d [--grid 256] [--batch 1] [--f32]

Full-width ``ifnet_3d`` with weights from seed 0 through
``Interpolator.forward`` on random ``[batch, 1, grid, grid, grid]`` volumes
already on the device: bfloat16 compute unless ``--f32``.  Prints one JSON
line: the median milliseconds per forward (host clock around a synchronise,
after a warm-up that also builds the kernels), volume pairs per second, the
``warp3d`` launches per forward and, on a GPU, the peak ``torch.cuda`` memory
and the card's name.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="forward3d")
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--f32", action="store_true", help="float32 compute instead of bfloat16")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)

    import torch

    from opticalflowscivis_tpu_torch.inference import Interpolator
    from opticalflowscivis_tpu_torch.models import ifnet_3d
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES

    dtype = None if args.f32 else torch.bfloat16
    interp = Interpolator(ifnet_3d(dtype=dtype, device="cpu" if args.cpu else None, seed=0),
                          device="cpu" if args.cpu else None)
    on_cuda = interp.device.type == "cuda"
    gen = torch.Generator(device=interp.device).manual_seed(0)
    shape = (args.batch, 1, args.grid, args.grid, args.grid)
    pairs = [(torch.rand(shape, generator=gen, device=interp.device),
              torch.rand(shape, generator=gen, device=interp.device)) for _ in range(2)]

    def forward(i: int) -> float:
        t0 = time.perf_counter()
        merged, _, _ = interp.forward(*pairs[i % 2])
        if on_cuda:
            torch.cuda.synchronize(interp.device)
        if not bool(torch.isfinite(merged.float()).all()):
            raise RuntimeError("the forward returned values that are not finite")
        return time.perf_counter() - t0

    forward(0)  # warm-up: kernel build, cuDNN's algorithm search
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(interp.device)
    before = LAUNCHES["warp3d"]
    seconds = float(np.median([forward(i) for i in range(args.iters)]))
    report = {
        "grid": args.grid, "batch": args.batch, "compute": "float32" if args.f32 else "bfloat16",
        "device": str(interp.device), "forward_ms": seconds * 1e3,
        "volume_pairs_per_sec": args.batch / seconds,
        "warp3d_launches_per_forward": (LAUNCHES["warp3d"] - before) / args.iters,
    }
    if on_cuda:
        report["cuda_peak_bytes"] = int(torch.cuda.max_memory_allocated(interp.device))
        report["cuda_device"] = torch.cuda.get_device_name(interp.device)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
