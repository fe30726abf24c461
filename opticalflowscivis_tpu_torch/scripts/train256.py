"""256^3 volumetric training on one GPU.

Counterpart of the reference's ``scripts/train256.py``: RIFE-3D at full width
on ``rectangle_3d`` volumes of ``--grid``^3 (default 256), batch 1, with the
recipe that keeps full-size volumes in one device's memory:

- IFBlocks recomputed in the backward pass (``ModelConfig.remat``),
- the dataset resident on the device in bfloat16, flipped per sample there,
- ``--coarse_final``: the last student block and the teacher run at scale 2
  (scales (4, 2, 2), ``teacher_scale=2``), so no conv consumes a
  full-resolution input; warps, merge and losses stay at full resolution.

It trains a short schedule, then reports seconds per step (the whole ``fit``:
steps, the per-epoch evaluation and the checkpoint), the time of a train step
alone once warm, the interpolation PSNR on held-out tuples beside the
copy-frame and linear-average baselines, and the peak ``torch.cuda`` memory,
and writes ``<out>/train256_report.json``.

    python -m opticalflowscivis_tpu_torch.scripts.train256 [--grid 256] [--frames 33] [--epochs 3]

Differences from the reference's script: no ``--device_gen`` (its on-device
generators are not ported yet, ROADMAP A.11) and no XLA compiler options;
``--eval_only`` draws its held-out tuples from ``rectangle_3d(seed=7)`` on
the host.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a - b) ** 2))
    return float(10 * np.log10(1.0 / max(mse, 1e-12)))


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="train256")
    ap.add_argument("--frames", type=int, default=33)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--out", default="Results_256")
    ap.add_argument("--val_tuples", type=int, default=8,
                    help="held-out seed-7 tuples for the PSNR row of --eval_only")
    ap.add_argument("--coarse_final", action="store_true",
                    help="run the final IFBlock and the teacher at scale 2, so no "
                         "conv consumes a full-resolution input")
    ap.add_argument("--resume", action="store_true",
                    help="restore the run's checkpoint before training")
    ap.add_argument("--eval_only", action="store_true",
                    help="skip training: restore the run's checkpoint and compute "
                         "the quality row and the report")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)

    import torch

    from opticalflowscivis_tpu_torch.data import group_tuples, rectangle_3d
    from opticalflowscivis_tpu_torch.losses.rife import RIFELossWeights
    from opticalflowscivis_tpu_torch.training import ModelConfig, TrainConfig, Trainer

    g = args.grid
    grid, box = (g, g, g), (g // 4, g // 4, g // 4)

    def density_tuples(n_frames: int, seed: int) -> np.ndarray:
        # density only: the unsupervised 3-D recipe never reads the flow
        # channels, which would quadruple the host array
        arr = rectangle_3d(n_frames=n_frames, grid=grid, box=box, seed=seed, with_flow=False)
        return group_tuples(arr, 1).astype(np.float32, copy=False)

    if args.eval_only:
        print("eval_only: skipping the training data", flush=True)
        tuples, n = None, 0
    else:
        print(f"generating {args.frames} frames of {g}^3 ...", flush=True)
        t0 = time.time()
        tuples = density_tuples(args.frames, seed=11)
        n = tuples.shape[0]
        n_train = max(n - 2, 1)
        print(f"{n} tuples ({tuples.nbytes / 1e9:.1f} GB host f32) in {time.time() - t0:.0f}s",
              flush=True)

    coarse = {"scales": (4, 2, 2), "teacher_scale": 2} if args.coarse_final else {}
    cfg = TrainConfig(
        dataset="rectangle3d",
        batch_size=1,
        epochs=args.epochs,
        model=ModelConfig.preset_3d(remat=True, **coarse),
        loss=RIFELossWeights.preset_3d(),
        data_dir=os.path.join(args.out, "data"),
        log_dir=os.path.join(args.out, "log"),
        results_dir=args.out,
        device_flip_aug=True,
        hbm_dataset_dtype="bfloat16",
        keep_best_only=False,
    )
    tr = Trainer(cfg, device="cpu" if args.cpu else None)
    on_cuda = tr.device.type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(tr.device)

    report: dict = {"grid": g, "n_tuples": int(n), "device": str(tr.device),
                    "coarse_final": bool(args.coarse_final)}
    if args.eval_only:
        tr.init_state(total_steps=1)
        if not tr.load_checkpoint():
            raise SystemExit(f"--eval_only: no checkpoint at {tr.checkpoint_path()}")
        loss_json = os.path.join(tr.results_dir, "loss.json")
        if os.path.exists(loss_json):
            with open(loss_json) as f:
                rows = json.load(f)["val_loss"]
            report.update(epochs_completed=len(rows), val_loss_first=rows[0][0],
                          val_loss_final=rows[-1][0])
        report["val_set"] = "seed7"
        val = density_tuples(3 * args.val_tuples, seed=7)
    else:
        t0 = time.time()
        hist = tr.fit(tuples[:n_train], tuples[n_train:], log_every=1, resume=args.resume)
        if on_cuda:
            torch.cuda.synchronize(tr.device)
        wall = time.time() - t0
        steps = tr.steps_per_epoch * args.epochs
        report.update(
            seconds_per_step=wall / max(steps, 1),
            train_vols_per_sec=steps / wall,
            epochs=args.epochs,
            steps=steps,
            val_loss_first=hist[0]["loss_G"],
            val_loss_final=hist[-1]["loss_G"],
        )
        report["val_set"] = "tuples_tail"
        val = tuples[n_train:] if n > n_train else tuples[:1]

    # quality row: interpolation PSNR on the held-out tuples against the
    # copy-frame and linear-average baselines; batch 1, so that the eval
    # forward fits like the train step
    preds = []
    for i in range(val.shape[0]):
        _, extras = tr.predict(val[i : i + 1])
        preds.append(extras["pred"].float().cpu().numpy()[..., :1])
    pred = np.concatenate(preds, axis=0)
    gt, f0, f1 = (val[:, slot, ..., :1] for slot in (2, 0, 1))
    per = {
        "model": [_psnr(pred[i], gt[i]) for i in range(val.shape[0])],
        "copy": [_psnr(f0[i], gt[i]) for i in range(val.shape[0])],
        "linear": [_psnr((f0[i] + f1[i]) / 2, gt[i]) for i in range(val.shape[0])],
    }
    report.update(
        val_psnr_model=_psnr(pred, gt),
        val_psnr_copy_frame=_psnr(f0, gt),
        val_psnr_linear=_psnr((f0 + f1) / 2, gt),
        per_tuple_psnr={k: {"mean": float(np.mean(v)), "std": float(np.std(v))}
                        for k, v in per.items()},
    )

    if not args.eval_only:
        # a train step alone, warm: the fit's wall time above also holds the
        # kernels' build, cuDNN's algorithm search, the evaluation and the checkpoint
        batch = tr.upload(tuples[:1])
        times = []
        for _ in range(3):
            if on_cuda:
                torch.cuda.synchronize(tr.device)
            t0 = time.perf_counter()
            tr.train_step(batch)
            if on_cuda:
                torch.cuda.synchronize(tr.device)
            times.append(time.perf_counter() - t0)
        report["train_step_seconds"] = float(np.median(times))
    if on_cuda:
        report["cuda_peak_bytes"] = int(torch.cuda.max_memory_allocated(tr.device))
        report["cuda_device"] = torch.cuda.get_device_name(tr.device)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "train256_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
