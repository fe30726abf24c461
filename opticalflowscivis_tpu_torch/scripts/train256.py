"""256^3 volumetric training on one GPU.

Counterpart of the reference's ``scripts/train256.py``: RIFE-3D at full width
on ``rectangle_3d`` volumes of ``--grid``^3 (default 256), batch 1, with the
recipe that keeps full-size volumes in one device's memory:

- IFBlocks recomputed in the backward pass (``ModelConfig.remat``),
- the dataset resident on the device in bfloat16, flipped per sample there,
- ``--coarse_final``: the last student block and the teacher run at scale 2
  (scales (4, 2, 2), ``teacher_scale=2``), so no conv consumes a
  full-resolution input; warps, merge and losses stay at full resolution;
- ``--device_gen N``: instead of a fixed host export, N fresh tuples an epoch
  composed on the device from box positions (``Trainer.fit_device_gen`` with
  ``data.box_density_device``, a new trajectory from ``default_rng(10_000 +
  epoch)`` each epoch, permuted).

It trains a short schedule, then reports seconds per step (the whole ``fit``:
steps, the per-epoch evaluation and the checkpoint), the time of a train step
alone once warm, the interpolation PSNR on held-out tuples beside the
copy-frame and linear-average baselines, and the peak ``torch.cuda`` memory,
and writes ``<out>/train256_report.json``.  With ``--device_gen`` or
``--eval_only`` the held-out tuples are ``--val_tuples`` boxes stamped at
``tuple_positions(default_rng(7))`` (``val_set`` "seed7_positions"), as the
reference stamps them; otherwise the tail of the training export
("tuples_tail").

    python -m opticalflowscivis_tpu_torch.scripts.train256 [--grid 256] [--frames 33] [--epochs 3]

Difference from the reference's script: no XLA compiler options.
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


def held_out_tuples(val_pos: np.ndarray, grid: tuple[int, ...],
                    box: tuple[int, ...]) -> np.ndarray:
    """``[N, 3, *grid, 1]`` float32: a constant-1 box at each of
    ``val_pos [N, 3, ndim]``, stamped on the host."""
    import torch

    from opticalflowscivis_tpu_torch.data.device_synthetic import box_density_device

    return box_density_device(torch.from_numpy(val_pos), grid, box).numpy()


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="train256")
    ap.add_argument("--frames", type=int, default=33)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--out", default="Results_256")
    ap.add_argument("--device_gen", type=int, default=0, metavar="N",
                    help="train on N fresh tuples an epoch composed on the device from "
                         "box positions, instead of a fixed host export")
    ap.add_argument("--val_tuples", type=int, default=8,
                    help="held-out seed-7 tuples for the PSNR row of --device_gen and "
                         "--eval_only")
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
    from opticalflowscivis_tpu_torch.data.device_synthetic import (
        box_density_device,
        tuple_positions,
    )
    from opticalflowscivis_tpu_torch.losses.rife import RIFELossWeights
    from opticalflowscivis_tpu_torch.training import ModelConfig, TrainConfig, Trainer

    g = args.grid
    grid, box = (g, g, g), (g // 4, g // 4, g // 4)
    tuples = None
    if args.eval_only:
        print("eval_only: skipping the training data", flush=True)
        n = 0
    elif args.device_gen:
        n = args.device_gen
        print(f"device-gen: {n} fresh tuples an epoch composed on the device at {g}^3",
              flush=True)
    else:
        print(f"generating {args.frames} frames of {g}^3 ...", flush=True)
        t0 = time.time()
        # density only: the unsupervised 3-D recipe never reads the flow
        # channels, which would quadruple the host array
        arr = rectangle_3d(n_frames=args.frames, grid=grid, box=box, seed=11, with_flow=False)
        tuples = group_tuples(arr, 1).astype(np.float32, copy=False)
        del arr
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
    val_pos = tuple_positions(np.random.default_rng(7), args.val_tuples, grid, box)
    hist = None
    t0 = time.time()
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
    elif args.device_gen:
        def pos_sampler(epoch: int) -> np.ndarray:
            # permuted: a velocity holds for up to max_seq frames, so tuples in
            # trajectory order would share one velocity
            rng = np.random.default_rng(10_000 + epoch)
            return tuple_positions(rng, n, grid, box)[rng.permutation(n)]

        report["device_gen"] = True
        hist = tr.fit_device_gen(lambda pos: box_density_device(pos, grid, box), pos_sampler,
                                 val_pos, steps_per_epoch=n, log_every=10, resume=args.resume)
    else:
        hist = tr.fit(tuples[:n_train], tuples[n_train:], log_every=1, resume=args.resume)
    if hist:
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
    if tuples is None:
        # boxes stamped at the seed-7 positions, equal to the device's frames;
        # for --eval_only of a run trained on an export this is not the set
        # its loss.json used, hence the name in the report
        report["val_set"] = "seed7_positions"
        val = held_out_tuples(val_pos, grid, box)
    else:
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
        batch = tr.upload(val[:1])
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
