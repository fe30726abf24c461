"""Data-parallel dry run: one train step and a short fit of RIFE-2D and UPFlow.

The counterpart of the data-parallel half of the reference's
``__graft_entry__.dryrun_multichip``.  Run under ``torchrun``, each rank
takes its rows of one global batch; run alone, the plain one-device trainers
take the whole batch, which is what the ranks together must equal:

    torchrun --nproc_per_node 2 -m opticalflowscivis_tpu_torch.scripts.dryrun_dp \\
        --cpu --out /tmp/dp2                       # two gloo ranks on the CPU
    python -m opticalflowscivis_tpu_torch.scripts.dryrun_dp --cpu --out /tmp/dp1

``--size full`` trains at the models' full widths (``ifnet_2d`` at batch 64
on 128x128 rectangle tuples, UPFlow at 256x832 batch 8) on the card; the
default ``tiny`` size is for the CPU.  ``--backend gloo`` lets several ranks
share one card; ``--deterministic`` asks cuDNN for deterministic algorithms;
``--time_steps N`` times N more steps on the same batch after the first.
TF32 is off.  For
each model, rank 0 writes under ``<out>/<model>/``: ``step.pt`` (the step's
loss parts, every parameter's gradient, the kernel launches of the step and
of the whole run, the step's time), the fit's ``loss.json`` and its
checkpoint, in the one-device format.  UPFlow trains with the occlusion-normalised photometric
term, census and (tiny) the ex_runner's transformed-pair terms, on a box that
moves over a still background, so that the batch has occlusion.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def rife_setup(out: str, size: str, n_data: int | None):
    """(TrainConfig, train tuples, val tuples) of the RIFE-2D run."""
    from opticalflowscivis_tpu_torch.data import group_tuples, rectangle_2d
    from opticalflowscivis_tpu_torch.losses import RIFELossWeights
    from opticalflowscivis_tpu_torch.training import ModelConfig, OptimConfig, TrainConfig

    if size == "full":
        model, batch, grid, box = ModelConfig(bfloat16=False), 64, (128, 128), (40, 56)
    else:
        model = ModelConfig(block_channels=(16, 12, 8), teacher_channels=8, bfloat16=False)
        batch, grid, box = 8, (32, 32), (10, 14)
    cfg = TrainConfig(
        dataset="rectangle2d", epochs=1, batch_size=batch, n_data=n_data, model=model,
        loss=RIFELossWeights.preset_2d(flow_supervised=True),
        optim=OptimConfig(lr_max=1e-3, warmup_steps=5),
        data_dir=os.path.join(out, "rife", "data"), log_dir=os.path.join(out, "rife", "log"),
        results_dir=os.path.join(out, "rife", "res"),
    )
    # two train batches and half a batch to validate on, 3 frames a tuple
    frames = rectangle_2d(n_frames=3 * (2 * batch + batch // 2), grid=grid, box=box, seed=5)
    tuples = group_tuples(frames, 1)
    return cfg, tuples[: 2 * batch], tuples[2 * batch :]


def occluded_pairs(n: int, hw: tuple[int, int], seed: int, shift=(3, -4)) -> np.ndarray:
    """``[n, 2, H, W, 3]``: a smooth random background that stays still, and a
    smooth random box over it that moves by ``shift`` pixels from im1 to im2,
    so that the box's trailing edge uncovers background (occlusion)."""
    h, w = hw
    rng = np.random.default_rng(seed)

    def texture(k):
        coarse = torch.from_numpy(rng.uniform(0.05, 1.0, (k, 3, 8, 8)).astype(np.float32))
        return torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                               align_corners=True).permute(0, 2, 3, 1).numpy()

    bg, fg = texture(n), texture(n)
    bh, bw = h // 3, w // 3
    pairs = np.stack([bg, bg], axis=1).copy()
    for i in range(n):
        y, x = rng.integers(4, h - bh - 4), rng.integers(5, w - bw - 5)
        pairs[i, 0, y : y + bh, x : x + bw] = fg[i, y : y + bh, x : x + bw]
        y2, x2 = y + shift[0], x + shift[1]
        pairs[i, 1, y2 : y2 + bh, x2 : x2 + bw] = fg[i, y : y + bh, x : x + bw]
    return pairs


def upflow_setup(out: str, size: str, n_data: int | None):
    """(UPFlowTrainConfig, train pairs, val pairs, val flow) of the UPFlow run."""
    from opticalflowscivis_tpu_torch.losses import UPFlowLossConfig
    from opticalflowscivis_tpu_torch.models import UPFlowConfig
    from opticalflowscivis_tpu_torch.training import UPFlowTrainConfig

    # a loose occlusion threshold: untrained flows leave part of each pair visible
    loss = UPFlowLossConfig(photo_loss_use_occ=True, census_weight=1.0, occ_alpha_2=50.0)
    exp_dir = os.path.join(out, "upflow")
    if size == "full":
        cfg = UPFlowTrainConfig(batch_size=8, bfloat16=False, n_data=n_data, loss=loss,
                                exp_dir=exp_dir)
        hw = (256, 832)
    else:
        model = UPFlowConfig(num_chs=(3, 4, 8, 8, 12, 16, 16),
                             estimator_f_channels=(16, 16, 12, 8, 8),
                             context_f_channels=(16, 16, 16, 12, 8, 8, 2), search_range=2,
                             if_norm_before_cost_volume=True,
                             norm_moments_across_channels=False,
                             norm_moments_across_images=False)
        cfg = UPFlowTrainConfig(batch_size=4, bfloat16=False, n_data=n_data, loss=loss,
                                model=model, eq_weight=0.01, oi_weight=0.01, exp_dir=exp_dir)
        hw = (64, 64)
    pairs = occluded_pairs(2 * cfg.batch_size + 2, hw, seed=3)
    val_flow = np.zeros((2,) + hw + (2,), np.float32)  # the background's flow
    return cfg, pairs[:-2], pairs[-2:], val_flow


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _step_record(trainer, model: torch.nn.Module, step_fn, batch, time_steps: int) -> dict:
    """One train step on ``batch``: its parts, the averaged gradients and the
    kernel launches it made; then ``time_steps`` more on it, timed by the
    host's clock around work that ends in a synchronise."""
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES

    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    parts = step_fn(batch)
    _sync(trainer.device)
    rec = {
        "parts": {k: float(v) for k, v in parts.items()},
        "grads": {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
                  if p.grad is not None},
        "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES},
        "first_step_s": time.perf_counter() - t0,
    }
    if time_steps:
        t0 = time.perf_counter()
        for _ in range(time_steps):
            step_fn(batch)
        _sync(trainer.device)
        rec["step_ms"] = (time.perf_counter() - t0) * 1e3 / time_steps
    return rec


def run(out: str, size: str = "tiny", device: str | None = None,
        n_data: int | None = None, time_steps: int = 0) -> dict:
    """The dry run in this process: data-parallel over the default process
    group when one is initialised, else on one device."""
    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from opticalflowscivis_tpu_torch.training import Trainer, UPFlowTrainer

    result = {}
    reset_launches()
    cfg, train, val = rife_setup(out, size, n_data)
    tr = Trainer(cfg, device=device)
    tr.init_state(total_steps=1 + time_steps + train.shape[0] // cfg.batch_size)
    rec = _step_record(tr, tr.model, tr.train_step, tr.upload(train[: cfg.batch_size]),
                       time_steps)
    hist = tr.fit(train, val, epochs=1, log_every=0)
    _sync(tr.device)
    rec.update(val_loss=hist[-1], launches_run=dict(LAUNCHES))
    result["rife"] = rec

    reset_launches()
    ucfg, pairs, vpairs, vflow = upflow_setup(out, size, n_data)
    ut = UPFlowTrainer(ucfg, device=device)
    ut.init_state(steps_per_epoch=pairs.shape[0] // ucfg.batch_size)
    batch = ut._batch(ut.upload(pairs[: ucfg.batch_size]))
    rec = _step_record(ut, ut.net, ut.train_step, batch, time_steps)
    hist = ut.fit(pairs, epochs=1, log_every=0, val_pairs=vpairs, val_flow=vflow)
    _sync(ut.device)
    rec.update(epoch=hist[-1], launches_run=dict(LAUNCHES))
    result["upflow"] = rec

    if tr.is_writer:
        for name, r in result.items():
            torch.save(r, os.path.join(out, name, "step.pt"))
    return result


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="dryrun_dp", description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--size", choices=["tiny", "full"], default="tiny")
    p.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="default: nccl on the card, gloo on the CPU")
    p.add_argument("--threads", type=int, default=0, help="torch threads a rank (0: keep)")
    p.add_argument("--deterministic", action="store_true",
                   help="cuDNN's deterministic algorithms, no autotuning")
    p.add_argument("--time_steps", type=int, default=0,
                   help="time this many more steps on the first batch")
    p.add_argument("--coordinator", default=None,
                   help="rendezvous (host:port, tcp://, file://) without torchrun")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--timeout_s", type=float, default=600.0)
    args = p.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    # float32 throughout, so that runs compare within float32's tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    import torch.distributed as dist

    from opticalflowscivis_tpu_torch.parallel import initialize_multihost

    device = "cpu" if args.cpu else None
    info = initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                                device=device, timeout_s=args.timeout_s, backend=args.backend)
    try:
        result = run(args.out, args.size, device,
                     info["process_count"] if info["initialized"] else None, args.time_steps)
        if info["process_index"] == 0:
            print(json.dumps({"dryrun_dp": info, **{
                name: {k: r[k] for k in ("parts", "launches", "first_step_s", "step_ms")
                       if k in r}
                for name, r in result.items()}}), flush=True)
    finally:
        if info["initialized"]:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
