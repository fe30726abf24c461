"""CLI dispatcher: ``python -m opticalflowscivis_tpu_torch.cli <verb> [flags]``.

The RIFE verbs of ``opticalflowscivis_tpu.cli`` with the same flags, on 2-D and
3-D datasets; the UPFlow verbs ``train_upflow`` / ``test_upflow`` on the
SciVis datasets and on KITTI (multiview training, the Evaluation_bench
protocol); and ``select``, time-step selection.  ``--cpu`` selects
``device="cpu"``; without it every verb runs on the GPU and raises when there
is none.  ``train`` and ``train_upflow`` train data-parallel when launched by
``torchrun`` (one process a device; NCCL, or gloo with ``--cpu``):
``torchrun --nproc_per_node k -m opticalflowscivis_tpu_torch.cli train
--config_json cfg.json`` with ``"n_data": k`` in the json; ``train`` also
spatially sharded, with ``"n_space"`` and ``"spatial_shard": true`` there (k
processes form the ``(k / n_space, n_space)`` mesh).  The verbs that draw panels import the plotting module inside their
drawing step: without matplotlib they say so in one line and write their
reports all the same.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import numpy as np

# verbs that wait for a later slice, with the ROADMAP item that brings them
WAITING_VERBS = {
    "bench": "the port's bench comes with the first benchmark (ROADMAP A.7)",
}


ZOO_HELP = ("pretrained RIFE HD/HDv2/HDv3 checkpoint dir (upstream torch pkl files) "
            "instead of a framework checkpoint")


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--dataset", default="rectangle2d")
    p.add_argument("--exp", type=int, default=1, help="interpolate 2**exp x")
    p.add_argument("--data_dir", default="data_cache")
    p.add_argument("--results_dir", default="Results")
    p.add_argument("--log_dir", default="train_log")
    p.add_argument("--model_name", default="flownet")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    p.add_argument("--config_json", default=None,
                   help="path to a TrainConfig json overriding flags")


def _device(args) -> str | None:
    return "cpu" if args.cpu else None


@contextlib.contextmanager
def _process_group(args):
    """The default process group of a ``torchrun`` launch (none without one),
    destroyed when the verb ends."""
    import torch.distributed as dist

    from opticalflowscivis_tpu_torch.parallel.multihost import initialize_multihost

    info = initialize_multihost(device=_device(args))
    try:
        yield info
    finally:
        if info["initialized"] and dist.is_initialized():
            dist.destroy_process_group()


def _viz():
    """The plotting module, or None after one line saying that the panels
    are not drawn, where matplotlib is missing."""
    try:
        from opticalflowscivis_tpu_torch import viz
    except ImportError as e:
        if not (e.name or "").startswith("matplotlib"):
            raise
        print("panels not drawn: matplotlib is missing", flush=True)
        return None
    return viz


def _build_cfg(args, epochs=None, batch_size=None):
    from opticalflowscivis_tpu_torch.data import get_spec
    from opticalflowscivis_tpu_torch.losses.rife import RIFELossWeights
    from opticalflowscivis_tpu_torch.training import ModelConfig, TrainConfig

    if args.config_json:
        with open(args.config_json) as f:
            return TrainConfig.from_json(f.read())
    spec = get_spec(args.dataset)
    volumes = spec.ndim == 3
    if volumes:
        # remat: the reference's 3-D recipe recomputes the IFBlocks in the
        # backward pass to fit volume batches into device memory
        model = ModelConfig.preset_3d(remat=True)
        loss = RIFELossWeights.preset_3d()
    else:
        model = ModelConfig.preset_2d()
        loss = RIFELossWeights.preset_2d(flow_supervised=getattr(args, "flow_supervised", False))
    if getattr(args, "distill", None) is not None:
        loss = dataclasses.replace(loss, distill=args.distill)
    return TrainConfig(
        dataset=args.dataset,
        exp=args.exp,
        epochs=epochs if epochs is not None else getattr(args, "epochs", 300),
        batch_size=batch_size if batch_size is not None else getattr(args, "batch_size", None),
        data_dir=args.data_dir,
        results_dir=args.results_dir,
        log_dir=args.log_dir,
        model_name=args.model_name,
        model=model,
        loss=loss,
        early_stop_patience=1000 if volumes else 0,
        keep_best_only=volumes,
        # On-device flip augmentation whenever the dataset flips: equal to the
        # host augmentation (tested) with 4x fewer resident bytes.  Volumes are
        # also kept in bfloat16 on the device.
        device_flip_aug=spec.flip_aug,
        hbm_dataset_dtype="bfloat16" if volumes else "float32",
    )


def _restored_trainer(cfg, args):
    """A ``Trainer`` with the run's checkpoint loaded (fresh weights when
    there is none, as the reference does)."""
    from opticalflowscivis_tpu_torch.training import Trainer

    tr = Trainer(cfg, device=_device(args))
    tr.init_state(total_steps=1)
    tr.load_checkpoint()
    return tr


def cmd_train(argv):
    p = argparse.ArgumentParser(prog="train")
    _add_common(p)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--flow_supervised", action="store_true")
    p.add_argument("--distill", type=float, default=None,
                   help="override the distill lambda (default 0.01 in 2-D, 0 in 3-D)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--vimeo_root", default=None,
                   help="Vimeo90K triplet root (required for --dataset vimeo2d)")
    p.add_argument("--steps_per_epoch", type=int, default=0,
                   help="streamed datasets (vimeo2d): steps per epoch "
                        "(0 = len(dataset) // batch)")
    args = p.parse_args(argv)
    with _process_group(args):
        _train(args)


def _train(args):
    from opticalflowscivis_tpu_torch.training import Trainer

    cfg = _build_cfg(args)
    tr = Trainer(cfg, device=_device(args))
    if cfg.dataset == "vimeo2d":
        # triplets streamed from the host, a fresh random crop each step
        if not args.vimeo_root:
            raise SystemExit("--dataset vimeo2d requires --vimeo_root")
        from opticalflowscivis_tpu_torch.data.vimeo import VimeoDataset

        batch = cfg.batch_size or 16
        ds = VimeoDataset(args.vimeo_root, split="train")
        ds_val = VimeoDataset(args.vimeo_root, split="test")
        spe = args.steps_per_epoch or max(len(ds) // batch, 1)
        val = ds_val.sample(min(len(ds_val), 4 * batch))
        print(f"vimeo: {len(ds)} train triplets, val {val.shape}", flush=True)
        hist = tr.fit_stream(lambda: ds.sample(batch), val, spe, resume=args.resume)
    else:
        train, val = tr.load_datasets()
        print(f"train tuples {train.shape}, val tuples {val.shape}", flush=True)
        hist = tr.fit(train, val, resume=args.resume)
    print(json.dumps({"final_val": hist[-1] if hist else None}), flush=True)


def cmd_test(argv):
    p = argparse.ArgumentParser(prog="test")
    _add_common(p)
    p.add_argument("--batch_size", type=int, default=16)
    args = p.parse_args(argv)

    import torch

    from opticalflowscivis_tpu_torch.data import get_spec, load_data
    from opticalflowscivis_tpu_torch.evalsuite import calculate_diff, calculate_metrics
    from opticalflowscivis_tpu_torch.inference import Interpolator, batched_pair_inference
    from opticalflowscivis_tpu_torch.losses import epe

    cfg = _build_cfg(args)
    spec = get_spec(cfg.dataset)
    if cfg.dataset == "vimeo2d":
        # the reference's verb reads a test pkl, which vimeo2d does not have
        raise SystemExit("test: dataset 'vimeo2d' has no test series; it streams "
                         "training crops (train --vimeo_root); Vimeo90K's test list is "
                         "scored by evalsuite.benchmarks.bench_vimeo90k")
    tr = _restored_trainer(cfg, args)
    test = load_data(cfg.dataset, cfg.exp, "test", cfg.data_dir)

    interp = Interpolator(tr.model, cfg.pad_multiple, device=tr.device)
    res = batched_pair_inference(interp, test[..., :1], args.batch_size)
    psnr, ssim_v = calculate_metrics(
        res["gt"][..., 0] * 255.0, res["pred"][..., 0] * 255.0, factor=2**31
    )  # factor huge → every frame counts as interpolated
    report = {"psnr": psnr, "ssim": ssim_v}

    flow_gt = None
    if spec.has_flow:
        ndim = spec.ndim
        flow_gt = test[:, 2, ..., 1 : 1 + ndim] * spec.gt_flow_stride
        flow = torch.from_numpy(res["flow"])
        report["epe_ft1"] = float(epe(flow[..., ndim:], torch.from_numpy(flow_gt)))
        report["epe_ft0"] = float(epe(flow[..., :ndim], -torch.from_numpy(flow_gt)))

    dir_res = tr.results_dir
    os.makedirs(dir_res, exist_ok=True)
    viz = _viz()
    if viz is not None:
        diffs = calculate_diff(res["gt"], res["pred"])
        if spec.ndim == 2:
            viz.visualize_large(
                res["gt"], res["pred"], diffs, res["mask"],
                flow_gt, res["flow"][..., spec.ndim:] if spec.has_flow else None,
                dir_res, title="test_panel",
            )
        else:  # a mid-depth slice panel and a volume render
            viz.visualize_large_3d(res["gt"][..., 0], res["pred"][..., 0],
                                   diffs[..., 0], dir_res, title="test_panel3d")
            viz.visualize_3d(res["pred"][0, ..., 0], dir_res, title="pred_volume")
        loss_json = os.path.join(dir_res, "loss.json")
        if os.path.exists(loss_json):
            viz.plot_loss(loss_json, dir_res)
    with open(os.path.join(dir_res, "test_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report), flush=True)


def cmd_inference_img(argv):
    p = argparse.ArgumentParser(prog="inference_img")
    _add_common(p)
    p.add_argument("--img0", required=True)
    p.add_argument("--img1", required=True)
    p.add_argument("--out_dir", default="interp_out")
    p.add_argument("--n_exp", type=int, default=1, help="insert 2**n_exp - 1 frames")
    p.add_argument("--ratio", type=float, default=0.0,
                   help="single frame at this time ratio (0 = use n_exp)")
    p.add_argument("--zoo_dir", default="", help=ZOO_HELP)
    args = p.parse_args(argv)

    from opticalflowscivis_tpu_torch.cli.io_utils import load_image, save_image
    from opticalflowscivis_tpu_torch.inference import (
        Interpolator,
        interpolate_ratio,
        interpolate_recursive,
        load_pretrained_zoo,
    )

    img0 = load_image(args.img0)
    img1 = load_image(args.img1)
    if args.zoo_dir:
        interp = load_pretrained_zoo(args.zoo_dir, device=_device(args))
    else:
        cfg = _build_cfg(args, epochs=1)
        tr = _restored_trainer(cfg, args)
        interp = Interpolator(tr.model, cfg.pad_multiple, device=tr.device)
    if args.ratio > 0:
        mids = [interpolate_ratio(interp, img0[None], img1[None], args.ratio)]
    else:
        mids = interpolate_recursive(interp, img0[None], img1[None], 2**args.n_exp - 1)
    os.makedirs(args.out_dir, exist_ok=True)
    save_image(img0, os.path.join(args.out_dir, "img0.png"))
    for i, m in enumerate(mids):
        save_image(m[0], os.path.join(args.out_dir, f"img{i+1}.png"))
    save_image(img1, os.path.join(args.out_dir, f"img{len(mids)+1}.png"))
    print(f"wrote {len(mids) + 2} frames to {args.out_dir}", flush=True)


def cmd_inference_video(argv):
    p = argparse.ArgumentParser(prog="inference_video")
    _add_common(p)
    p.add_argument("--factors", default="2,4,8,16,32,64,128")
    p.add_argument("--max_frames", type=int, default=0, help="limit test frames (0 = all)")
    p.add_argument("--write_mp4", action="store_true")
    p.add_argument("--tta", action="store_true", help="flip-averaged test-time augmentation")
    p.add_argument("--zoo_dir", default="", help=ZOO_HELP)
    args = p.parse_args(argv)

    from opticalflowscivis_tpu_torch.cli.io_utils import write_video
    from opticalflowscivis_tpu_torch.data import load_raw_series
    from opticalflowscivis_tpu_torch.evalsuite import (
        calculate_metrics,
        linear_interpolation_baseline,
    )
    from opticalflowscivis_tpu_torch.inference import (
        Interpolator,
        interpolate_series,
        load_pretrained_zoo,
    )

    cfg = _build_cfg(args, epochs=1)
    # the model first: without a card this raises before the series is read
    # (or generated)
    if args.zoo_dir:
        interp = load_pretrained_zoo(args.zoo_dir, device=_device(args))
    else:
        tr = _restored_trainer(cfg, args)
        interp = Interpolator(tr.model, cfg.pad_multiple, tta=args.tta, device=tr.device)
    frames = load_raw_series(cfg.dataset, cfg.data_dir, "test")[..., :1]
    if args.max_frames:
        frames = frames[: args.max_frames]

    results = {}
    for factor in [int(f) for f in args.factors.split(",")]:
        if frames.shape[0] < factor + 1:
            break
        recon, _ = interpolate_series(interp, frames, factor)
        n = recon.shape[0]
        psnr, ssim_v = calculate_metrics(
            frames[:n, ..., 0] * 255.0, recon[..., 0] * 255.0, factor
        )
        base = linear_interpolation_baseline(frames[:n], factor)
        psnr_b, ssim_b = calculate_metrics(
            frames[:n, ..., 0] * 255.0, base[..., 0] * 255.0, factor
        )
        results[factor] = {
            "psnr": round(psnr, 2), "ssim": round(ssim_v, 4),
            "psnr_linear_baseline": round(psnr_b, 2),
            "ssim_linear_baseline": round(ssim_b, 4),
        }
        print(f"factor {factor}x: {results[factor]}", flush=True)
        if args.write_mp4:
            out = os.path.join(
                cfg.results_dir, cfg.dataset,
                f"{cfg.dataset}_10fps_extract{factor}x_{factor}X_{factor*10}fps.mp4",
            )
            write_video(recon[..., 0], out, fps=factor * 10)
    dir_res = os.path.join(cfg.results_dir, cfg.dataset)
    os.makedirs(dir_res, exist_ok=True)
    with open(os.path.join(dir_res, "interp_report.json"), "w") as f:
        json.dump(results, f, indent=2)
    if results:
        viz = _viz()
        if viz is not None:
            viz.plot_factor_comparison(results, dir_res)
    print(json.dumps(results), flush=True)


def cmd_generate(argv):
    import functools
    import pickle

    from opticalflowscivis_tpu_torch.data import REGISTRY, synthetic

    generable = sorted(n for n, s in REGISTRY.items() if s.generator is not None)
    p = argparse.ArgumentParser(prog="generate")
    p.add_argument("--dataset", default="rectangle2d", choices=generable)
    p.add_argument("--data_dir", default="data_cache")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frames", type=int, default=0, help="0 = reference default")
    args = p.parse_args(argv)

    # generators that take a seed and a frame count; the others run with
    # their registry defaults
    gens = {
        "rectangle2d": synthetic.rectangle_2d,
        "rectangle2d_tex": functools.partial(synthetic.rectangle_2d, background="texture"),
        "rectangle2d_tex_pan": functools.partial(synthetic.rectangle_2d, background="pan"),
        "rectangles2d": synthetic.rectangles_2d,
        "rectangle3d": synthetic.rectangle_3d,
        "jets3d": synthetic.jets_3d,
    }
    os.makedirs(args.data_dir, exist_ok=True)
    if args.dataset not in gens:
        arr = REGISTRY[args.dataset].generator()
    else:
        kw = {"seed": args.seed}
        if args.frames:
            kw["n_frames"] = args.frames
        arr = gens[args.dataset](**kw)
    path = os.path.join(args.data_dir, f"{args.dataset}.pkl")
    with open(path, "wb") as f:
        pickle.dump(arr, f, protocol=4)
    print(f"wrote {arr.shape} -> {path}", flush=True)


def _upflow_bfloat16(args) -> bool:
    """UPFlow's features compute in bfloat16 on the GPU (the training default)
    and in float32 with ``--cpu``: PyTorch's bf16 convolutions on the CPU are
    slow, and their backward now and then returns NaN weight gradients from
    finite inputs."""
    return not args.cpu


def _upflow_exp_dir(args, exp_name: str = "") -> str:
    return os.path.join(args.results_dir, args.dataset,
                        "upflow" if not exp_name else f"upflow_{exp_name}")


def cmd_train_upflow(argv):
    p = argparse.ArgumentParser(prog="train_upflow")
    _add_common(p)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--census_weight", type=float, default=0.0)
    p.add_argument("--msd_weight", type=float, default=0.0)
    p.add_argument("--photo_loss_type", default="abs_robust",
                   choices=["abs_robust", "charbonnier", "L1", "SSIM"],
                   help="photometric penalty (SSIM = weighted SSIM, a wider "
                        "basin for global shifts)")
    p.add_argument("--photo_use_occ", action="store_true",
                   help="occlusion-normalize the photometric and census terms")
    p.add_argument("--smooth1_weight", type=float, default=1.0,
                   help="edge-aware first-order smoothness; on localized motion "
                        "over a static textured background weight 1.0 can pin the "
                        "flow at zero, 0 with census=1 converges")
    p.add_argument("--lr", type=float, default=None,
                   help="AdamW lr (default: the recipe's own, 1e-4 for simple, "
                        "1e-2 for ex_runner)")
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="global-norm gradient clip (0 = off; needed for lr >= 1e-3)")
    p.add_argument("--ckpt_every", type=int, default=1,
                   help="save the checkpoint every K epochs")
    p.add_argument("--exp_name", default="",
                   help="suffix for the run dir (<results_dir>/<dataset>/upflow_<name>) "
                        "so that A-B arms do not overwrite the baseline run")
    p.add_argument("--sgu", action="store_true", help="SGU: upsample the flow under the guidance of the features")
    p.add_argument("--recipe", default="simple", choices=["simple", "ex_runner"],
                   help="ex_runner adds the eq / oi spatial-transform distillation")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device_gen", type=int, default=0, metavar="PAIRS",
                   help="pan datasets: train on PAIRS pairs a epoch composed on the "
                        "device from integer positions, a fresh pan scene every epoch "
                        "(data/device_synthetic.py), instead of the fixed export")
    p.add_argument("--kitti_image_dir", default=None,
                   help="KITTI multiview image dir (<seq>_<frame>.png), with --dataset "
                        "kitti: random crops and boundary-dilated warping")
    p.add_argument("--steps_per_epoch", type=int, default=0,
                   help="KITTI path: steps per epoch (0 = len(pairs) // batch)")
    p.add_argument("--hbm_cache", type=int, default=1000,
                   help="KITTI path: pairs decoded once into GPU memory, with crops and "
                        "augmentation on the device (0 = stream host batches through "
                        "prefetch threads)")
    p.add_argument("--prefetch_workers", type=int, default=2,
                   help="KITTI streamed path: host prefetch threads")
    args = p.parse_args(argv)
    with _process_group(args):
        _train_upflow(args)


def _train_upflow(args):
    from opticalflowscivis_tpu_torch.data import get_spec, load_raw_series
    from opticalflowscivis_tpu_torch.losses.upflow import UPFlowLossConfig
    from opticalflowscivis_tpu_torch.training.upflow_trainer import (
        UPFlowTrainConfig,
        UPFlowTrainer,
        frames_to_pairs,
    )

    kw = dict(
        batch_size=args.batch_size,
        bfloat16=_upflow_bfloat16(args),
        n_epoch=args.epochs,
        grad_clip=args.grad_clip,
        ckpt_every=args.ckpt_every,
        exp_dir=_upflow_exp_dir(args, args.exp_name),
        loss=UPFlowLossConfig(census_weight=args.census_weight,
                              msd_weight=args.msd_weight,
                              smooth_order_1_weight=args.smooth1_weight,
                              photo_loss_type=args.photo_loss_type,
                              photo_loss_use_occ=args.photo_use_occ),
    )
    if args.lr is not None:  # only override the recipe's own lr when asked
        kw["lr"] = args.lr
    if args.sgu:
        kw["model"] = dataclasses.replace(UPFlowTrainConfig().model, if_sgu_upsample=True)
    cfg = (UPFlowTrainConfig.preset_ex_runner(**kw)
           if args.recipe == "ex_runner" else UPFlowTrainConfig(**kw))
    if args.dataset == "kitti":
        hist = _train_upflow_kitti(args, cfg)
        print(json.dumps({"final": hist[-1] if hist else None}), flush=True)
        return
    spec = get_spec(args.dataset)
    device_gen = _pan_device_gen(spec, args.device_gen, args.batch_size) if args.device_gen else None
    tr = UPFlowTrainer(cfg, device=_device(args))
    # per-epoch validation EPE against the true flow where the dataset has it
    # (loss.json gains val_epe beside val_epe_zero_flow)
    val_pairs = val_flow = None
    series_val = load_raw_series(args.dataset, args.data_dir, "val")
    if (spec.has_flow and series_val.shape[-1] == 1 + spec.ndim
            and series_val.shape[0] >= 2):
        k = min(65, series_val.shape[0])
        val_pairs = frames_to_pairs(series_val[:k, ..., :1], in_channels=3)
        val_flow = series_val[: k - 1, ..., 1 : 1 + spec.ndim] * spec.gt_flow_stride
    if device_gen is not None:
        gen_fn, pos_sampler, spe = device_gen
        hist = tr.fit_device_gen(gen_fn, pos_sampler, spe, epochs=args.epochs,
                                 resume=args.resume, val_pairs=val_pairs, val_flow=val_flow)
    else:
        frames = load_raw_series(args.dataset, args.data_dir, "train")[..., :1]
        hist = tr.fit(frames_to_pairs(frames, in_channels=3), epochs=args.epochs,
                      resume=args.resume, val_pairs=val_pairs, val_flow=val_flow)
    print(json.dumps({"final": hist[-1] if hist else None}), flush=True)


def _pan_device_gen(spec, n_pairs: int, batch: int):
    """``(gen_fn, pos_sampler, steps_per_epoch)`` for ``UPFlowTrainer.
    fit_device_gen`` on a pan dataset: a fresh 128 x 128 scene every epoch
    from ``default_rng(50_000 + epoch)``, its pairs in a permuted order,
    frames tiled to 3 channels; several boxes for the ``rectangles`` sets."""
    from opticalflowscivis_tpu_torch.data import device_synthetic as ds

    gen_kw = dict(getattr(spec.generator, "keywords", None) or {})
    if gen_kw.get("background") != "pan":
        raise SystemExit("--device_gen requires a pan dataset "
                         "(rectangle2d_tex_pan / _pan8 / rectangles2d_tex_pan8)")
    pan_v = int(gen_kw.get("pan_vel_max", 3))
    grid, box = (128, 128), (60, 80)
    boxes = ((40, 50), (30, 25), (20, 35))  # rectangles_2d's defaults
    multibox = spec.name.startswith("rectangles")
    spe = max(n_pairs // batch, 1)
    n = spe * batch

    def pos_sampler(epoch: int):
        # permuted pair order: a velocity holds for up to max_seq frames, so
        # pairs in trajectory order would share one pan velocity a batch
        rng = np.random.default_rng(50_000 + epoch)
        if multibox:
            texs, big, bts, ct = ds.multibox_pan_scene_host(rng, n + 1, grid, boxes,
                                                            pan_vel_max=pan_v)
            bp, cp = ds.multibox_pan_pair_positions(bts, ct, rng.permutation(n))
            return {"texs": texs, "big": big}, {"box": bp, "cam": cp}
        tex, big, bt, ct = ds.pan_scene_host(rng, n + 1, grid, box, pan_vel_max=pan_v)
        bp, cp = ds.pan_pair_positions(bt, ct, rng.permutation(n))
        return {"tex": tex, "big": big}, {"box": bp, "cam": cp}

    def gen_fn(const, pos):
        if multibox:
            return ds.multibox_pan_pairs_device(const["texs"], const["big"], pos["box"],
                                                pos["cam"], grid, in_channels=3)
        return ds.pan_pairs_device(const["tex"], const["big"], pos["box"], pos["cam"], grid,
                                   in_channels=3)

    print(f"device-gen: {n} fresh pan pairs/epoch (pan_vel_max={pan_v}); "
          "val = registry split", flush=True)
    return gen_fn, pos_sampler, spe


def _train_upflow_kitti(args, cfg) -> list:
    """KITTI multiview training: a ``KittiHBMCache`` of ``--hbm_cache`` pairs
    kept on the device, or (``--hbm_cache 0``) host batches of a
    ``KittiPairDataset`` through a ``PrefetchSampler`` of
    ``--prefetch_workers`` threads."""
    from opticalflowscivis_tpu_torch.data import KittiHBMCache, KittiPairDataset, PrefetchSampler
    from opticalflowscivis_tpu_torch.training.upflow_trainer import UPFlowTrainer

    if not args.kitti_image_dir:
        raise SystemExit("--dataset kitti requires --kitti_image_dir")
    tr = UPFlowTrainer(cfg, device=_device(args))
    if args.hbm_cache > 0:
        cache = KittiHBMCache(args.kitti_image_dir, max_pairs=args.hbm_cache)
        spe = args.steps_per_epoch or max(len(cache) // args.batch_size, 1)
        gib = cache.frames.size * (2 if cfg.bfloat16 else 4) / 2**30
        print(f"kitti: {len(cache)} pairs kept on the device ({gib:.2f} GiB), "
              f"{spe} steps/epoch", flush=True)
        return tr.fit_kitti_hbm(cache, spe, epochs=args.epochs, resume=args.resume)
    ds = KittiPairDataset(args.kitti_image_dir)
    spe = args.steps_per_epoch or max(len(ds) // args.batch_size, 1)
    print(f"kitti: {len(ds)} multiview pairs, {spe} steps/epoch", flush=True)
    sampler = PrefetchSampler(
        batch_size=args.batch_size, workers=args.prefetch_workers,
        make_dataset=lambda w: KittiPairDataset(args.kitti_image_dir, seed=w),
    ) if args.prefetch_workers > 0 else ds
    try:
        return tr.fit_kitti(sampler, spe, epochs=args.epochs, resume=args.resume)
    finally:
        if sampler is not ds:
            sampler.close()


def evaluate_kitti(trainer, samples) -> dict[str, float]:
    """The Evaluation_bench protocol over ``samples``, the tuples that
    ``data.kitti.load_kitti_eval_pairs`` yields: each pair is predicted alone
    (edge-padded to the trainer's multiple and cropped back) and scored by
    ``evaluate_flow`` against its occ and noc ground truth; returns the mean
    of each score over the pairs."""
    from opticalflowscivis_tpu_torch.evalsuite import evaluate_flow

    results = []
    for _, im1, im2, f_occ, m_occ, f_noc, m_noc in samples:
        _, extras = trainer.predict(np.stack([im1, im2])[None])
        flow = extras["flow_f"][0].float().cpu().numpy()[: im1.shape[0], : im1.shape[1]]
        results.append(evaluate_flow(flow[None], f_occ[None], m_occ[None],
                                     f_noc[None], m_noc[None]))
    if not results:
        raise ValueError("no KITTI evaluation pairs")
    return {k: float(np.mean([r[k] for r in results])) for k in results[0]}


def cmd_test_upflow(argv):
    """With ``--kitti_root``: the KITTI-2015 Evaluation_bench protocol
    (``evaluate_kitti``), reported as ``kitti2015``.  Otherwise: predict the
    flow of a SciVis test series, draw it as quivers, and report its magnitude
    and, where the dataset has ground truth, its EPE beside the zero-flow
    baseline."""
    p = argparse.ArgumentParser(prog="test_upflow")
    _add_common(p)
    p.add_argument("--kitti_root", default=None,
                   help="KITTI-2015 root (runs the Evaluation_bench protocol)")
    p.add_argument("--max_frames", type=int, default=16)
    args = p.parse_args(argv)

    from opticalflowscivis_tpu_torch.training.upflow_trainer import (
        UPFlowTrainConfig,
        UPFlowTrainer,
        frames_to_pairs,
    )

    cfg = UPFlowTrainConfig(exp_dir=_upflow_exp_dir(args), bfloat16=_upflow_bfloat16(args))
    tr = UPFlowTrainer(cfg, device=_device(args))
    tr.init_state()
    tr.load_checkpoint()
    if args.kitti_root:
        from opticalflowscivis_tpu_torch.data import load_kitti_eval_pairs

        report = {"kitti2015": evaluate_kitti(tr, load_kitti_eval_pairs(args.kitti_root))}
        _write_upflow_report(cfg.exp_dir, report)
        return

    from opticalflowscivis_tpu_torch.data import get_spec, load_raw_series

    spec = get_spec(args.dataset)
    series = load_raw_series(args.dataset, args.data_dir, "test")[: args.max_frames]
    frames = series[..., :1]
    pairs = frames_to_pairs(frames, in_channels=3)
    _, extras = tr.predict(pairs)
    flow = extras["flow_f"].float().cpu().numpy()[:, : frames.shape[1], : frames.shape[2]]
    viz = _viz()
    if viz is not None:
        viz.visualize_series_flow(frames[:-1, ..., 0], flow, cfg.exp_dir, title="upflow_quiver")
    report = {"scivis": {
        "mean_flow_mag": float(np.mean(np.linalg.norm(flow, axis=-1))),
        "frames": int(frames.shape[0]),
    }}
    if spec.has_flow and series.shape[-1] == 1 + spec.ndim:
        # stored flow units → frame-to-frame displacement (spec.gt_flow_stride)
        gt = series[:-1, ..., 1 : 1 + spec.ndim] * spec.gt_flow_stride
        report["scivis"]["epe"] = float(np.linalg.norm(flow - gt, axis=-1).mean())
        report["scivis"]["epe_zero_flow_baseline"] = float(np.linalg.norm(gt, axis=-1).mean())
    _write_upflow_report(cfg.exp_dir, report)


def _write_upflow_report(exp_dir: str, report: dict) -> None:
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "test_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report), flush=True)


def cmd_select(argv):
    """Time-step selection: reconstruct the test series by interpolation and
    report which time steps the interpolator cannot reproduce (the ones worth
    keeping), and the error against the number of kept frames."""
    p = argparse.ArgumentParser(prog="select")
    _add_common(p)
    p.add_argument("--factor", type=int, default=4)
    p.add_argument("--factors", default="2,4,8,16,32",
                   help="comma list for the selection curve")
    p.add_argument("--linear", action="store_true",
                   help="use the linear-interpolation baseline, no model needed")
    p.add_argument("--threshold", type=float, default=None)
    args = p.parse_args(argv)

    from opticalflowscivis_tpu_torch.data import load_raw_series
    from opticalflowscivis_tpu_torch.evalsuite import (
        linear_interpolation_baseline,
        select_timesteps,
        selection_curve,
    )

    frames = load_raw_series(args.dataset, args.data_dir, "test")[..., :1]

    if args.linear:
        def reconstruct(fr, factor):
            return linear_interpolation_baseline(fr, factor)
    else:
        from opticalflowscivis_tpu_torch.inference import Interpolator, interpolate_series
        from opticalflowscivis_tpu_torch.training import Trainer

        cfg = _build_cfg(args)
        tr = Trainer(cfg, device=_device(args))
        tr.init_state(total_steps=1)
        if not tr.load_checkpoint():
            raise SystemExit(
                "select needs a trained checkpoint (run `train` first, or "
                "use --linear for the model-free baseline)"
            )
        interp = Interpolator(tr.model, cfg.pad_multiple, device=tr.device)
        cache: dict[int, np.ndarray] = {}

        def reconstruct(fr, factor):
            # selection_curve revisits args.factor: keep that one series only
            if factor in cache:
                return cache[factor]
            recon, _ = interpolate_series(interp, fr, factor)
            if factor == args.factor:
                cache[factor] = recon
            return recon

    # everything in the model's [0, 1] domain (data_range 1): the same PSNR as
    # both sides scaled to 255
    recon = reconstruct(frames, args.factor)
    n = min(frames.shape[0], recon.shape[0])
    selected, thr = select_timesteps(
        frames[:n], recon[:n], args.factor, args.threshold, data_range=1.0
    )
    factors = tuple(int(f) for f in args.factors.split(","))
    curve = selection_curve(frames, reconstruct, factors, data_range=1.0)
    report = {
        "dataset": args.dataset,
        "factor": args.factor,
        "psnr_threshold": round(thr, 3),
        "selected_timesteps": selected,
        "n_selected": len(selected),
        "curve": {str(k): v for k, v in curve.items()},
    }
    os.makedirs(args.results_dir, exist_ok=True)
    with open(os.path.join(args.results_dir, f"selection_{args.dataset}.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report), flush=True)


VERBS = {
    "train": cmd_train,
    "test": cmd_test,
    "inference_img": cmd_inference_img,
    "inference_video": cmd_inference_video,
    "generate": cmd_generate,
    "train_upflow": cmd_train_upflow,
    "test_upflow": cmd_test_upflow,
    "select": cmd_select,
}


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in WAITING_VERBS:
        raise SystemExit(f"{argv[0]}: {WAITING_VERBS[argv[0]]}")
    if not argv or argv[0] not in VERBS:
        names = "|".join(list(VERBS) + list(WAITING_VERBS))
        print(f"usage: python -m opticalflowscivis_tpu_torch.cli <{names}> [flags]")
        raise SystemExit(2)
    VERBS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
