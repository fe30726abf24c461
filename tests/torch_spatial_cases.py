"""The cases of the spatially sharded tests, shared by the test files and
their gloo ranks (which import this module and neither JAX nor pytest).

``python tests/torch_spatial_cases.py layers RANK WORLD URL OUT`` is one rank
of ``tests/test_torch_spatial.py``'s session, ``... steps RANK WORLD URL OUT``
one rank of ``tests/test_torch_spatial_steps.py``'s, and ``... steps_ref OUT``
that session's one-device reference.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from opticalflowscivis_tpu_torch.losses import RIFELossWeights
from opticalflowscivis_tpu_torch.losses.basic import photometric_loss, smoothness_loss
from opticalflowscivis_tpu_torch.losses.rife import rife_losses
from opticalflowscivis_tpu_torch.models.layers import conv, conv_forward, deconv, deconv_forward
from opticalflowscivis_tpu_torch.ops.kernels.warp import warp3d
from opticalflowscivis_tpu_torch.ops.pyramid import lap_loss
from opticalflowscivis_tpu_torch.ops.resize import resize_flow_nchw, resize_nchw
from opticalflowscivis_tpu_torch.parallel import DepthShard, shard_batch, volume_batch_sharding
from opticalflowscivis_tpu_torch.scripts import dryrun_dp
from opticalflowscivis_tpu_torch.training import ModelConfig, TrainConfig, Trainer
from opticalflowscivis_tpu_torch.training.trainer import _channels_last, _nchw, split_batch

N_LAYER_RANKS = 4  # the layer session's (1, 4) mesh
STEP_MESH = (2, 2)  # the steps session's (n_data, n_space)


# -- the layer session -------------------------------------------------------------------


_LAYERS: dict = {}


def conv_layers() -> dict:
    """The conv cases' modules, from fixed seeds (built once)."""
    if not _LAYERS:
        _LAYERS.update({
            "conv_k3_s1": conv(3, 4, torch.Generator().manual_seed(1), 3, 3, 1),
            "conv_k3_s2": conv(3, 4, torch.Generator().manual_seed(2), 3, 3, 2),
            "conv_k4_s2": conv(3, 4, torch.Generator().manual_seed(3), 3, 4, 2),
            "deconv_k4_s2": deconv(3, 2, torch.Generator().manual_seed(4), 3),
        })
    return _LAYERS


_INPUTS: dict = {}


def inputs() -> dict:
    """The layer cases' inputs, drawn with numpy from seed 7: channels-first
    ``[B, C, Z, Y, X]`` with 16 slices (4 a rank), but ``small`` with 4 (one
    a rank), and channels-last ``[B, Z, Y, X, C]`` for the losses.  Float64,
    so that the sums a sharded layer takes in another order (a weight
    gradient's over the shards) agree far inside the tests' tolerance; the
    losses compute in float32 all the same."""
    if not _INPUTS:
        rng = np.random.default_rng(7)

        def normal(*shape, scale=1.0):
            return torch.from_numpy(scale * rng.standard_normal(shape))

        def uniform(*shape):
            return torch.from_numpy(rng.random(shape))

        _INPUTS.update(
            x=normal(2, 3, 16, 5, 6), small=normal(2, 3, 4, 3, 3),
            img=uniform(1, 2, 16, 5, 6), warp_flow=normal(1, 3, 16, 5, 6, scale=2.0),
            # rough flows: Charbonnier's gradient is well conditioned away from 0
            smooth_flow=normal(2, 16, 5, 6, 3), photo_flow=normal(2, 16, 5, 6, 6, scale=1.5),
            merged=uniform(2, 16, 5, 6, 1), i0=uniform(2, 16, 5, 6, 1),
            i1=uniform(2, 16, 5, 6, 1), lap_pred=normal(2, 16, 8, 8, 1),
            lap_target=normal(2, 16, 8, 8, 1),
        )
    return _INPUTS


CHANNELS_LAST = ("smooth_flow", "photo_flow", "merged", "i0", "i1", "lap_pred", "lap_target")


def depth_dim(key: str) -> int:
    return 1 if key in CHANNELS_LAST else 2


def own(key: str, shard: DepthShard | None) -> torch.Tensor:
    """Input ``key`` whole, or this rank's slices of it."""
    t = inputs()[key]
    if shard is None:
        return t
    dim = depth_dim(key)
    n = t.shape[dim] // shard.n
    return t.narrow(dim, shard.index * n, n)


def layer_cases(shard: DepthShard | None) -> dict:
    """name -> (fn of the differentiated input, its key, whether the result
    is a loss: on a shard this rank's share, which the mean over the ranks
    makes whole)."""
    layers = conv_layers()
    cl = None if shard is None else dataclasses.replace(shard, dim=1)

    def conv_case(name):
        fn = deconv_forward if name.startswith("deconv") else conv_forward
        return lambda x: fn(layers[name], x, shard)

    def warp(img, flow):  # the gather form of an unbounded warp
        if shard is None:
            return warp3d(img, flow, 0, 0, "border")
        return shard.scatter(warp3d(shard.gather(img), shard.pad_to_whole(flow), 0, 0, "border"))

    def gather_then_scatter(x):  # each slice of the result reads every earlier one
        return x.cumsum(2) if shard is None else shard.scatter(shard.gather(x).cumsum(2))

    return {
        **{name: (conv_case(name), "x", False) for name in layers},
        "resize_down_4": (lambda x: resize_nchw(x, (x.shape[2] // 4, 2, 3), shard=shard),
                          "x", False),
        "resize_flow_up_4": (lambda f: resize_flow_nchw(f, (4 * f.shape[2], 6, 5), shard=shard),
                             "small", False),
        "gather_scatter": (gather_then_scatter, "x", False),
        "warp_gather_form_img": (lambda i: warp(i, own("warp_flow", shard)), "img", False),
        "warp_gather_form_flow": (lambda f: warp(own("img", shard), f), "warp_flow", False),
        "smoothness_loss": (lambda f: smoothness_loss(f, cl), "smooth_flow", True),
        "photometric_loss": (lambda m: photometric_loss(
            m, own("photo_flow", shard), own("i0", shard), own("i1", shard), 3, shard=cl),
            "merged", True),
        "lap_loss": (lambda p: lap_loss(p, own("lap_target", shard), 3, shard=cl),
                     "lap_pred", True),
    }


def cotangent(name: str, shape) -> torch.Tensor:
    """The cotangent of a layer case's whole output, from a seed per case."""
    seed = sorted(layer_cases(None)).index(name)
    return torch.from_numpy(np.random.default_rng(100 + seed).standard_normal(shape))


def layers_rank(rank: int, world: int, url: str, out: str) -> None:
    """Each layer case on this rank's shard: (output, input gradient, weight
    gradients); then the sharded train step of ``reference_step_setup`` from
    ``out/weights.pt``: its parts and averaged gradients."""
    from opticalflowscivis_tpu_torch.parallel import initialize_multihost, make_mesh

    initialize_multihost(url, world, rank, device="cpu", timeout_s=120)
    shard = DepthShard(make_mesh(1, world, spatial=True))
    shapes = torch.load(f"{out}/shapes.pt")
    res = {}
    for name, (fn, key, is_loss) in layer_cases(shard).items():
        x = own(key, shard).clone().requires_grad_(True)
        y = fn(x)
        if is_loss:
            g = torch.ones(())
        else:
            g = cotangent(name, shapes[name])
            n = g.shape[2] // world
            g = g.narrow(2, rank * n, n)
        params = list(conv_layers().get(name, torch.nn.Identity()).parameters())
        grads = torch.autograd.grad(y, [x] + params, g)
        res[name] = (y.detach(), grads[0], grads[1:])
    cfg, train, _ = reference_step_setup(out)
    tr = Trainer(cfg, device="cpu")
    tr.model.load_state_dict(torch.load(f"{out}/weights.pt"), strict=True)
    tr.init_state(total_steps=2)
    parts = tr.train_step(torch.from_numpy(train))
    grads = {n: p.grad.clone() for n, p in tr.model.named_parameters() if p.grad is not None}
    res["step"] = ({k: float(v) for k, v in parts.items()}, grads)
    torch.save(res, f"{out}/rank{rank}.pt")


def reference_step_setup(out: str):
    """The reference's own dp x sp configuration (16³, blocks (8, 8, 8),
    ``conv0_kernel=3``, unbounded warps, ``preset_3d``) on 4 space ranks,
    batch 2: ``dryrun_dp``'s tiny half."""
    return dryrun_dp.sp_setup(out, "tiny", 1, N_LAYER_RANKS)


# -- the steps session -------------------------------------------------------------------


def textured(tuples: np.ndarray, seed: int) -> np.ndarray:
    """Tuples on a smooth random texture (coarse noise resized up), so that
    every voxel carries signal and the gradients are not rounding of zeros."""
    out = tuples[..., :1].astype(np.float32).copy()
    spatial = out.shape[2:-1]
    coarse = np.random.default_rng(seed).uniform(0.05, 0.3, (out.shape[0] * out.shape[1], 1)
                                                 + (4,) * len(spatial))
    mode = "bilinear" if len(spatial) == 2 else "trilinear"
    tex = torch.nn.functional.interpolate(torch.from_numpy(coarse.astype(np.float32)),
                                          size=spatial, mode=mode, align_corners=True)
    out[..., 0] += tex.numpy().reshape(out.shape[:-1])
    return np.concatenate([out, tuples[..., 1:].astype(np.float32)], axis=-1)


# the halo case's every term (the model's warps through backward_warp3d_sharded,
# remat), and the total it is stepped with: preset_3d with distillation, flow
# supervision and the leash (photometric and smoothness terms are held term by
# term: their Charbonnier gradients at near-equal values move with the
# batch's summation order, also on one device)
HALO_TERMS = RIFELossWeights(distill=0.1, reg=1e-4, photo=0.1, smooth=0.1, flow=0.5,
                             use_lap=False, flow_leash=0.1, flow_leash_radius=1.05)
HALO_STEP = dataclasses.replace(HALO_TERMS, photo=0.0, smooth=0.0)
PLANE_TERMS = dataclasses.replace(RIFELossWeights.preset_2d(flow_supervised=True), smooth=0.1)
PLANE_STEP = RIFELossWeights.preset_2d(flow_supervised=True)


STEP_CASES = ("halo", "plane", "options")
TERM_CASES = ("halo", "plane")


def step_case(name: str, n_data=None, n_space: int = 1, loss=None):
    """(TrainConfig, global batch [2, 3, *S, C]) of a steps-session case:
    ``halo``, IFNet-3D at 32³ whose warps take the halo (``conv0_kernel=4``,
    ``bounded_warp_rz=4``, ``fast_warp_r=4``, ``remat``); ``options``, the
    same with the model options the JAX package also takes sharded
    (``refine``, ``arbitrary_timestep``, ``teacher_scale=2``); or ``plane``,
    IFNet-2D at 32 x 32 with its height sharded (warps in the gather form)."""
    from opticalflowscivis_tpu_torch.data import group_tuples, rectangle_2d, rectangle_3d

    if name in ("halo", "options"):
        extra = dict(remat=True) if name == "halo" else dict(
            refine=True, arbitrary_timestep=True, teacher_scale=2)
        model = ModelConfig(ndim=3, block_channels=(8, 8, 8), teacher_channels=8,
                            conv0_kernel=4, bounded_warp_rz=4, fast_warp_r=4, bfloat16=False,
                            **extra)
        frames = rectangle_3d(n_frames=6, grid=(32, 32, 32), box=(10, 12, 8), vel_max=2, seed=3)
        dataset, loss = "rectangle3d", loss or HALO_STEP
    else:
        model = ModelConfig(block_channels=(16, 12, 8), teacher_channels=8, fast_warp_r=4,
                            bfloat16=False)
        frames = rectangle_2d(n_frames=6, grid=(32, 32), box=(10, 14), seed=3)
        dataset, loss = "rectangle2d", loss or PLANE_STEP
    cfg = TrainConfig(dataset=dataset, batch_size=2, n_data=n_data, n_space=n_space,
                      spatial_shard=n_space > 1, model=model, loss=loss,
                      data_dir="unused", log_dir="unused", results_dir="unused")
    return cfg, textured(group_tuples(frames, 1)[:2], seed=4)


def term_gradients(tr: Trainer, batch: torch.Tensor) -> dict:
    """Each loss term's value and parameter gradients on ``batch`` (this
    rank's part of it under ``tr.mesh``), averaged as the train step
    averages them."""
    mesh = tr.mesh
    shard = DepthShard(mesh) if mesh is not None and mesh.spatial else None
    if shard is not None:
        batch = volume_batch_sharding(batch, mesh)
    elif mesh is not None:
        batch = shard_batch(batch, mesh)
    nd = tr.cfg.model.ndim
    img0, img1, gt, gt_flow = split_batch(batch, nd, tr.has_flow)
    out = tr.model(_nchw(img0), _nchw(img1), _nchw(gt), shard=shard)
    outputs = {k: v if k == "loss_distill" else _channels_last(v) for k, v in out.items()}
    params = dict(tr.model.named_parameters())
    _, parts = rife_losses(outputs, img0, img1, gt, params, tr.cfg.loss, nd, gt_flow=gt_flow,
                           fast_warp_r=tr.cfg.model.fast_warp_r, mesh=mesh, shard=shard)
    res = {}
    for term, value in parts.items():
        if term == "loss_G" or not value.requires_grad:
            continue
        grads = torch.autograd.grad(value, list(params.values()), retain_graph=True,
                                    allow_unused=True)
        for p, g in zip(params.values(), grads):
            p.grad = torch.zeros_like(p) if g is None else g
        if mesh is not None:
            mesh.average_gradients(params.values())
        res[term] = {n: p.grad.clone() for n, p in params.items()}
    values = parts if mesh is None else mesh.mean_values(parts)
    return {"values": {k: float(v) for k, v in values.items()}, "grads": res}


def _step(tr: Trainer, batch: torch.Tensor) -> dict:
    tr.init_state(total_steps=2)
    parts = tr.train_step(batch)
    return {"parts": {k: float(v) for k, v in parts.items()},
            "grads": {n: p.grad.clone() for n, p in tr.model.named_parameters()
                      if p.grad is not None}}


def _mean(dicts: list) -> dict:
    return {k: sum(d[k] for d in dicts) / len(dicts) for k in dicts[0]}


def steps_ref(out: str) -> None:
    """One device: each case's step on the global batch, its terms on each
    data rank's rows averaged (the rows the ranks hold, so that only the
    depth sharding differs), and ``dryrun_dp``'s tiny dp x sp half."""
    res = {}
    n_data = STEP_MESH[0]
    for name in STEP_CASES:
        cfg, batch = step_case(name)
        res[name] = _step(Trainer(cfg, device="cpu"), torch.from_numpy(batch))
    for name, terms in zip(TERM_CASES, (HALO_TERMS, PLANE_TERMS)):
        cfg, batch = step_case(name, loss=terms)
        tr = Trainer(cfg, device="cpu")
        rows = batch.shape[0] // n_data
        per_rows = [term_gradients(tr, torch.from_numpy(batch[d * rows:(d + 1) * rows]))
                    for d in range(n_data)]
        res[name]["terms"] = {
            "values": _mean([r["values"] for r in per_rows]),
            "grads": {t: _mean([r["grads"][t] for r in per_rows]) for t in per_rows[0]["grads"]},
        }
    torch.save(res, f"{out}/ref.pt")
    dryrun_dp.run_sp(os.path.join(out, "one"), "tiny", "cpu", None, 1)


def steps_rank(rank: int, world: int, url: str, out: str) -> None:
    from opticalflowscivis_tpu_torch.parallel import initialize_multihost

    initialize_multihost(url, world, rank, device="cpu", timeout_s=120)
    n_data, n_space = STEP_MESH
    res = {}
    for name in STEP_CASES:
        cfg, batch = step_case(name, n_data, n_space)
        res[name] = _step(Trainer(cfg, device="cpu"), torch.from_numpy(batch))
    for name, terms in zip(TERM_CASES, (HALO_TERMS, PLANE_TERMS)):
        cfg, batch = step_case(name, n_data, n_space, loss=terms)
        res[name]["terms"] = term_gradients(Trainer(cfg, device="cpu"), torch.from_numpy(batch))
    if rank == 0:
        torch.save(res, f"{out}/sharded.pt")
    dryrun_dp.run_sp(os.path.join(out, "mesh"), "tiny", "cpu", n_data, n_space)


if __name__ == "__main__":
    torch.set_num_threads(1)
    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "steps_ref":
        steps_ref(args[0])
    else:
        {"layers": layers_rank, "steps": steps_rank}[mode](int(args[0]), int(args[1]), *args[2:])
