"""UPFlow training runtime, on one device or data-parallel.

Counterpart of ``opticalflowscivis_tpu/training/upflow_trainer.py``:

- AdamW(lr, weight_decay) with ``lr_gamma`` as a per-epoch staircase
  exponential decay and an optional global-norm clip before it;
- the ``upflow_losses`` composition, plus the ex_runner recipe's second
  forward on a spatially transformed pair (``eq_loss`` / ``oi_loss``);
- frame pairs: consecutive SciVis frames (im1 = frame t, im2 = frame t + 1),
  grayscale tiled to the network's channel count;
- ``fit``: the pair set kept on the device with index batches when it fits
  (streamed batches otherwise), a per-epoch ``loss.json`` append, validation
  EPE against ground-truth flow beside the zero-flow baseline, a checkpoint
  every ``ckpt_every`` epochs with ``ckpt_meta.json`` (so that ``resume``
  continues from the last *saved* epoch and truncates ``loss.json`` to it),
  and the ``STOP`` file that ends a run at the next epoch boundary.

Batches are dicts of channels-last tensors (``im1``, ``im2`` and optionally
``im1_raw``, ``im2_raw``, ``start`` for boundary-dilated warping); the model
runs channels-first and its outputs reach the losses as channels-last views.
Parameters and optimizer state are float32; with ``bfloat16`` the features
compute in bfloat16 while every flow stays float32.

KITTI multiview training: ``fit_kitti`` takes host batches from any
``sample(batch)`` dataset (``data.kitti.KittiPairDataset``, usually behind a
``PrefetchSampler``); ``fit_kitti_hbm`` keeps a ``KittiHBMCache``'s frames on
the device and sends only indices each step (``kitti_batch`` cuts each
step's batch).  Both pass the rho-dilated raw windows and the crop offset to
the photometric term (boundary-dilated warping).

Spans (``utils.profiling.span``): ``ofs.train_step`` around a step, with
``ofs.backward``, ``ofs.allreduce`` and ``ofs.optimizer`` inside it, and
``ofs.losses`` around the loss terms (the model's own spans are
``ofs.upflow`` and its children).

Device-generated training: ``fit_device_gen`` composes each step's pairs on
the device from integer positions (``data.device_synthetic``); the scene's
constants and the positions go up once an epoch, no frame crosses from the
host.

Data parallelism (``n_data``, one process a device under ``torchrun``), as
in ``training.trainer``: every rank draws the same global batch (the same
shuffles, KITTI draws, generated scenes and spatial-transform seeds), keeps
its rows at the entry of the train step, and averages the gradients by one
all-reduce; the occlusion-normalised ratios and the census term run over the
global batch (``losses.upflow``), so the step equals the one-device step on
the global batch.  The parts, ``loss.json`` and ``val_epe`` are global
values; rank 0 alone writes files, and the ``STOP`` decision is rank 0's,
broadcast.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from opticalflowscivis_tpu_torch.data import TupleDataset, device_batch, pad_to_multiple
from opticalflowscivis_tpu_torch.device import resolve_device
from opticalflowscivis_tpu_torch.losses.selfsup import (
    SPTransformConfig,
    eq_loss,
    oi_loss,
    sp_transform_pair,
)
from opticalflowscivis_tpu_torch.losses.upflow import UPFlowLossConfig, upflow_losses
from opticalflowscivis_tpu_torch.models.upflow import UPFlowConfig, UPFlowNet
from opticalflowscivis_tpu_torch.parallel.mesh import data_parallel_mesh, shard_batch
from opticalflowscivis_tpu_torch.parallel.multihost import local_device
from opticalflowscivis_tpu_torch.training.checkpoint import restore_state, save_state
from opticalflowscivis_tpu_torch.training.trainer import TrainState
from opticalflowscivis_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class UPFlowTrainConfig:
    batch_size: int = 8
    n_epoch: int = 1000
    lr: float = 1e-4
    weight_decay: float = 1e-4
    lr_gamma: float = 1.0  # per-epoch exponential decay (1 = constant)
    grad_clip: float = 0.0  # global-norm clip (0 = off, the reference's
    #   behaviour); hot learning rates (1e-3 and up) need it
    seed: int = 0
    ckpt_every: int = 1  # save the checkpoint every K epochs.  ckpt_meta.json
    #   (epochs_completed, written with each save) keeps resume right: a crash
    #   between saves resumes from the last saved epoch, replays the per-step
    #   seeds since, and truncates loss.json to match.
    exp_dir: str = "./demo_exp"
    bfloat16: bool = True
    pad_multiple: int = 64  # 6 stride-2 levels
    n_data: int | None = None  # data-parallel degree: the processes of the default
    #   group (torchrun); None = all of them, or one device without a group
    hbm_dataset_gb: float = 6.0  # keep the pair set in GPU memory when it fits
    #   (0 = always stream): one upload, then only batch indices per step
    # ARFlow / ex_runner spatial-transform distillation (losses/selfsup.py)
    eq_weight: float = 0.0  # equivariance distillation on transformed pairs
    oi_weight: float = 0.0  # occlusion-photometric loss on transformed pairs
    # Training default: cost-volume feature normalisation ON with per-image,
    # per-channel moments (both moment-sharing flags False).  UPFlowConfig
    # itself defaults to no normalisation, but without it the unsupervised
    # losses barely move the flow (unnormalised feature products leave the
    # correlation badly scaled for the shared decoder).
    model: UPFlowConfig = dataclasses.field(
        default_factory=lambda: UPFlowConfig(
            if_norm_before_cost_volume=True,
            norm_moments_across_channels=False,
            norm_moments_across_images=False,
        )
    )
    loss: UPFlowLossConfig = dataclasses.field(default_factory=UPFlowLossConfig)

    @classmethod
    def preset_ex_runner(cls, **kw) -> "UPFlowTrainConfig":
        """The ex_runner recipe: ARFlow-style spatial-transform distillation
        (eq) and the occlusion-masked photometric loss on the transformed pair
        (oi), both at weight 0.01; lr 1e-2, weight decay 1e-5, per-epoch decay
        0.95.  The reference finetunes from a pretrained checkpoint with it:
        call ``load_checkpoint`` first for the same workflow."""
        defaults = dict(lr=1e-2, weight_decay=1e-5, lr_gamma=0.95, eq_weight=0.01,
                        oi_weight=0.01)
        return cls(**defaults | kw)  # explicit kwargs override the recipe


def frames_to_pairs(frames: np.ndarray, in_channels: int = 3) -> np.ndarray:
    """``[T, H, W, 1]`` scalar series → ``[T-1, 2, H, W, C]`` (im1, im2) pairs,
    grayscale tiled to ``in_channels``."""
    if frames.ndim == 3:
        frames = frames[..., None]
    f = np.repeat(frames[..., :1], in_channels, axis=-1) if in_channels > 1 else frames[..., :1]
    return np.stack([f[:-1], f[1:]], axis=1)


def _tree_map(fn, tree):
    """``fn`` on each leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _channels_last(out: dict) -> dict:
    """The model's channels-first outputs as channels-last views."""
    return {
        "flow_f": out["flow_f"].movedim(1, -1),
        "flow_b": out["flow_b"].movedim(1, -1),
        "flows": [(f.movedim(1, -1), b.movedim(1, -1)) for f, b in out["flows"]],
    }


class UPFlowTrainer:
    """End-to-end UPFlow trainer.  Runs on ``cuda`` unless ``device="cpu"``."""

    def __init__(self, cfg: UPFlowTrainConfig, device: str | torch.device | None = None):
        self.cfg = cfg
        self.mesh = data_parallel_mesh(cfg.n_data)
        self.n_data = 1 if self.mesh is None else self.mesh.n_data
        self.device = resolve_device(device) if self.mesh is None else local_device(device)
        self.net = UPFlowNet(
            cfg.model, dtype=torch.bfloat16 if cfg.bfloat16 else None, device=self.device,
            seed=cfg.seed,
        )
        if self.mesh is not None:
            self.mesh.broadcast_module(self.net)
        self.state: TrainState | None = None
        self._use_sp = cfg.eq_weight > 0 or cfg.oi_weight > 0
        self._sp_gen = torch.Generator()

    # -- state ------------------------------------------------------------
    def init_state(self, steps_per_epoch: int = 0) -> TrainState:
        """Build the optimizer and, for ``lr_gamma != 1``, the per-epoch
        staircase decay over ``steps_per_epoch`` steps."""
        cfg = self.cfg
        optimizer = torch.optim.AdamW(
            self.net.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay,
        )
        if cfg.lr_gamma != 1.0 and steps_per_epoch > 0:
            def factor(step: int) -> float:
                return cfg.lr_gamma ** (step // steps_per_epoch)
        else:
            def factor(step: int) -> float:
                return 1.0
        scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
        self.state = TrainState(self.net, optimizer, scheduler)
        return self.state

    def upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, torch.float32)

    def _batch(self, pairs: torch.Tensor) -> dict[str, torch.Tensor]:
        return {"im1": pairs[:, 0], "im2": pairs[:, 1]}

    def _forward(self, im1: torch.Tensor, im2: torch.Tensor) -> dict:
        return _channels_last(self.net(im1.movedim(-1, 1), im2.movedim(-1, 1)))

    @property
    def is_writer(self) -> bool:
        """Whether this process writes files and logs (rank 0, or the only one)."""
        return self.mesh is None or self.mesh.is_writer

    # -- steps --------------------------------------------------------------
    def losses(self, batch: dict[str, torch.Tensor], step: int = 0):
        """``(total, parts)`` of a device batch; ``step`` seeds the spatial
        transform of the eq / oi terms.  Under data parallelism ``batch`` is
        the global batch and the loss is this rank's part of it."""
        cfg, mesh = self.cfg, self.mesh
        local = batch if mesh is None else shard_batch(batch, mesh)
        im1, im2 = local["im1"], local["im2"]
        raw = (
            (local["im1_raw"], local["im2_raw"], local["start"])
            if "im1_raw" in local else None
        )
        out = self._forward(im1, im2)
        with span("ofs.losses"):
            total, parts = upflow_losses(out, im1, im2, cfg.loss, raw=raw, mesh=mesh)
        if self._use_sp:
            # student on the transformed pair, teacher = the detached
            # prediction on the untransformed one; one seed per step, so that
            # a resumed run draws what the first run would have drawn.  The
            # draws are the global batch's, so every rank takes its rows of them.
            self._sp_gen.manual_seed((cfg.seed + 1) * 1_000_003 + step)
            drawn = sp_transform_pair(self._sp_gen, batch["im1"], batch["im2"],
                                      SPTransformConfig())
            t1, t2, sp = drawn if mesh is None else shard_batch(drawn, mesh)
            out_t = self._forward(t1, t2)
            with span("ofs.losses"):
                if cfg.eq_weight > 0:
                    parts["eq_loss"] = cfg.eq_weight * eq_loss(out_t["flow_f"], out["flow_f"], sp)
                    total = total + parts["eq_loss"]
                if cfg.oi_weight > 0:
                    parts["oi_loss"] = cfg.oi_weight * oi_loss(
                        t1, t2, out_t["flow_f"], out_t["flow_b"], mesh=mesh)
                    total = total + parts["oi_loss"]
            parts["loss_total"] = total
        return total, parts

    def train_step(self, batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """One optimizer update on a device batch (a dict of channels-last
        tensors; the global batch under data parallelism); returns the
        detached loss parts as 0-d tensors."""
        s = self.state
        with span("ofs.train_step"):
            s.optimizer.zero_grad(set_to_none=True)
            total, parts = self.losses(batch, s.step)
            with span("ofs.backward"):
                total.backward()
            if self.mesh is not None:
                with span("ofs.allreduce"):
                    self.mesh.average_gradients(self.net.parameters())
            with span("ofs.optimizer"):
                if self.cfg.grad_clip:
                    torch.nn.utils.clip_grad_norm_(self.net.parameters(), self.cfg.grad_clip)
                s.optimizer.step()
                s.scheduler.step()
            s.step += 1
            parts = {k: v.detach() for k, v in parts.items()}
            return parts if self.mesh is None else self.mesh.mean_values(parts)

    def eval_step(self, batch: dict[str, torch.Tensor]):
        """Loss parts and ``{"flow_f", "flow_b"}`` (channels-last, on the
        device) without gradients and without the eq / oi terms."""
        with torch.no_grad():
            im1, im2 = batch["im1"], batch["im2"]
            out = self._forward(im1, im2)
            _, parts = upflow_losses(out, im1, im2, self.cfg.loss)
        return parts, {"flow_f": out["flow_f"], "flow_b": out["flow_b"]}

    # -- loops ------------------------------------------------------------
    def fit(self, pairs: np.ndarray, epochs: int | None = None, log_every: int = 20,
            resume: bool = False, val_pairs: np.ndarray | None = None,
            val_flow: np.ndarray | None = None) -> list[dict[str, float]]:
        """Train on ``pairs [N, 2, H, W, C]``.

        ``val_pairs [M, 2, H, W, C]`` with ``val_flow [M, H, W, 2]`` (the true
        per-frame displacement in pixels): the mean EPE of the forward flow is
        logged per epoch to ``loss.json`` as ``val_epe`` beside the constant
        ``val_epe_zero_flow`` baseline.
        """
        cfg = self.cfg
        try:  # a stale sentinel from an earlier stop must not end a new run
            os.remove(os.path.join(cfg.exp_dir, "STOP"))
        except OSError:
            pass
        if pairs.shape[0] < 1:
            raise ValueError("no training pairs")
        pairs, _ = pad_to_multiple(pairs, cfg.pad_multiple, leading_axes=2)
        epochs = epochs if epochs is not None else cfg.n_epoch
        n = self.n_data  # a multiple of the data-parallel ranks, one row each at least
        batch = max(n, (min(cfg.batch_size, pairs.shape[0]) // n) * n)
        if pairs.shape[0] < batch:
            raise ValueError(f"{pairs.shape[0]} pairs < batch {batch} ({n} data-parallel "
                             "ranks need at least one pair each)")
        ds = TupleDataset(pairs, batch, seed=cfg.seed)
        steps_per_epoch = max(1, len(ds))
        restored = self.state is not None  # a live in-memory state continues
        if self.state is None:
            self.init_state(steps_per_epoch=steps_per_epoch)
            if resume:
                restored = self.load_checkpoint()
        # Resume offset: applied only after a successful restore; the shuffle
        # stream is advanced past the completed epochs so that the data order
        # continues where the first run left off.
        start_epoch = 0
        if resume:
            if restored:
                start_epoch = self._completed_epochs()
                self._truncate_loss_json(start_epoch)
                for _ in range(start_epoch):
                    for _ in ds.epoch_indices():
                        pass
            else:
                print("resume requested but no checkpoint restored; starting from epoch 0 "
                      "with untruncated loss.json left in place", flush=True)
        self.state.step = start_epoch * steps_per_epoch

        resident = bool(cfg.hbm_dataset_gb and pairs.nbytes <= cfg.hbm_dataset_gb * 1e9)
        data_dev = self.upload(pairs) if resident else None
        val = None
        if val_pairs is not None and val_flow is not None:
            val = self._device_val(val_pairs, val_flow)

        history = []
        t0 = time.time()
        for epoch in range(start_epoch, start_epoch + epochs):
            # the meter stays on the device and is read once per epoch
            meter: dict[str, torch.Tensor] = {}
            n = 0
            for idx in ds.epoch_indices():
                if resident:
                    dev_pairs = data_dev[torch.from_numpy(idx).to(self.device)]
                else:
                    dev_pairs = self.upload(pairs[idx])
                parts = self.train_step(self._batch(dev_pairs))
                for k, v in parts.items():
                    meter[k] = meter[k] + v if k in meter else v
                n += 1
                step = self.state.step
                if log_every and step % log_every == 0 and self.is_writer:
                    done = step - start_epoch * steps_per_epoch
                    print(f"epoch {epoch} step {step} loss "
                          f"{float(meter['loss_total']) / n:.5f} "
                          f"({done / (time.time() - t0):.2f} it/s)", flush=True)
            history.append(self._close_epoch(meter, n, val, epoch, start_epoch, epochs))
            if self._stop_requested():
                print(f"STOP sentinel: ending after epoch {epoch}", flush=True)
                break
        return history

    def _batch_size(self) -> int:
        """``cfg.batch_size`` rounded down to a multiple of the data-parallel
        ranks (at least one row each)."""
        n = self.n_data
        return max(n, (self.cfg.batch_size // n) * n)

    def _close_epoch(self, meter: dict[str, torch.Tensor], n: int, val, epoch: int,
                     start_epoch: int, epochs: int) -> dict[str, float]:
        """The end of an epoch of ``fit`` and ``fit_device_gen``: the meter's
        means (one read of the device), ``val_epe`` beside the zero-flow
        baseline, the ``loss.json`` row, and the checkpoint every
        ``ckpt_every`` epochs, at the last epoch and when ``STOP`` asks."""
        cfg = self.cfg
        sums = torch.stack([v.float() for v in meter.values()]).tolist() if meter else []
        epoch_means = {k: v / max(n, 1) for k, v in zip(meter, sums)}
        if val is not None:
            epoch_means["val_epe"] = self._val_epe_device(*val[:2])
            epoch_means["val_epe_zero_flow"] = val[2]
            if self.is_writer:
                print(f"epoch {epoch} val_epe {epoch_means['val_epe']:.4f} "
                  f"(zero-flow {epoch_means['val_epe_zero_flow']:.4f})", flush=True)
        self._append_loss_json(epoch_means)
        if ((epoch - start_epoch + 1) % cfg.ckpt_every == 0
                or epoch == start_epoch + epochs - 1 or self._stop_requested()):
            self.save_checkpoint(epochs_completed=epoch + 1)
        return epoch_means

    def _device_val(self, val_pairs: np.ndarray, val_flow: np.ndarray):
        """Validation pairs and ground truth uploaded once:
        ``(pairs_dev, gt_dev, val_epe_zero_flow)``."""
        vp, _ = pad_to_multiple(val_pairs, self.cfg.pad_multiple, leading_axes=2)
        zero = float(np.linalg.norm(val_flow, axis=-1).mean())
        return self.upload(vp), self.upload(val_flow), zero

    def _val_epe_device(self, pairs_dev: torch.Tensor, gt_dev: torch.Tensor) -> float:
        """Mean EPE of the forward flow, in chunks of the batch size."""
        h, w = gt_dev.shape[1:3]
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        chunk = max(1, self.cfg.batch_size)
        with torch.no_grad():
            for i in range(0, pairs_dev.shape[0], chunk):
                p = pairs_dev[i : i + chunk]
                flow = self._forward(p[:, 0], p[:, 1])["flow_f"][:, :h, :w]
                err = torch.linalg.vector_norm(flow.float() - gt_dev[i : i + chunk], dim=-1)
                total += err.double().sum()
        return float(total) / (gt_dev.shape[0] * h * w)

    def val_epe(self, val_pairs: np.ndarray, val_flow: np.ndarray) -> float:
        """Mean EPE of the forward flow against the true displacement."""
        pairs_dev, gt_dev, _ = self._device_val(val_pairs, val_flow)
        return self._val_epe_device(pairs_dev, gt_dev)

    def fit_device_gen(self, gen_fn, pos_sampler, steps_per_epoch: int,
                       epochs: int | None = None, log_every: int = 20, resume: bool = False,
                       val_pairs: np.ndarray | None = None,
                       val_flow: np.ndarray | None = None) -> list[dict[str, float]]:
        """Train on pairs composed on the device from integer positions, a
        fresh scene every epoch.

        - ``gen_fn(const, pos) -> (im1, im2, gt_flow)`` runs on the device
          inside each step (e.g. ``data.pan_pairs_device``); ``gt_flow`` is
          not used for training;
        - ``pos_sampler(epoch) -> (const, pos)``: ``const`` holds the epoch's
          scene constants (textures, background), ``pos`` the positions,
          whose leaves lead with ``steps_per_epoch * batch``; both are
          numpy arrays (or tensors) in dicts, lists or tuples, uploaded once
          an epoch; each step takes its slice of ``pos`` on the device;
        - ``val_pairs`` / ``val_flow``: the held-out set of ``fit``.

        ``resume`` continues the epoch numbering (the sampler's seeds and the
        step count that seeds the spatial transform) from ``ckpt_meta.json``
        and cuts ``loss.json`` to it, but only when a checkpoint was
        restored.  ``loss.json``, ``val_epe``, ``ckpt_every`` and ``STOP``
        as in ``fit``; the loss parts are read from the device once an epoch.
        """
        cfg = self.cfg
        try:  # a stale sentinel from an earlier stop must not end a new run
            os.remove(os.path.join(cfg.exp_dir, "STOP"))
        except OSError:
            pass
        epochs = epochs if epochs is not None else cfg.n_epoch
        guess = self._completed_epochs() if resume else 0
        probe = pos_sampler(guess)
        n_pos = _leaves(probe[1])[0].shape[0]
        if n_pos % steps_per_epoch:
            raise ValueError(f"{n_pos} positions do not divide into {steps_per_epoch} steps")
        batch = n_pos // steps_per_epoch

        def take(pos, s: int):
            return _tree_map(lambda a: a[s * batch : (s + 1) * batch], pos)

        probe_dev = _tree_map(self._to_device, probe)
        restored = self.state is not None  # a live in-memory state continues
        if self.state is None:
            const, pos = probe_dev
            im1 = gen_fn(const, take(pos, 0))[0]
            for d in im1.shape[1:-1]:
                if d % cfg.pad_multiple:
                    raise ValueError(f"generated spatial dim {d} violates "
                                     f"pad_multiple={cfg.pad_multiple}")
            self.init_state(steps_per_epoch=steps_per_epoch)
            if resume:
                restored = self.load_checkpoint()
        start_epoch = 0
        if resume:
            if restored:
                start_epoch = guess
                self._truncate_loss_json(start_epoch)
            else:
                print("resume requested but no checkpoint restored; starting from epoch 0 "
                      "with untruncated loss.json left in place", flush=True)
        self.state.step = start_epoch * steps_per_epoch
        val = None
        if val_pairs is not None and val_flow is not None:
            val = self._device_val(val_pairs, val_flow)

        history = []
        t0 = time.time()
        for epoch in range(start_epoch, start_epoch + epochs):
            const, pos = (probe_dev if epoch == guess
                          else _tree_map(self._to_device, pos_sampler(epoch)))
            meter: dict[str, torch.Tensor] = {}
            for s in range(steps_per_epoch):
                im1, im2, _ = gen_fn(const, take(pos, s))
                parts = self.train_step({"im1": im1.float(), "im2": im2.float()})
                for k, v in parts.items():
                    meter[k] = meter[k] + v if k in meter else v
            means = self._close_epoch(meter, steps_per_epoch, val, epoch, start_epoch, epochs)
            history.append(means)
            if log_every and self.is_writer:
                done = (epoch - start_epoch + 1) * steps_per_epoch
                print(f"epoch {epoch} step {self.state.step} loss {means['loss_total']:.5f} "
                      f"({done / (time.time() - t0):.2f} it/s)", flush=True)
            if self._stop_requested():
                print(f"STOP sentinel: ending after epoch {epoch}", flush=True)
                break
        return history

    def _to_device(self, a) -> torch.Tensor:
        """A numpy array or tensor on the trainer's device, its dtype kept."""
        return torch.as_tensor(a, device=self.device)

    def _init_kitti(self, steps_per_epoch: int, resume: bool) -> None:
        """A fresh state on the first call (restored with ``resume``); later
        calls go on from the live one."""
        if self.state is None:
            self.init_state(steps_per_epoch=steps_per_epoch)
            if resume:
                self.load_checkpoint()

    def _kitti_epochs(self, next_batch, steps_per_epoch: int, epochs: int,
                      log_every: int) -> list[dict[str, float]]:
        """The epochs of both KITTI loops: ``next_batch()`` gives each step's
        device batch; ``loss.json`` and the checkpoint every epoch."""
        history = []
        t0 = time.time()
        step = 0
        for epoch in range(epochs):
            # the meter stays on the device and is read at the log lines and
            # once per epoch
            meter: dict[str, torch.Tensor] = {}
            n = 0
            for _ in range(steps_per_epoch):
                parts = self.train_step(next_batch())
                for k, v in parts.items():
                    meter[k] = meter[k] + v if k in meter else v
                n += 1
                step += 1
                if log_every and step % log_every == 0 and self.is_writer:
                    print(f"epoch {epoch} step {step} loss "
                          f"{float(meter['loss_total']) / n:.5f} "
                          f"({step / (time.time() - t0):.2f} it/s)", flush=True)
            epoch_means = {k: float(v) / max(n, 1) for k, v in meter.items()}
            history.append(epoch_means)
            self._append_loss_json(epoch_means)
            self.save_checkpoint(epochs_completed=epoch + 1)
        return history

    def fit_kitti(self, dataset, steps_per_epoch: int, epochs: int | None = None,
                  log_every: int = 20, resume: bool = False) -> list[dict[str, float]]:
        """Streamed KITTI-multiview training: each step a host batch from
        ``dataset.sample(batch)`` (a ``data.kitti.KittiPairDataset``, a
        ``PrefetchSampler`` over it, or anything that returns its dict of
        ``im1``, ``im2``, ``im1_raw``, ``im2_raw``, ``start``), sent to the
        device from pinned memory without blocking; the raw windows and
        ``start`` route the photometric term through boundary-dilated warping.

        ``resume`` restores the checkpoint when the trainer has no state yet;
        ``loss.json`` and the checkpoint are written every epoch."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.n_epoch
        batch = self._batch_size()
        self._init_kitti(steps_per_epoch, resume)
        pin = self.device.type == "cuda"

        def next_batch():
            out = {}
            for k, v in dataset.sample(batch).items():
                t = torch.from_numpy(np.ascontiguousarray(v, np.float32))
                out[k] = (t.pin_memory() if pin else t).to(self.device, non_blocking=pin)
            return out

        return self._kitti_epochs(next_batch, steps_per_epoch, epochs, log_every)

    def kitti_store(self, cache) -> torch.Tensor:
        """``cache.frames`` on the device, uploaded once per (trainer, cache):
        bfloat16 with ``cfg.bfloat16``, else float32.  A later call with the
        same cache returns the same tensor."""
        if getattr(self, "_kitti_cache", None) is not cache:
            dtype = torch.bfloat16 if self.cfg.bfloat16 else torch.float32
            frames = cache.frames
            store = torch.empty(frames.shape, dtype=dtype, device=self.device)
            chunk = 16  # frames per copy: the host never holds a second full copy
            for i in range(0, frames.shape[0], chunk):
                store[i : i + chunk].copy_(torch.from_numpy(frames[i : i + chunk]))
            self._kitti_store, self._kitti_cache = store, cache
        return self._kitti_store

    def fit_kitti_hbm(self, cache, steps_per_epoch: int, epochs: int | None = None,
                      log_every: int = 20, resume: bool = False) -> list[dict[str, float]]:
        """KITTI-multiview training from a device-resident ``KittiHBMCache``:
        the frames go to the device once (``kitti_store``); each step
        (``kitti_batch``) the host draws the pair indices, crop offsets and
        flip and swap bits from ``np.random.default_rng(cfg.seed + 2)``
        (``KittiHBMCache.draw``), only those cross to the device, and
        ``data.kitti.device_batch`` cuts the crops, the rho-dilated raw
        windows, the flips and the swaps out of the store there and casts
        them to float32.  Each call starts the draws
        afresh.  ``resume``, ``loss.json`` and the checkpoint as in
        ``fit_kitti``."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.n_epoch
        store = self.kitti_store(cache)
        self._init_kitti(steps_per_epoch, resume)
        rng = np.random.default_rng(cfg.seed + 2)
        return self._kitti_epochs(lambda: self.kitti_batch(cache, store, rng), steps_per_epoch,
                                  epochs, log_every)

    def kitti_batch(self, cache, store: torch.Tensor,
                    rng: np.random.Generator) -> dict[str, torch.Tensor]:
        """One step's device batch of ``fit_kitti_hbm``: ``cache.draw`` on the
        host (the batch size's pair indices, crop offsets, flips and swaps
        from ``rng``), then ``data.kitti.device_batch`` cuts it out of
        ``store`` (``kitti_store``'s frames, or any ``[F, H, W, 3]`` tensor of
        the cache's frame shape) on the device."""
        drawn = [torch.from_numpy(np.asarray(a)) for a in cache.draw(rng, self._batch_size())]
        return device_batch(store, *drawn, cache.crop, cache.rho)

    def predict(self, pairs: np.ndarray):
        """Eval forward on ``[N, 2, H, W, C]`` (edge-padded to the multiple):
        (loss parts, ``{"flow_f", "flow_b"}`` channels-last on the device)."""
        pairs, _ = pad_to_multiple(pairs, self.cfg.pad_multiple, leading_axes=2)
        if self.state is None:
            self.init_state()
        return self.eval_step(self._batch(self.upload(pairs)))

    # -- persistence --------------------------------------------------------
    def _completed_epochs(self) -> int:
        """Epochs completed at the last checkpoint: ``ckpt_meta.json``, which
        is written with each save, else the length of ``loss.json``."""
        meta = os.path.join(self.cfg.exp_dir, "ckpt_meta.json")
        if os.path.exists(meta):
            with open(meta) as f:
                return int(json.load(f).get("epochs_completed", 0))
        path = os.path.join(self.cfg.exp_dir, "loss.json")
        if not os.path.exists(path):
            return 0
        with open(path) as f:
            return len(json.load(f).get("loss", []))

    def _append_loss_json(self, parts: dict[str, float]) -> None:
        if not self.is_writer:
            return
        os.makedirs(self.cfg.exp_dir, exist_ok=True)
        path = os.path.join(self.cfg.exp_dir, "loss.json")
        data = {"loss": []}
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
        data["loss"].append(parts)
        with open(path, "w") as f:
            json.dump(data, f, indent=4)

    def _truncate_loss_json(self, n_epochs: int) -> None:
        """Drop ``loss.json`` entries past the restored checkpoint (a resume
        after a crash between ``ckpt_every`` saves runs those epochs again)."""
        path = os.path.join(self.cfg.exp_dir, "loss.json")
        if not self.is_writer or not os.path.exists(path):
            return
        with open(path) as f:
            data = json.load(f)
        if len(data.get("loss", [])) > n_epochs:
            data["loss"] = data["loss"][:n_epochs]
            with open(path, "w") as f:
                json.dump(data, f, indent=4)

    def _stop_requested(self) -> bool:
        """``<exp_dir>/STOP`` ends the run at the next epoch boundary, after
        its checkpoint; under data parallelism rank 0's view, broadcast, so
        that the ranks end together."""
        stop = os.path.exists(os.path.join(self.cfg.exp_dir, "STOP"))
        return stop if self.mesh is None else self.mesh.agree(stop, self.device)

    def checkpoint_path(self) -> str:
        return os.path.abspath(os.path.join(self.cfg.exp_dir, "upflow.ckpt"))

    def save_checkpoint(self, epochs_completed: int | None = None) -> None:
        """The model, optimizer, schedule and step, and ``ckpt_meta.json``
        (rank 0 only; the same file one device writes)."""
        if not self.is_writer:
            return
        s = self.state
        save_state(self.checkpoint_path(), s.model, s.optimizer, s.scheduler, s.step)
        if epochs_completed is not None:
            with open(os.path.join(self.cfg.exp_dir, "ckpt_meta.json"), "w") as f:
                json.dump({"epochs_completed": int(epochs_completed)}, f)

    def load_checkpoint(self) -> bool:
        """Restore if a checkpoint exists; without one, keep the fresh state
        and say so.  A file that is there but unusable raises."""
        s = self.state
        try:
            s.step = restore_state(self.checkpoint_path(), s.model, s.optimizer, s.scheduler)
        except FileNotFoundError:
            print(f"No checkpoint at {self.checkpoint_path()}; training from scratch.",
                  flush=True)
            return False
        return True
