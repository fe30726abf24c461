"""RIFE training runtime, on one device or data-parallel.

Counterpart of ``opticalflowscivis_tpu/training/trainer.py``:

- ``TrainState``: the model, AdamW(weight_decay=1e-3) at base lr 1, a
  ``LambdaLR`` over ``warmup_cosine`` (the schedule returns the rate itself)
  and the step count.  The first update runs at lr 0, as with optax, which
  evaluates the schedule at the count before the update;
- ``make_train_step``: forward, all losses, backward and the optimizer update
  in one function, and the eval step beside it.  The train step updates the
  state in place;
- ``Trainer.fit``: a dataset kept on the device with index batches and
  on-device flips (or streamed batches when it does not fit), a per-epoch
  ``evaluate`` that appends the reference's 7-component loss tuple to
  ``<results_dir>/<dataset>/<factor>x/<model_name>/loss.json``, a checkpoint
  that also holds the optimizer state, keep-best and early stopping.

Batches are channels-last ``[B, slots, *S, C]`` (2-D frames or 3-D volumes)
as the data pipeline makes them; the model runs channels-first and its
outputs are handed to the losses as channels-last views.  Parameters and optimizer state are float32; with
``ModelConfig.bfloat16`` the model computes in bfloat16.

``fit_device_gen`` trains from batches composed on the device from integer
positions (``data.device_synthetic``): the positions go up once an epoch, the
frames never cross from the host.

Data parallelism (``TrainConfig.n_data``, one process a device under
``torchrun``; ``parallel.data_parallel_mesh``): every rank draws the same
global batch with the same seeds (shuffles, on-device flips, samplers), keeps
its rows at the entry of the train step, and averages the gradients over the
ranks by one all-reduce; the loss terms that are not linear in the batch are
taken over the global batch (``losses.rife``), so the step equals the
one-device step on the global batch.  The returned parts, ``loss.json`` and
the validation loss are global values (every rank evaluates the whole
validation set); rank 0 alone writes files, and checkpoints keep the
one-device format.  ``n_data`` above 1 without a process group of that size
raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections.abc import Callable, Iterable

import numpy as np
import torch

from opticalflowscivis_tpu_torch.data import (
    TupleDataset,
    device_flip_augment,
    flip_augment,
    get_spec,
    load_data,
    pad_to_multiple,
)
from opticalflowscivis_tpu_torch.device import resolve_device
from opticalflowscivis_tpu_torch.losses.rife import rife_losses
from opticalflowscivis_tpu_torch.models.ifnet import IFNet
from opticalflowscivis_tpu_torch.parallel.mesh import Mesh, data_parallel_mesh, shard_batch
from opticalflowscivis_tpu_torch.parallel.multihost import local_device
from opticalflowscivis_tpu_torch.training.checkpoint import restore_state, save_state
from opticalflowscivis_tpu_torch.training.config import TrainConfig
from opticalflowscivis_tpu_torch.training.schedule import warmup_cosine


@dataclasses.dataclass
class TrainState:
    model: IFNet
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def build_model(cfg: TrainConfig, device: str | torch.device | None = None) -> IFNet:
    m = cfg.model
    return IFNet(
        ndim=m.ndim,
        in_channels=m.in_channels,
        block_channels=tuple(m.block_channels),
        scales=tuple(m.scales),
        teacher_channels=m.teacher_channels,
        teacher_scale=m.teacher_scale,
        arbitrary_timestep=m.arbitrary_timestep,
        conv0_kernel=m.conv0_kernel,
        refine=m.refine,
        fast_warp_r=m.fast_warp_r,
        bounded_warp_rz=m.bounded_warp_rz,
        remat=m.remat,
        dtype=torch.bfloat16 if m.bfloat16 else None,
        device=device,
        seed=cfg.seed,
    )


def split_batch(batch: torch.Tensor, ndim: int, has_flow: bool):
    """``[B, slots, *S, C]`` → (img0, img1, gt, gt_flow|None), channels-last.

    Slot order is (img0, img1, gt...) per ``data.group_tuples``; channel 0 is
    the scalar field, channels 1..ndim the ground-truth flow.
    """
    img0 = batch[:, 0, ..., :1]
    img1 = batch[:, 1, ..., :1]
    gt = batch[:, 2, ..., :1]
    gt_flow = batch[:, 2, ..., 1 : 1 + ndim] if has_flow else None
    return img0, img1, gt, gt_flow


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """Channels-last ``[B, *S, C]`` → channels-first ``[B, C, *S]`` (a view)."""
    return x.movedim(-1, 1)


def _channels_last(x):
    if x is None:
        return None
    if isinstance(x, list):
        return [_channels_last(t) for t in x]
    return x.movedim(1, -1)


def make_train_step(model: IFNet, cfg: TrainConfig, has_flow: bool,
                    gt_flow_scale: float = 1.0, mesh: Mesh | None = None):
    """``(train_step, eval_step)`` over a ``TrainState`` and a device batch.

    With a data-parallel ``mesh`` the train step takes the global batch, runs
    on this rank's rows and averages the gradients and the parts over the
    ranks; the eval step runs the whole batch it is given."""
    ndim = cfg.model.ndim

    def losses(batch: torch.Tensor, mesh: Mesh | None = None):
        img0, img1, gt, gt_flow = split_batch(batch, ndim, has_flow)
        if gt_flow is not None and gt_flow_scale != 1.0:
            gt_flow = gt_flow * gt_flow_scale  # stored units → px/frame
        out = model(_nchw(img0), _nchw(img1), _nchw(gt))
        outputs = {k: v if k == "loss_distill" else _channels_last(v) for k, v in out.items()}
        loss, parts = rife_losses(
            outputs, img0, img1, gt, dict(model.named_parameters()), cfg.loss, ndim,
            gt_flow=gt_flow, fast_warp_r=cfg.model.fast_warp_r, mesh=mesh,
        )
        return loss, parts, outputs

    def train_step(state: TrainState, batch: torch.Tensor) -> dict[str, torch.Tensor]:
        """One update of ``state`` in place; returns the detached loss parts."""
        state.optimizer.zero_grad(set_to_none=True)
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        loss, parts, _ = losses(batch, mesh)
        loss.backward()
        if mesh is not None:
            mesh.average_gradients(model.parameters())
        if cfg.optim.grad_clip:
            torch.nn.utils.clip_grad_norm_(model.parameters(), cfg.optim.grad_clip)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        parts = {k: v.detach() for k, v in parts.items()}
        return parts if mesh is None else mesh.mean_values(parts)

    def eval_step(state: TrainState, batch: torch.Tensor):
        with torch.no_grad():
            _, parts, outputs = losses(batch)
        # merged prediction + teacher + flow for metric / visual consumers
        extras = {
            "pred": outputs["merged"][-1],
            "pred_tea": outputs["merged_teacher"],
            "flow": outputs["flow_list"][-1],
            "mask": outputs["mask_list"][-1],
        }
        return parts, extras

    return train_step, eval_step


class Trainer:
    """End-to-end RIFE trainer (2-D and 3-D by config).  Runs on ``cuda`` unless
    ``device="cpu"``; data-parallel on ``cuda:LOCAL_RANK`` under a process group."""

    def __init__(self, cfg: TrainConfig, device: str | torch.device | None = None):
        cfg.validate()
        self.cfg = cfg
        self.mesh = data_parallel_mesh(cfg.n_data)
        self.n_data = 1 if self.mesh is None else self.mesh.n_data
        self.device = resolve_device(device) if self.mesh is None else local_device(device)
        if cfg.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        self.spec = get_spec(cfg.dataset)
        if cfg.model.ndim != self.spec.ndim:
            raise ValueError(f"model ndim {cfg.model.ndim} != dataset ndim {self.spec.ndim}")
        self.model = build_model(cfg, self.device)
        if self.mesh is not None:
            self.mesh.broadcast_module(self.model)
        self.has_flow = self.spec.has_flow and cfg.loss.flow > 0
        self._train_step_fn, self._eval_step_fn = make_train_step(
            self.model, cfg, self.has_flow, gt_flow_scale=self.spec.gt_flow_stride,
            mesh=self.mesh,
        )
        self.state: TrainState | None = None
        self.steps_per_epoch = 1  # set by fit()

    # -- state ------------------------------------------------------------
    def init_state(self, total_steps: int) -> TrainState:
        """Build the optimizer and the schedule for a run of ``total_steps``."""
        o = self.cfg.optim
        optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=1.0, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=o.weight_decay,
        )
        schedule = warmup_cosine(o.lr_max, o.lr_min, o.warmup_steps, total_steps, o.world_scale)
        scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)
        self.state = TrainState(self.model, optimizer, scheduler)
        return self.state

    # -- data -------------------------------------------------------------
    def load_datasets(self):
        cfg = self.cfg
        # data-parallel: rank 0 writes a generated series and the prepared
        # tuples' cache, the other ranks read them after it
        if self.mesh is not None and not self.is_writer:
            self.mesh.barrier(self.device)
        train, val = load_data(
            cfg.dataset, cfg.exp, "train", cfg.data_dir,
            # on-device augmentation → keep the host arrays unaugmented
            host_flip_aug=False if cfg.device_flip_aug else None,
        )
        if self.mesh is not None and self.is_writer:
            self.mesh.barrier(self.device)
        return self._pad_spatial(train), self._pad_spatial(val)

    def _pad_spatial(self, arr: np.ndarray) -> np.ndarray:
        out, _ = pad_to_multiple(arr, self.cfg.pad_multiple, leading_axes=2)
        return out

    def upload(self, arr: np.ndarray, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """A numpy batch or dataset as a tensor on the trainer's device."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, dtype)

    # -- steps --------------------------------------------------------------
    @property
    def is_writer(self) -> bool:
        """Whether this process writes files and logs (rank 0, or the only one)."""
        return self.mesh is None or self.mesh.is_writer

    def train_step(self, batch: torch.Tensor) -> dict[str, torch.Tensor]:
        """One optimizer update on a device batch ``[B, slots, *S, C]`` (the
        global batch under data parallelism); returns the loss parts as 0-d
        tensors on the device."""
        return self._train_step_fn(self.state, batch)

    def eval_step(self, batch: torch.Tensor):
        """Loss parts and the extras dict (pred, pred_tea, flow, mask) of a
        device batch, without gradients."""
        return self._eval_step_fn(self.state, batch)

    # -- loops ------------------------------------------------------------
    def fit(self, train_tuples: np.ndarray, val_tuples: np.ndarray,
            epochs: int | None = None, log_every: int = 50,
            on_epoch_end=None, resume: bool = False):
        """Train.  ``resume=True`` restores the checkpoint after building the
        optimizer with the *actual* step count (aug-extended): resuming from
        a caller-side init would mis-size the LR schedule."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        batch = cfg.batch_size or self.spec.batch_size
        # a multiple of the data-parallel ranks, at least one row each
        batch = max(self.n_data, (min(batch, train_tuples.shape[0]) // self.n_data) * self.n_data)
        # Device-resident dataset: one bulk upload, then only indices per step.
        # device_flip_aug keeps only the unaugmented base tuples resident and
        # extends the index space 4x (equal to the host flip_augment order).
        cache_dtype = torch.bfloat16 if cfg.hbm_dataset_dtype == "bfloat16" else torch.float32
        cache_bytes = train_tuples.nbytes * (0.5 if cache_dtype == torch.bfloat16 else 1.0)
        resident = bool(cfg.hbm_dataset_gb and cache_bytes <= cfg.hbm_dataset_gb * 1e9)
        aug = 1
        if cfg.device_flip_aug and self.spec.flip_aug:
            if resident:
                aug = 4
            else:
                # streaming fallback: materialize the host augmentation.
                # flip_augment expects [T, *S, C], so flatten the tuple slots
                # first (flipping the 5-D tuple array directly would mirror
                # the slots axis and miss the flow-sign negation)
                flat = train_tuples.reshape((-1,) + train_tuples.shape[2:])
                train_tuples = flip_augment(flat).reshape((-1,) + train_tuples.shape[1:])

        ds = TupleDataset(train_tuples, batch, seed=cfg.seed)
        n_base = train_tuples.shape[0]
        self.steps_per_epoch = (n_base * aug) // batch
        self._ensure_state(max(self.steps_per_epoch * epochs, 1), resume)

        if val_tuples.shape[0] == 0:
            # tiny series can produce an empty val split: fall back to a train
            # batch so the per-epoch eval / checkpoint logic still runs
            val_tuples = train_tuples[:batch]
        val = val_tuples
        if resident:
            data_dev = self.upload(train_tuples, cache_dtype)
            if val_tuples.nbytes <= cfg.hbm_dataset_gb * 1e9 / 4:
                val = self.upload(val_tuples)

        def epoch_batches(_epoch: int) -> Iterable[torch.Tensor]:
            if not resident:
                for host_batch in ds.epoch():
                    yield self.upload(host_batch)
                return
            for idx in ds.epoch_indices(n_virtual=n_base * aug):
                idx = torch.from_numpy(idx).to(self.device)
                # virtual indices >= n_base select the on-device flips
                dev_batch = data_dev[idx % n_base]
                if aug > 1:
                    dev_batch = device_flip_augment(dev_batch, idx // n_base, cfg.model.ndim)
                yield dev_batch.float()

        return self._run_epochs(epochs, epoch_batches, val, batch, log_every, on_epoch_end)

    def fit_stream(self, sample_fn: Callable[[], np.ndarray], val_tuples: np.ndarray,
                   steps_per_epoch: int, epochs: int | None = None,
                   log_every: int = 50, resume: bool = False):
        """Train from a host-side batch sampler instead of a fixed tuple array.

        ``sample_fn() -> [B, slots, *S, C]`` is called once per step (freshly
        cropped / augmented batches), so the device-resident dataset does not
        apply.  Per-epoch eval, ``loss.json``, checkpointing and early
        stopping match ``fit``.
        """
        epochs = epochs if epochs is not None else self.cfg.epochs
        self.steps_per_epoch = steps_per_epoch
        first = sample_fn()
        self._ensure_state(max(steps_per_epoch * epochs, 1), resume)
        if val_tuples.shape[0] == 0:
            val_tuples = first

        def epoch_batches(_epoch: int) -> Iterable[torch.Tensor]:
            for _ in range(steps_per_epoch):
                yield self.upload(sample_fn())

        return self._run_epochs(epochs, epoch_batches, val_tuples, first.shape[0], log_every)

    def fit_device_gen(self, gen_fn: Callable[[torch.Tensor], torch.Tensor],
                       pos_sampler: Callable[[int], np.ndarray], val_positions: np.ndarray,
                       steps_per_epoch: int, epochs: int | None = None, log_every: int = 50,
                       resume: bool = False):
        """Train from batches generated on the device from integer positions.

        - ``gen_fn(pos [B, slots, nd] int) -> [B, slots, *S, C]`` runs on the
          device inside each step (e.g. ``data.box_density_device``);
        - ``pos_sampler(epoch) -> [steps_per_epoch * B, slots, nd]``: host
          ints, a fresh trajectory every epoch, uploaded once an epoch and
          sliced on the device;
        - ``val_positions [Nv, slots, nd]``: the held-out set, generated once
          and kept on the device for the per-epoch evaluation.

        Evaluation, ``loss.json``, checkpoints and early stopping as in
        ``fit``.  The generated spatial dims must be multiples of
        ``cfg.pad_multiple``.  ``resume`` continues the epoch numbering (so
        the sampler's seeds) from ``loss.json``, but only when a checkpoint
        was restored: a run that restored nothing starts at epoch 0.
        """
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        self.steps_per_epoch = steps_per_epoch
        guess = self._completed_epochs() if resume else 0
        first_pos = pos_sampler(guess)
        n_pos = first_pos.shape[0]
        if n_pos % steps_per_epoch:
            raise ValueError(f"{n_pos} positions do not divide into {steps_per_epoch} steps")
        batch = n_pos // steps_per_epoch
        val_dev = gen_fn(self._positions(val_positions)).float()
        for d in val_dev.shape[2:-1]:
            if d % cfg.pad_multiple:
                raise ValueError(f"generated spatial dim {d} violates "
                                 f"pad_multiple={cfg.pad_multiple}")
        restored = resume  # a live state continues its run
        if self.state is None:
            self.init_state(max(steps_per_epoch * epochs, 1))
            if resume:
                restored = self.load_checkpoint()
        start_epoch = guess if (resume and restored) else 0
        if resume and not restored:
            print("resume requested but no checkpoint restored; starting from epoch 0",
                  flush=True)

        def epoch_batches(epoch: int) -> Iterable[torch.Tensor]:
            pos = self._positions(first_pos if epoch == guess else pos_sampler(epoch))
            for s in range(steps_per_epoch):
                yield gen_fn(pos[s * batch : (s + 1) * batch]).float()

        return self._run_epochs(epochs, epoch_batches, val_dev, batch, log_every,
                                start_epoch=start_epoch)

    def _positions(self, pos: np.ndarray) -> torch.Tensor:
        """Host positions as an integer tensor on the trainer's device."""
        return torch.from_numpy(np.ascontiguousarray(pos)).to(self.device)

    def _ensure_state(self, total_steps: int, resume: bool) -> None:
        if self.state is None:
            self.init_state(total_steps)
            if resume:
                self.load_checkpoint()

    def _run_epochs(self, epochs: int, epoch_batches, val, batch: int, log_every: int,
                    on_epoch_end=None, start_epoch: int = 0) -> list[dict[str, float]]:
        """The epoch loop of ``fit``, ``fit_stream`` and ``fit_device_gen``:
        train steps, then evaluate, append to ``loss.json``, checkpoint, maybe
        stop early.  Epochs and steps count on from ``start_epoch``."""
        cfg = self.cfg
        history = []
        best_val = np.inf
        patience = 0
        t0 = time.time()
        step0 = step = start_epoch * self.steps_per_epoch
        for epoch in range(start_epoch, start_epoch + epochs):
            for dev_batch in epoch_batches(epoch):
                parts = self.train_step(dev_batch)
                step += 1
                if log_every and step % log_every == 0 and self.is_writer:
                    g = float(parts["loss_G"])
                    rate = (step - step0) / (time.time() - t0)
                    print(f"epoch {epoch} step {step} loss_G {g:.5f} ({rate:.2f} it/s)",
                          flush=True)
            val_parts = self.evaluate(val, batch)
            history.append(val_parts)
            self._append_loss_json(val_parts)
            improved = val_parts["loss_G"] < best_val
            if improved:
                best_val = val_parts["loss_G"]
                patience = 0
            else:
                patience += 1
            if not cfg.keep_best_only or improved:
                self.save_checkpoint()
            if cfg.early_stop_patience and patience >= cfg.early_stop_patience:
                if self.is_writer:
                    print(f"early stopping at epoch {epoch}", flush=True)
                break
            if on_epoch_end is not None:
                on_epoch_end(epoch, val_parts)
        return history

    def evaluate(self, val_tuples: np.ndarray | torch.Tensor, batch_size: int | None = None):
        """Mean loss parts over ``val_tuples`` (numpy, or a tensor already on
        the device), each chunk weighted by its number of real samples."""
        n_val = val_tuples.shape[0]
        batch = max(1, min(batch_size or 16, n_val))
        sums: dict[str, float] = {}
        total_w = 0.0
        for i in range(0, n_val, batch):
            chunk = val_tuples[i : i + batch]
            if not isinstance(chunk, torch.Tensor):
                chunk = self.upload(chunk)
            r = chunk.shape[0]  # real samples in this chunk
            if r < batch:
                # tail chunk: cycle its own samples to fill the batch shape, as
                # the reference does (a few tail samples get up to one extra
                # repetition in this chunk's mean, but every sample is covered)
                chunk = chunk[torch.arange(batch, device=chunk.device) % r]
            parts, _ = self.eval_step(chunk)
            for k, v in parts.items():
                sums[k] = sums.get(k, 0.0) + float(v) * r
            total_w += r
        return {k: v / max(total_w, 1.0) for k, v in sums.items()}

    def predict(self, batch_np: np.ndarray):
        """Eval forward on ``[B, slots, *S, C]``: (loss parts, extras dict of
        channels-last tensors on the device)."""
        return self.eval_step(self.upload(batch_np))

    # -- persistence --------------------------------------------------------
    @property
    def results_dir(self) -> str:
        cfg = self.cfg
        return os.path.join(cfg.results_dir, cfg.dataset, f"{2**cfg.exp}x", cfg.model_name)

    def _completed_epochs(self) -> int:
        """Epochs already recorded in this run's ``loss.json`` (one append per epoch)."""
        path = os.path.join(self.results_dir, "loss.json")
        if not os.path.exists(path):
            return 0
        with open(path) as f:
            return len(json.load(f).get("val_loss", []))

    def _append_loss_json(self, parts: dict[str, float]) -> None:
        """Append the reference's 7-tuple to ``loss.json`` (rank 0 only)."""
        if not self.is_writer:
            return
        os.makedirs(self.results_dir, exist_ok=True)
        path = os.path.join(self.results_dir, "loss.json")
        tup = [
            parts["loss_G"], parts["loss_l1"], parts["loss_tea"],
            parts["loss_distill"], parts["l1_reg"], parts["loss_photo"],
            parts["loss_flow"],
        ]
        data = {"val_loss": []}
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
        data["val_loss"].append(tup)
        with open(path, "w") as f:
            json.dump(data, f, indent=4)

    def checkpoint_path(self) -> str:
        # scoped by dataset: with a shared default model_name two datasets
        # would silently overwrite each other
        return os.path.abspath(
            os.path.join(self.cfg.log_dir, self.cfg.dataset, self.cfg.model_name + ".ckpt")
        )

    def save_checkpoint(self) -> None:
        """The model, optimizer, schedule and step (rank 0 only; the same file
        one device writes)."""
        if not self.is_writer:
            return
        s = self.state
        save_state(self.checkpoint_path(), s.model, s.optimizer, s.scheduler, s.step)

    def load_checkpoint(self) -> bool:
        """Restore if a checkpoint exists; without one, keep the fresh state
        and say so.  A file that is there but unusable raises."""
        s = self.state
        try:
            s.step = restore_state(self.checkpoint_path(), s.model, s.optimizer, s.scheduler)
        except FileNotFoundError:
            print(f"No checkpoint at {self.checkpoint_path()}; starting from scratch.",
                  flush=True)
            return False
        return True
