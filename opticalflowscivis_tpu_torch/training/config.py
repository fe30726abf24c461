"""Training configuration: one dataclass tree.

Counterpart of ``opticalflowscivis_tpu/training/config.py``.  The field names
are the reference's, so a config json written by either package loads in the
other.  ``validate`` refuses what cannot run: ``compiler_options`` (XLA
overrides of the JAX package) and mesh degrees below 1.  A volume depth that
does not split over ``n_space`` ranks is refused where the data meets the
mesh (``parallel.spatial.volume_batch_sharding``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from opticalflowscivis_tpu_torch.losses.rife import RIFELossWeights


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """AdamW + warmup-cosine schedule."""

    lr_max: float = 3e-4
    lr_min: float = 3e-6
    warmup_steps: int = 2000
    weight_decay: float = 1e-3
    world_scale: float = 1.0  # the reference multiplies lr by world_size / 4
    grad_clip: float = 0.0  # global-norm clip; 0 = off (the reference has none)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """IFNet architecture knobs."""

    ndim: int = 2
    in_channels: int = 1
    block_channels: tuple[int, ...] = (128, 96, 64)
    scales: tuple[int, ...] = (4, 2, 1)
    teacher_channels: int = 64
    teacher_scale: int = 1  # > 1 is a 3-D single-device training mode
    conv0_kernel: int = 3
    arbitrary_timestep: bool = False
    refine: bool = False
    bfloat16: bool = True  # compute dtype (parameters and optimizer state stay f32)
    fast_warp_r: int = 16  # warp radius: flows are clipped to ±r (0 = unbounded); in
    #   3-D the in-plane radius, used only with bounded_warp_rz > 0
    bounded_warp_rz: int = 0  # 3-D warp z radius (0 = unbounded)
    remat: bool = False  # recompute the IFBlocks in the backward (3-D memory)

    @staticmethod
    def preset_2d(**kw) -> "ModelConfig":
        return ModelConfig(**kw)

    @staticmethod
    def preset_3d(**kw) -> "ModelConfig":
        kw.setdefault("bounded_warp_rz", 8)  # data velocities <= 8 px/step
        kw.setdefault("fast_warp_r", 8)
        kw.setdefault("block_channels", (128, 64, 64))
        kw.setdefault("conv0_kernel", 4)
        return ModelConfig(ndim=3, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    dataset: str = "rectangle2d"
    exp: int = 1  # interpolation factor 2**exp
    epochs: int = 300
    batch_size: int | None = None  # None → registry per-dataset default
    seed: int = 1234
    data_dir: str = "data_cache"
    results_dir: str = "Results"
    log_dir: str = "train_log"
    model_name: str = "flownet"
    eval_every: int = 1  # evaluate() runs per epoch
    keep_best_only: bool = False  # checkpoint only on a new best validation loss
    early_stop_patience: int = 0  # 0 = off
    pad_multiple: int = 32
    n_data: int | None = None  # data-parallel degree: the processes of the default
    #   group (torchrun); None = all of them, or one device without a group
    hbm_dataset_gb: float = 6.0  # keep the train/val sets in GPU memory when
    #   they fit (0 = always stream): one upload, then only batch *indices*
    #   go to the device per step
    hbm_dataset_dtype: str = "float32"  # "bfloat16" halves the resident bytes
    #   (targets quantize to ~3 decimal digits)
    device_flip_aug: bool = False  # flip-augment per batch on the device
    #   instead of 4x-ing the host arrays: only the unaugmented base tuples
    #   are kept resident
    n_space: int = 1  # spatial-shard degree: the space axis of the (n_data, n_space)
    #   mesh; > 1 without spatial_shard repeats each step over it, as the reference does
    spatial_shard: bool = False  # shard the first spatial axis (a volume's depth,
    #   a frame's height) over the space axis
    debug_nans: bool = False  # torch.autograd.set_detect_anomaly
    compiler_options: dict | None = None  # XLA overrides of the JAX package; must be unset
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    loss: RIFELossWeights = dataclasses.field(default_factory=RIFELossWeights)

    def validate(self) -> None:
        """Raise on a field that asks for what cannot run, saying what to change."""
        if self.n_data is not None and self.n_data < 1:
            raise ValueError(f"n_data must be >= 1, got {self.n_data}")
        if self.n_space < 1:
            raise ValueError(f"n_space must be >= 1 (1: no spatial sharding), got {self.n_space}")
        if self.compiler_options:
            raise ValueError(
                "compiler_options are XLA overrides of the JAX package and mean "
                "nothing to PyTorch; leave them unset"
            )
        if self.hbm_dataset_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"hbm_dataset_dtype {self.hbm_dataset_dtype!r}")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "TrainConfig":
        raw: dict[str, Any] = json.loads(s)
        model_raw = dict(raw.get("model", {}))
        for k in ("block_channels", "scales"):
            if k in model_raw:
                model_raw[k] = tuple(model_raw[k])
        raw["model"] = ModelConfig(**model_raw)
        raw["optim"] = OptimConfig(**raw.get("optim", {}))
        raw["loss"] = RIFELossWeights(**raw.get("loss", {}))
        return TrainConfig(**raw)
