"""Training runtime: config, schedule, train / eval steps, checkpoints."""

from opticalflowscivis_tpu_torch.training.config import ModelConfig, OptimConfig, TrainConfig
from opticalflowscivis_tpu_torch.training.schedule import warmup_cosine
from opticalflowscivis_tpu_torch.training.trainer import (
    Trainer,
    TrainState,
    build_model,
    make_train_step,
    split_batch,
)
from opticalflowscivis_tpu_torch.training.upflow_trainer import (
    UPFlowTrainConfig,
    UPFlowTrainer,
    frames_to_pairs,
)

__all__ = [
    "ModelConfig", "OptimConfig", "TrainConfig", "warmup_cosine",
    "Trainer", "TrainState", "build_model", "make_train_step", "split_batch",
    "UPFlowTrainConfig", "UPFlowTrainer", "frames_to_pairs",
]
