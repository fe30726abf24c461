"""Evaluation suite: interpolation metrics, flow accuracy and time-step
selection."""

from opticalflowscivis_tpu_torch.evalsuite.flow_eval import (
    evaluate_flow,
    flow_epe,
    flow_outlier_pct,
)
from opticalflowscivis_tpu_torch.evalsuite.metrics import (
    calculate_diff,
    calculate_metrics,
    calculate_psnr,
    calculate_ssim,
    linear_interpolation_baseline,
)
from opticalflowscivis_tpu_torch.evalsuite.selection import select_timesteps, selection_curve

__all__ = [
    "calculate_psnr", "calculate_ssim", "calculate_metrics", "calculate_diff",
    "linear_interpolation_baseline",
    "flow_epe", "flow_outlier_pct", "evaluate_flow",
    "select_timesteps", "selection_curve",
]
