"""Evaluation suite: interpolation metrics and flow accuracy (time-step
selection is ported in a later slice, ROADMAP A.11)."""

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

__all__ = [
    "calculate_psnr", "calculate_ssim", "calculate_metrics", "calculate_diff",
    "linear_interpolation_baseline",
    "flow_epe", "flow_outlier_pct", "evaluate_flow",
]
