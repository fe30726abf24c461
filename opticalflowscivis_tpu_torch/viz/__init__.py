"""Visualization & reporting (reference L6: utils.py, error.py plotting).

Importing it imports matplotlib."""

from opticalflowscivis_tpu_torch.viz.flow_viz import flow2rgb, flow_to_hsv, flow_to_image
from opticalflowscivis_tpu_torch.viz.panels import (
    plot_factor_comparison,
    plot_loss,
    visualize_3d,
    visualize_ind,
    visualize_large,
    visualize_large_3d,
    visualize_series,
    visualize_series_flow,
)

__all__ = [
    "flow2rgb", "flow_to_hsv", "flow_to_image",
    "plot_factor_comparison",
    "plot_loss", "visualize_ind", "visualize_series", "visualize_series_flow",
    "visualize_large", "visualize_large_3d", "visualize_3d",
]
