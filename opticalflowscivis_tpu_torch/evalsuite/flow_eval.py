"""Optical-flow accuracy metrics — KITTI Evaluation_bench protocol (numpy).

The port's own copy of ``opticalflowscivis_tpu/evalsuite/flow_eval.py``, pinned
to it by an equality test on fixed seeds:

- ``flow_epe``: masked mean euclidean end-point error.
- ``flow_outlier_pct``: % of masked pixels with EPE > max(3.0, 0.05 * |gt|).
- ``evaluate_flow``: EPE over all / occluded / non-occluded pixels and F1,
  given occ and noc validity masks.

Flow convention: ``[B, *S, 2]`` channels-last, row-major (dy, dx).
"""

from __future__ import annotations

import numpy as np


def _euclid(diff: np.ndarray) -> np.ndarray:
    return np.sqrt(np.sum(np.asarray(diff, np.float64) ** 2, axis=-1, keepdims=True))


def flow_epe(flow_pred: np.ndarray, flow_gt: np.ndarray, mask: np.ndarray | None = None) -> float:
    """Masked average end-point error; mask is ``[..., 1]`` validity (1=count)."""
    diff = _euclid(flow_pred - flow_gt)
    if mask is None:
        mask = np.ones_like(diff)
    return float(np.sum(diff * mask) / (np.sum(mask) + 1e-6))


def flow_outlier_pct(
    flow_gt: np.ndarray,
    flow_pred: np.ndarray,
    mask: np.ndarray | None = None,
    threshold: float = 3.0,
    relative: float | None = 0.05,
) -> float:
    diff = _euclid(flow_gt - flow_pred)
    if mask is None:
        mask = np.ones_like(diff)
    diff = diff * mask
    if relative is not None:
        thr = np.maximum(threshold, _euclid(flow_gt) * relative)
        outliers = diff > thr
    else:
        outliers = diff > threshold
    return float(np.sum(outliers) / (np.sum(mask) + 1e-6) * 100.0)


def evaluate_flow(
    flow_pred: np.ndarray,
    flow_gt_occ: np.ndarray,
    mask_occ: np.ndarray,
    flow_gt_noc: np.ndarray | None = None,
    mask_noc: np.ndarray | None = None,
) -> dict[str, float]:
    """Evaluation_bench result dict: EPE all / occ / noc and F1."""
    out = {
        "epe_all": flow_epe(flow_pred, flow_gt_occ, mask_occ),
        "f1_all": flow_outlier_pct(flow_gt_occ, flow_pred, mask_occ),
    }
    if flow_gt_noc is not None and mask_noc is not None:
        out["epe_noc"] = flow_epe(flow_pred, flow_gt_noc, mask_noc)
        mask_occ_only = mask_occ * (1.0 - mask_noc)
        out["epe_occ"] = flow_epe(flow_pred, flow_gt_occ, mask_occ_only)
    return out
