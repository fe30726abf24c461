"""Time-step selection — pick the frames worth keeping for interpolation.

The reference's third task (README.md:3 "time step selection") exists as the
``selection`` branch of ``error.py:133-157`` (threshold on per-frame PSNR
against the interpolation) and the TODO protocol at error.py:499-505
(incrementally vary |S|, interpolate between kept frames, total error per |S|).

- ``select_timesteps``: error.py:133-157 semantics — keep the interpolated
  frames whose PSNR falls below ``threshold`` (default: mean - mean/10),
  i.e. the frames the interpolator cannot reconstruct.
- ``selection_curve``: the TODO protocol — error vs number of kept frames,
  for reporting which |S| suffices.

A copy of the reference's ``evalsuite/selection.py``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from opticalflowscivis_tpu_torch.evalsuite.metrics import calculate_psnr


def select_timesteps(
    original: np.ndarray,
    interpol: np.ndarray,
    factor: int,
    threshold: float | None = None,
    data_range: float = 255.0,
) -> tuple[list[int], float]:
    """Indices of interpolated frames with PSNR below threshold (keep-worthy)."""
    n = min(original.shape[0], interpol.shape[0])
    psnrs = {
        i: calculate_psnr(original[i], interpol[i], data_range)
        for i in range(n)
        if i % factor != 0
    }
    finite = [v for v in psnrs.values() if np.isfinite(v)]
    mean = float(np.mean(finite)) if finite else float("inf")
    if threshold is None:
        threshold = mean - mean / 10.0  # error.py:135
    selected = [i for i, v in psnrs.items() if v < threshold]
    return selected, threshold


def selection_curve(
    frames: np.ndarray,
    reconstruct: Callable[[np.ndarray, int], np.ndarray],
    factors: tuple[int, ...] = (2, 4, 8, 16, 32),
    data_range: float = 255.0,
) -> dict[int, dict[str, float]]:
    """Total/mean reconstruction error vs number of kept frames.

    ``reconstruct(frames, factor)`` returns the interpolated series (e.g.
    ``inference.interpolate_series`` or the linear baseline).
    """
    out = {}
    for factor in factors:
        if frames.shape[0] < factor + 1:
            break
        recon = reconstruct(frames, factor)
        n = min(frames.shape[0], recon.shape[0])
        errs = [
            calculate_psnr(frames[i], recon[i], data_range)
            for i in range(n)
            if i % factor != 0
        ]
        finite = [e for e in errs if np.isfinite(e)]
        n_kept = len(range(0, n, factor))
        out[factor] = {
            "n_kept": n_kept,
            "mean_psnr": float(np.mean(finite)) if finite else float("inf"),
            "total_psnr": float(np.sum(finite)),
        }
    return out
