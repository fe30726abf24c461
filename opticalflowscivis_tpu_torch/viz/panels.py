"""Figure panels — matplotlib ports of the reference ``utils.py`` visualizers.

- ``plot_loss``            ⇔ utils.py:36-52 — the 7 loss curves from loss.json.
- ``visualize_ind``        ⇔ utils.py:54-70 — single frame image.
- ``visualize_series``     ⇔ utils.py:72-128 — grid of frames.
- ``visualize_series_flow``⇔ utils.py:130-166 — frames with quiver overlay
  (pyimof in the reference; plain matplotlib quiver here).
- ``visualize_large``      ⇔ utils.py:168-423 — the 7-row evaluation panel:
  GT / interpolated / diff / mask / GT-flow / predicted-flow / flow-diff.
- ``visualize_large_3d``   ⇔ utils.py:425-529 — same panel on a mid-depth slice.
- ``visualize_3d``         ⇔ utils.py:531-648 — plotly volume rendering: a
  go.Volume HTML export where plotly imports, otherwise a 3-slice matplotlib
  panel.

All figures are written to ``dir_res``; matplotlib runs on the Agg backend.
A copy of the reference's ``viz/panels.py``; the CLI verbs import it inside
their drawing step, so that they run without matplotlib.
"""

from __future__ import annotations

import json
import os

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from opticalflowscivis_tpu_torch.viz.flow_viz import flow_to_image  # noqa: E402

LOSS_LABELS = ["loss_G", "loss_l1", "loss_tea", "loss_distill", "l1_reg",
               "loss_photo", "loss_flow"]


def _save(fig, dir_res: str, name: str) -> str:
    os.makedirs(dir_res, exist_ok=True)
    path = os.path.join(dir_res, name)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_loss(loss_json_path: str, dir_res: str, name: str = "loss.png") -> str:
    with open(loss_json_path) as f:
        vals = np.asarray(json.load(f)["val_loss"], np.float64)  # [E, 7]
    fig, ax = plt.subplots(figsize=(8, 5))
    for i, label in enumerate(LOSS_LABELS[: vals.shape[1]]):
        ax.plot(vals[:, i], label=label)
    ax.set_xlabel("epoch")
    ax.set_ylabel("validation loss")
    ax.legend(fontsize=8)
    return _save(fig, dir_res, name)


def visualize_ind(frame: np.ndarray, dir_res: str, name: str) -> str:
    fig, ax = plt.subplots()
    ax.imshow(np.squeeze(frame), cmap="viridis")
    ax.axis("off")
    return _save(fig, dir_res, name)


def visualize_series(
    frames: np.ndarray, dir_res: str, title: str = "series", cols: int = 10,
    max_frames: int = 100,
) -> str:
    frames = np.squeeze(frames)[:max_frames]
    n = frames.shape[0]
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(12, 1.2 * rows + 1))
    axes = np.atleast_2d(axes)
    for i in range(rows * cols):
        ax = axes.flat[i]
        ax.axis("off")
        if i < n:
            ax.imshow(frames[i], cmap="viridis")
    fig.suptitle(title)
    return _save(fig, dir_res, f"{title}.png")


def visualize_series_flow(
    frames: np.ndarray, flow: np.ndarray, dir_res: str, title: str = "flow",
    cols: int = 5, max_frames: int = 10, step: int = 8,
) -> str:
    """Frames with quiver overlay; flow ``[T, H, W, 2]`` row-major (dy, dx)."""
    frames = np.squeeze(frames)[:max_frames]
    flow = flow[:max_frames]
    n = frames.shape[0]
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(12, 2.4 * rows + 1))
    axes = np.atleast_2d(axes)
    h, w = frames.shape[1:3]
    ys, xs = np.mgrid[0:h:step, 0:w:step]
    for i in range(rows * cols):
        ax = axes.flat[i]
        ax.axis("off")
        if i < n:
            ax.imshow(frames[i], cmap="gray")
            dy = flow[i, ::step, ::step, 0]
            dx = flow[i, ::step, ::step, 1]
            ax.quiver(xs, ys, dx, -dy, color="red", scale=None, width=0.004)
    fig.suptitle(title)
    return _save(fig, dir_res, f"{title}.png")


def visualize_large(
    gt: np.ndarray,
    interpol: np.ndarray,
    diff: np.ndarray,
    mask: np.ndarray | None,
    flow_gt: np.ndarray | None,
    flow_pred: np.ndarray | None,
    dir_res: str,
    title: str = "panel",
    n_cols: int = 8,
) -> str:
    """7-row GT/Interp/Diff/Mask/FlowGT/FlowPred/FlowDiff panel (utils.py:168-423)."""
    rows: list[tuple[str, np.ndarray, bool]] = [
        ("GT", np.squeeze(gt), False),
        ("Interpolated", np.squeeze(interpol), False),
        ("Difference", np.squeeze(diff), False),
    ]
    if mask is not None:
        rows.append(("Mask", np.squeeze(mask), False))
    if flow_gt is not None:
        rows.append(("Flow GT", flow_gt, True))
    if flow_pred is not None:
        rows.append(("Flow pred", flow_pred, True))
    if flow_gt is not None and flow_pred is not None:
        n = min(flow_gt.shape[0], flow_pred.shape[0])
        rows.append(("Flow diff", flow_gt[:n] - flow_pred[:n], True))

    n_cols = min(n_cols, min(r[1].shape[0] for r in rows))
    fig, axes = plt.subplots(len(rows), n_cols,
                             figsize=(1.6 * n_cols + 1, 1.6 * len(rows) + 1))
    axes = np.atleast_2d(axes)
    for r, (label, series, is_flow) in enumerate(rows):
        for c in range(n_cols):
            ax = axes[r, c]
            ax.axis("off")
            img = flow_to_image(series[c]) if is_flow else series[c]
            ax.imshow(img, cmap=None if is_flow else "viridis")
            if c == 0:
                ax.set_title(label, fontsize=8, loc="left")
    fig.suptitle(title)
    return _save(fig, dir_res, f"{title}.png")


def visualize_large_3d(
    gt: np.ndarray, interpol: np.ndarray, diff: np.ndarray,
    dir_res: str, title: str = "panel3d", slice_frac: float = 0.5, n_cols: int = 8,
) -> str:
    """Mid-depth slice panel for volumes ``[T, D, H, W]`` (utils.py:425-529)."""
    z = int(np.squeeze(gt).shape[1] * slice_frac)
    return visualize_large(
        np.squeeze(gt)[:, z], np.squeeze(interpol)[:, z], np.squeeze(diff)[:, z],
        None, None, None, dir_res, title=title, n_cols=n_cols,
    )


def plot_factor_comparison(
    results: dict, dir_res: str, name: str = "factor_comparison.png"
) -> str:
    """Model-vs-linear-baseline PSNR/SSIM bars per interpolation factor.

    ``results``: {factor: {psnr, ssim, psnr_linear_baseline, ssim_linear_baseline}}
    — the inference_video report (⇔ error.py:345-505 bar charts, with the
    reference arrays at error.py:442-443 as the comparison protocol).
    """
    factors = sorted(int(f) for f in results)
    x = np.arange(len(factors))
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    for ax, metric, label in ((ax1, "psnr", "PSNR (dB)"), (ax2, "ssim", "SSIM")):
        model_v = [results[f][metric] for f in factors]
        base_v = [results[f][f"{metric}_linear_baseline"] for f in factors]
        ax.bar(x - 0.2, model_v, width=0.4, label="model")
        ax.bar(x + 0.2, base_v, width=0.4, label="linear baseline")
        ax.set_xticks(x)
        ax.set_xticklabels([f"{f}x" for f in factors])
        ax.set_ylabel(label)
        ax.legend(fontsize=8)
    fig.suptitle("Interpolation quality vs factor")
    return _save(fig, dir_res, name)


def visualize_3d(volume: np.ndarray, dir_res: str, title: str = "volume") -> str:
    """Volume rendering: plotly go.Volume HTML if available (utils.py:531-648),
    otherwise a 3-axis mid-slice matplotlib panel."""
    volume = np.squeeze(volume)
    try:
        import plotly.graph_objects as go  # optional dependency

        d, h, w = volume.shape
        zz, yy, xx = np.mgrid[0:d, 0:h, 0:w]
        fig = go.Figure(data=go.Volume(
            x=xx.ravel(), y=yy.ravel(), z=zz.ravel(), value=volume.ravel(),
            opacity=0.1, surface_count=15,
        ))
        os.makedirs(dir_res, exist_ok=True)
        path = os.path.join(dir_res, f"{title}.html")
        fig.write_html(path)
        return path
    except ImportError:
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        for ax, (axis, name) in zip(
            axes, [(0, "z-slice"), (1, "y-slice"), (2, "x-slice")]
        ):
            sl = [slice(None)] * 3
            sl[axis] = volume.shape[axis] // 2
            ax.imshow(volume[tuple(sl)], cmap="viridis")
            ax.set_title(name)
            ax.axis("off")
        fig.suptitle(title)
        return _save(fig, dir_res, f"{title}.png")
