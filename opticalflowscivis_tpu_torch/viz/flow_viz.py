"""Flow visualization — color encodings of 2-D flow fields.

Parity with the reference:
- ``flow2rgb``      ⇔ Flow-2D/train.py:55-64 / utils.py:19-27 (simple signed
  red/green/blue mix normalized by the max magnitude).
- ``flow_to_image`` ⇔ UPFlow/utils/tools.py:1384-1523 (Middlebury color wheel).
- ``flow_to_hsv``   ⇔ Flow-2D/inference_video.py:334-372 (angle→hue,
  magnitude→value HSV encoding via cv2).

A copy of the reference's ``viz/flow_viz.py``.  All functions take channels-last ``[H, W, 2]`` row-major (dy, dx) flow and
return ``[H, W, 3]`` float RGB in [0, 1].
"""

from __future__ import annotations

import numpy as np


def flow2rgb(flow: np.ndarray) -> np.ndarray:
    """train.py:55-64: rgb = 1 + (u, -(u+v)/2, v) / max|flow|."""
    flow = np.asarray(flow, np.float32)
    dy, dx = flow[..., 0], flow[..., 1]
    denom = max(float(np.abs(flow).max()), 1e-8)
    u, v = dx / denom, dy / denom
    rgb = np.ones(flow.shape[:-1] + (3,), np.float32)
    rgb[..., 0] += u
    rgb[..., 1] -= 0.5 * (u + v)
    rgb[..., 2] += v
    return rgb.clip(0, 1)


def _make_colorwheel() -> np.ndarray:
    """Middlebury color wheel (55 colors; tools.py:1384-1447 semantics)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3), np.float32)
    col = 0
    wheel[0:RY, 0] = 1.0
    wheel[0:RY, 1] = np.arange(RY) / RY
    col += RY
    wheel[col : col + YG, 0] = 1.0 - np.arange(YG) / YG
    wheel[col : col + YG, 1] = 1.0
    col += YG
    wheel[col : col + GC, 1] = 1.0
    wheel[col : col + GC, 2] = np.arange(GC) / GC
    col += GC
    wheel[col : col + CB, 1] = 1.0 - np.arange(CB) / CB
    wheel[col : col + CB, 2] = 1.0
    col += CB
    wheel[col : col + BM, 2] = 1.0
    wheel[col : col + BM, 0] = np.arange(BM) / BM
    col += BM
    wheel[col : col + MR, 2] = 1.0 - np.arange(MR) / MR
    wheel[col : col + MR, 0] = 1.0
    return wheel


_COLORWHEEL = _make_colorwheel()


def flow_to_image(flow: np.ndarray, max_flow: float | None = None) -> np.ndarray:
    """Middlebury/KITTI color encoding (tools.py:1449-1523 semantics)."""
    flow = np.asarray(flow, np.float32)
    dy, dx = flow[..., 0], flow[..., 1]
    rad = np.sqrt(dx**2 + dy**2)
    denom = max_flow if max_flow else max(float(rad.max()), 1e-8)
    u, v = dx / denom, dy / denom
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    ncols = _COLORWHEEL.shape[0]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int) % ncols
    k1 = (k0 + 1) % ncols
    f = fk - np.floor(fk)
    img = np.zeros(flow.shape[:-1] + (3,), np.float32)
    for c in range(3):
        col0 = _COLORWHEEL[k0, c]
        col1 = _COLORWHEEL[k1, c]
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])  # saturate toward white at 0
        col[~idx] = col[~idx] * 0.75
        img[..., c] = col
    return img.clip(0, 1)


def flow_to_hsv(flow: np.ndarray) -> np.ndarray:
    """HSV encoding: hue=angle, value=magnitude (inference_video.py:334-372)."""
    flow = np.asarray(flow, np.float32)
    dy, dx = flow[..., 0], flow[..., 1]
    mag = np.sqrt(dx**2 + dy**2)
    ang = (np.arctan2(dy, dx) + np.pi) / (2 * np.pi)
    val = mag / max(float(mag.max()), 1e-8)
    h, s, v = ang, np.ones_like(ang), val
    # vectorized hsv→rgb
    i = np.floor(h * 6.0).astype(int) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    choices = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    rgb = np.zeros(flow.shape[:-1] + (3,), np.float32)
    for idx, (r, g, b) in enumerate(choices):
        m = i == idx
        rgb[..., 0][m] = r[m]
        rgb[..., 1][m] = g[m]
        rgb[..., 2][m] = b[m]
    return rgb.clip(0, 1)
