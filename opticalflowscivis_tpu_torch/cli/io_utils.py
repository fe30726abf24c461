"""Image / video IO helpers for the CLI (cv2-backed; ``.npy`` needs no cv2)."""

from __future__ import annotations

import os

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Load png / jpg / npy as ``[H, W, 1]`` float32 in [0, 1] (grayscale)."""
    if path.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return (img.astype(np.float32) / 255.0)[..., None]


def save_image(img: np.ndarray, path: str) -> None:
    import cv2

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.clip(np.squeeze(img) * 255.0, 0, 255).astype(np.uint8)
    cv2.imwrite(path, arr)


def write_video(frames: np.ndarray, path: str, fps: int = 10) -> None:
    """Write ``[T, H, W]`` floats in [0, 1] as a grayscale mp4."""
    import cv2

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    t, h, w = frames.shape[:3]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h), False)
    for i in range(t):
        out.write(np.clip(frames[i] * 255.0, 0, 255).astype(np.uint8))
    out.release()


def read_video(path: str) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY).astype(np.float32) / 255.0)
    cap.release()
    return np.stack(frames) if frames else np.empty((0,))
