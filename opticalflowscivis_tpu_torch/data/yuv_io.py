"""Raw YUV420 planar frame I/O — a numpy copy of the reference package's
``data/yuv_io.py`` (the port imports nothing of that package); a test pins it
to the original on fixed seeds, byte for byte in the written files.

The HD benchmark suites read uncompressed ``.yuv`` sequences (planar 4:2:0:
full-res Y plane followed by quarter-res U and V per frame,
``Flow-2D/benchmark/yuv_frame_io.py:40-70``) and convert to RGB with
skimage's BT.601-style matrices (:85-90).  Chroma is upsampled with
nearest-neighbour, matching the reference's ``imresize(..., interp='nearest')``
(:69-70).

No skimage/scipy dependency: the 3x3 color matrices are inlined (values equal
to ``skimage.color.rgb2yuv``/``yuv2rgb``).
"""

from __future__ import annotations

import numpy as np

# skimage.color.yuv_from_rgb (ITU-R BT.601 luma + full-swing U/V)
_YUV_FROM_RGB = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.14714119, -0.28886916, 0.43601035],
        [0.61497538, -0.51496512, -0.10001026],
    ],
    np.float64,
)
_RGB_FROM_YUV = np.linalg.inv(_YUV_FROM_RGB)


def rgb2yuv(rgb: np.ndarray) -> np.ndarray:
    """``skimage.color.rgb2yuv`` equivalent on float [0,1] HWC arrays."""
    return rgb.astype(np.float64) @ _YUV_FROM_RGB.T


def yuv2rgb(yuv: np.ndarray) -> np.ndarray:
    return yuv.astype(np.float64) @ _RGB_FROM_YUV.T


def _nearest_upsample2(p: np.ndarray, h: int, w: int) -> np.ndarray:
    """2x nearest-neighbour chroma upsample to exactly (h, w)."""
    up = np.repeat(np.repeat(p, 2, axis=0), 2, axis=1)
    return up[:h, :w]


class YUVReader:
    """Sequential/seekable yuv420 reader (yuv_frame_io.py:32-103).

    ``read(offset_frame)`` returns ``(frame, ok)`` where frame is uint8 RGB
    (``to_rgb=True``) or float YUV stacked HWC.
    """

    def __init__(self, filepath: str, h: int, w: int, to_rgb: bool = True):
        self.h, self.w = h, w
        self.fp = open(filepath, "rb")
        self.frame_length = h * w * 3 // 2
        self.y_length = h * w
        self.uv_length = h * w // 4
        self.to_rgb = to_rgb

    def read(self, offset_frame: int | None = None):
        if offset_frame is not None:
            self.fp.seek(offset_frame * self.frame_length, 0)
        y = np.fromfile(self.fp, np.uint8, count=self.y_length)
        u = np.fromfile(self.fp, np.uint8, count=self.uv_length)
        v = np.fromfile(self.fp, np.uint8, count=self.uv_length)
        if y.size < self.y_length or u.size < self.uv_length or v.size < self.uv_length:
            return None, False
        # reference reshapes order='F' on [w, h] then transposes == C-order [h, w]
        y = y.reshape(self.h, self.w)
        u = _nearest_upsample2(u.reshape(self.h // 2, self.w // 2), self.h, self.w)
        v = _nearest_upsample2(v.reshape(self.h // 2, self.w // 2), self.h, self.w)
        if self.to_rgb:
            yuv = np.stack(
                [y / 255.0, u / 255.0 - 0.5, v / 255.0 - 0.5], axis=-1)
            rgb = (255.0 * np.clip(yuv2rgb(yuv), 0.0, 1.0)).astype(np.uint8)
            return rgb, True
        return np.stack([y, u, v], axis=-1), True

    def close(self):
        self.fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class YUVWriter:
    """yuv420 writer (yuv_frame_io.py:106-181): RGB uint8 in, planar out.

    Chroma is decimated ``[::2, ::2]`` exactly as the reference (:144-145).
    """

    def __init__(self, filepath: str, from_rgb: bool = True):
        self.fp = open(filepath, "wb")
        self.from_rgb = from_rgb

    def write(self, frame: np.ndarray) -> bool:
        assert frame.shape[-1] == 3
        if self.from_rgb:
            yuv = rgb2yuv(frame.astype(np.float64) / 255.0)
            y = (255.0 * yuv[..., 0]).astype(np.uint8)
            u = (255.0 * np.clip(yuv[..., 1] + 0.5, 0, 1)[::2, ::2]).astype(np.uint8)
            v = (255.0 * np.clip(yuv[..., 2] + 0.5, 0, 1)[::2, ::2]).astype(np.uint8)
        else:
            y = frame[..., 0].astype(np.uint8)
            u = frame[::2, ::2, 1].astype(np.uint8)
            v = frame[::2, ::2, 2].astype(np.uint8)
        y.flatten().tofile(self.fp)
        u.flatten().tofile(self.fp)
        v.flatten().tofile(self.fp)
        return True

    def close(self):
        self.fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
