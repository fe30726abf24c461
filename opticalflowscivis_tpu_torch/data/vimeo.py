"""Vimeo90K triplets: grayscale RIFE training data streamed from the host.

A numpy copy of the reference package's ``data/vimeo.py`` (the port imports
nothing of that package); a test pins it to the original at a fixed seed.
Parity with ``Flow-2D/dataset.py`` (VimeoDataset): the triplet list files
(``tri_trainlist.txt`` / ``tri_testlist.txt``), per-triplet im1/im2/im3
PNGs read as grayscale, random crops, vertical and horizontal flips,
frame-order reversal and 90-degree rotations, drawn from one generator in
the reference's order.

Batches are grouped tuples ``[B, 3 (img0, img1, gt), H, W, 1]``, so
``training.Trainer.fit_stream`` takes them unchanged.
"""

from __future__ import annotations

import os

import numpy as np


class VimeoDataset:
    def __init__(
        self,
        root: str,
        split: str = "train",
        crop: tuple[int, int] = (224, 224),
        seed: int = 0,
    ):
        self.root = root
        list_file = os.path.join(
            root, "tri_trainlist.txt" if split == "train" else "tri_testlist.txt"
        )
        with open(list_file) as f:
            self.triplets = [line.strip() for line in f if line.strip()]
        self.split = split
        self.crop = crop
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.triplets)

    def _load(self, idx: int) -> np.ndarray:
        import cv2

        d = os.path.join(self.root, "sequences", self.triplets[idx])
        frames = [
            cv2.imread(os.path.join(d, f"im{i}.png"), cv2.IMREAD_GRAYSCALE)
            for i in (1, 2, 3)
        ]
        return np.stack(frames).astype(np.float32) / 255.0  # [3, H, W]

    def sample(self, batch_size: int) -> np.ndarray:
        """Augmented batch ``[B, 3, ch, cw, 1]`` with slots (img0, img1, gt);
        the test split returns whole frames, unaugmented."""
        ch, cw = self.crop
        out = []
        for _ in range(batch_size):
            tri = self._load(int(self.rng.integers(len(self.triplets))))
            h, w = tri.shape[1:]
            if self.split == "train":
                y0 = int(self.rng.integers(0, h - ch + 1))
                x0 = int(self.rng.integers(0, w - cw + 1))
                tri = tri[:, y0 : y0 + ch, x0 : x0 + cw]
                if self.rng.random() < 0.5:
                    tri = tri[:, ::-1]
                if self.rng.random() < 0.5:
                    tri = tri[:, :, ::-1]
                if self.rng.random() < 0.5:
                    tri = tri[::-1]  # reverse the frame order
                k = int(self.rng.integers(4))
                if k:
                    tri = np.rot90(tri, k, axes=(1, 2)).copy()
            # slots (img0, img1, gt) = (im1, im3, im2)
            out.append(np.stack([tri[0], tri[2], tri[1]])[..., None])
        return np.asarray(out, np.float32)
