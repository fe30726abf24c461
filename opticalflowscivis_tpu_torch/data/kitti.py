"""KITTI optical-flow data — a copy of the reference's ``data/kitti.py``, plus
the on-device batch of the frame store.

- ``read_flo`` / ``write_flo``: Middlebury .flo (magic 202021.25,
  little-endian W, H, interleaved u, v float32).
- ``read_kitti_flow_png`` / ``write_kitti_flow_png``: KITTI's uint16 PNG
  encoding ((value - 2^15) / 64 with a validity channel, in cv2's BGR order).
- ``KittiPairDataset``: multiview frame pairs, random crops with a margin
  ``rho`` = 8 and the crop offset ``start`` for boundary-dilated warping,
  horizontal-flip and image-swap augmentation.
- ``load_kitti_eval_pairs``: the Evaluation_bench samples, image pairs with
  their ground-truth flow (occ and noc) and validity masks; the metrics are
  ``evalsuite.flow_eval``'s.
- ``KittiHBMCache``: the frames decoded once into one array that training
  keeps on the GPU; ``KittiHBMCache.draw`` draws a batch's pair indices,
  crop offsets and augmentation bits on the host, and ``device_batch`` cuts
  that batch out of the store on the device.

Flow leaves this module channels-last ``[H, W, 2]`` in row-major (dy, dx),
converted from KITTI's (u = x, v = y) storage.  cv2 is imported inside the
functions that read or write PNGs, so that the rest works without it.
"""

from __future__ import annotations

import glob
import os
from typing import Sequence

import numpy as np
import torch

_FLO_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)[0]
        if abs(magic - _FLO_MAGIC) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        data = np.fromfile(f, np.float32, 2 * w * h).reshape(h, w, 2)
    return data[..., ::-1].copy()  # (u, v) → (dy, dx)


def write_flo(flow: np.ndarray, path: str) -> None:
    h, w = flow.shape[:2]
    uv = flow[..., ::-1].astype(np.float32)  # (dy, dx) → (u, v)
    with open(path, "wb") as f:
        np.asarray([_FLO_MAGIC], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        uv.tofile(f)


def read_kitti_flow_png(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (flow [H,W,2] (dy,dx), valid [H,W,1]) from a KITTI uint16 png."""
    import cv2

    raw = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    if raw is None:
        raise FileNotFoundError(path)
    raw = raw.astype(np.float64)
    # cv2 loads BGR: B=valid, G=v, R=u
    valid = raw[..., 0:1] > 0
    v = (raw[..., 1] - 2**15) / 64.0
    u = (raw[..., 2] - 2**15) / 64.0
    flow = np.stack([v, u], axis=-1).astype(np.float32)
    return flow * valid, valid.astype(np.float32)


def write_kitti_flow_png(flow: np.ndarray, valid: np.ndarray | None, path: str) -> None:
    import cv2

    h, w = flow.shape[:2]
    if valid is None:
        valid = np.ones((h, w, 1), np.float32)
    v = np.clip(flow[..., 0] * 64.0 + 2**15, 0, 65535)
    u = np.clip(flow[..., 1] * 64.0 + 2**15, 0, 65535)
    img = np.stack([valid[..., 0], v, u], axis=-1).astype(np.uint16)  # BGR
    cv2.imwrite(path, img)


def _read_gray(path: str) -> np.ndarray:
    """An image file as float32 RGB in [0, 1] (the name is the reference's)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img[..., ::-1].astype(np.float32) / 255.0  # BGR→RGB


# BGR channel means of UPFlow's input normalisation, reversed to RGB; its
# stddev is 1/0.0039216 = 255, i.e. the normalized image is
# (pixel255 - mean)/255 = pixel01 - mean/255.
_KITTI_MEAN_RGB01 = np.asarray([114.785955, 110.1753, 104.920005], np.float32) / 255.0


def kitti_photometric_normalize(img01: np.ndarray) -> np.ndarray:
    """UPFlow's input normalisation: subtract the fixed per-channel mean (the
    UnFlow convention) from a [0,1] RGB image."""
    return img01 - _KITTI_MEAN_RGB01


class KittiPairDataset:
    """Multiview frame-pair sampler with offset-returning random crops.

    Random crops with margin ``rho``, horizontal-flip and image-swap
    augmentation, and UPFlow's photometric input normalisation.  ``sample``
    returns a dict batch for ``UPFlowTrainer``:

    - ``im1``/``im2`` [B, ch, cw, 3] — the training crops;
    - ``im1_raw``/``im2_raw`` [B, ch+2*rho, cw+2*rho, 3] — the rho-dilated
      windows around each crop, with ``start`` [B, 2] = (rho, rho), consumed
      by boundary-dilated warping.  A fixed dilated window (instead of the
      whole uncropped image) keeps the shapes static and covers flows up to
      rho px beyond the crop boundary; beyond that the warp clamps at the
      window's border.
    """

    def __init__(
        self,
        image_dir: str,
        crop: tuple[int, int] = (256, 832),
        rho: int = 8,
        seed: int = 0,
        normalize: bool = True,
    ):
        self.files = sorted(glob.glob(os.path.join(image_dir, "*.png")))
        # consecutive multiview frames of the same sequence form pairs
        by_seq: dict[str, list[str]] = {}
        for f in self.files:
            seq = os.path.basename(f).rsplit("_", 1)[0]
            by_seq.setdefault(seq, []).append(f)
        self.pairs = []
        for seq, frames in by_seq.items():
            frames.sort()
            self.pairs.extend(list(zip(frames[:-1], frames[1:])))
        self.crop = crop
        self.rho = rho
        self.normalize = normalize
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.pairs)

    def sample(self, batch_size: int) -> dict[str, np.ndarray]:
        """Random augmented batch dict (see class docstring)."""
        ch, cw = self.crop
        rho = self.rho
        out: dict[str, list] = {k: [] for k in ("im1", "im2", "im1_raw", "im2_raw")}
        for _ in range(batch_size):
            a, b = self.pairs[int(self.rng.integers(len(self.pairs)))]
            i1, i2 = _read_gray(a), _read_gray(b)
            if self.normalize:
                i1 = kitti_photometric_normalize(i1)
                i2 = kitti_photometric_normalize(i2)
            h, w = i1.shape[:2]
            # crop offset ∈ [rho, dim - crop - rho] so the dilated window fits
            y0 = int(self.rng.integers(rho, max(h - ch - rho, rho) + 1))
            x0 = int(self.rng.integers(rho, max(w - cw - rho, rho) + 1))
            c1 = i1[y0 : y0 + ch, x0 : x0 + cw]
            c2 = i2[y0 : y0 + ch, x0 : x0 + cw]
            r1 = i1[y0 - rho : y0 + ch + rho, x0 - rho : x0 + cw + rho]
            r2 = i2[y0 - rho : y0 + ch + rho, x0 - rho : x0 + cw + rho]
            if self.rng.random() < 0.5:  # horizontal flip
                c1, c2 = c1[:, ::-1], c2[:, ::-1]
                r1, r2 = r1[:, ::-1], r2[:, ::-1]
            if self.rng.random() < 0.5:  # temporal swap
                c1, c2 = c2, c1
                r1, r2 = r2, r1
            for k, v in zip(("im1", "im2", "im1_raw", "im2_raw"), (c1, c2, r1, r2)):
                out[k].append(v)
        batch = {k: np.stack(v).astype(np.float32) for k, v in out.items()}
        batch["start"] = np.full((batch_size, 2), float(rho), np.float32)
        return batch


def load_kitti_eval_pairs(root: str, split: str = "training", year: int = 2015):
    """Yield (sid, im1, im2, flow_occ, mask_occ, flow_noc, mask_noc) eval samples.

    Directory layout: KITTI-2015 ``{root}/{split}/image_2/{id}_1{0,1}.png`` +
    ``flow_occ/ flow_noc/``.
    """
    img_dir = os.path.join(root, split, "image_2")
    occ_dir = os.path.join(root, split, "flow_occ")
    noc_dir = os.path.join(root, split, "flow_noc")
    ids = sorted(
        os.path.basename(f)[:-7]
        for f in glob.glob(os.path.join(img_dir, "*_10.png"))
    )
    for sid in ids:
        im1 = _read_gray(os.path.join(img_dir, f"{sid}_10.png"))
        im2 = _read_gray(os.path.join(img_dir, f"{sid}_11.png"))
        f_occ, m_occ = read_kitti_flow_png(os.path.join(occ_dir, f"{sid}_10.png"))
        f_noc, m_noc = read_kitti_flow_png(os.path.join(noc_dir, f"{sid}_10.png"))
        yield sid, im1, im2, f_occ, m_occ, f_noc, m_noc


class KittiHBMCache:
    """Multiview frames decoded once into one array that stays on the GPU.

    The streamed ``KittiPairDataset`` reads, normalizes and crops two PNGs per
    sample on the host and sends each batch to the device.  This cache holds
    the frames of up to ``max_pairs`` pairs (a random subset, from ``seed``)
    in one ``frames [F, H, W, 3]`` array; ``UPFlowTrainer.fit_kitti_hbm``
    uploads it once, and per step only pair indices, crop offsets and
    augmentation bits cross to the card, where ``device_batch`` cuts the
    crops, the rho-dilated raw windows, the flips and the swaps.  Frames are
    cut to the smallest (H, W) among them, so that one shape serves every
    sequence.  ``pair_idx [P, 2]`` indexes ``frames``.

    The constructor reads and normalizes the files; ``from_frames`` builds
    the cache from frames already in memory.
    """

    def __init__(self, image_dir: str, max_pairs: int | None = 1000,
                 crop: tuple[int, int] = (256, 832), rho: int = 8,
                 normalize: bool = True, seed: int = 0):
        base = KittiPairDataset(image_dir, crop=crop, rho=rho, seed=seed,
                                normalize=normalize)
        pairs = base.pairs
        if max_pairs is not None and len(pairs) > max_pairs:
            rng = np.random.default_rng(seed)
            keep = rng.choice(len(pairs), size=max_pairs, replace=False)
            pairs = [pairs[i] for i in sorted(keep)]
        files = sorted({f for pr in pairs for f in pr})
        index = {f: i for i, f in enumerate(files)}
        imgs = []
        for f in files:
            img = _read_gray(f)
            imgs.append(kitti_photometric_normalize(img) if normalize else img)
        self._build(imgs, [(index[a], index[b]) for a, b in pairs], crop, rho)

    @classmethod
    def from_frames(cls, frames: Sequence[np.ndarray], pairs: Sequence[tuple[int, int]],
                    crop: tuple[int, int] = (256, 832), rho: int = 8) -> "KittiHBMCache":
        """The cache of ``pairs`` (index pairs into ``frames``, a sequence of
        ``[H, W, 3]`` images, normalized as training wants them): only the
        frames a pair refers to are kept, in index order, cut to their
        smallest (H, W)."""
        cache = cls.__new__(cls)
        cache._build(frames, pairs, crop, rho)
        return cache

    def _build(self, frames, pairs, crop, rho) -> None:
        used = sorted({int(i) for pr in pairs for i in pr})
        index = {i: k for k, i in enumerate(used)}
        hmin = min(frames[i].shape[0] for i in used)
        wmin = min(frames[i].shape[1] for i in used)
        self.frames = np.stack([frames[i][:hmin, :wmin] for i in used])
        self.pair_idx = np.asarray([(index[int(a)], index[int(b)]) for a, b in pairs],
                                   np.int32)
        self.crop = tuple(crop)
        self.rho = rho

    def __len__(self) -> int:
        return len(self.pair_idx)

    def draw(self, rng: np.random.Generator, batch: int):
        """One batch's ``(pid [B, 2], offs [B, 2], flip [B], swap [B])``: pair
        indices into ``frames``, crop offsets (y, x) in ``[rho, dim - crop -
        rho]``, and the flip and swap bits, drawn in that order (the y offsets
        of the batch before its x offsets)."""
        ch, cw = self.crop
        rho = self.rho
        fh, fw = self.frames.shape[1:3]
        pid = self.pair_idx[rng.integers(len(self.pair_idx), size=batch)]
        offs = np.stack([
            rng.integers(rho, max(fh - ch - rho, rho) + 1, size=batch),
            rng.integers(rho, max(fw - cw - rho, rho) + 1, size=batch),
        ], axis=1).astype(np.int32)
        flip = rng.random(batch) < 0.5
        swap = rng.random(batch) < 0.5
        return pid, offs, flip, swap


def device_batch(store: torch.Tensor, pid: torch.Tensor, offs: torch.Tensor,
                 flip: torch.Tensor, swap: torch.Tensor, crop: tuple[int, int],
                 rho: int) -> dict[str, torch.Tensor]:
    """The training batch of ``KittiHBMCache.draw``'s indices, cut out of the
    frame store ``store [F, H, W, 3]`` where it lies, as float32.

    ``pid [B, 2]``, ``offs [B, 2]`` (y, x), ``flip [B]`` and ``swap [B]`` lie
    on the store's device.  Each raw window is the ``(ch + 2 rho) x (cw + 2
    rho)`` block around its crop, gathered in one indexing op whose element
    offsets torch computes in 64 bits (the store may pass 2^31 elements);
    columns run backwards where ``flip`` is set, so that the crop is the
    window's interior either way.  ``swap`` exchanges the two frames.
    Returns ``im1``, ``im2``, ``im1_raw``, ``im2_raw`` and ``start`` [B, 2] =
    (rho, rho), as ``KittiPairDataset.sample`` does.
    """
    ch, cw = crop
    fh, fw = store.shape[1:3]
    if fh < ch + 2 * rho or fw < cw + 2 * rho:
        raise ValueError(f"frames {fh}x{fw} are smaller than the crop {ch}x{cw} "
                         f"with its margin of {rho}")
    dev = store.device
    pid, offs = pid.to(dev, torch.int64), offs.to(dev, torch.int64)
    flip, swap = flip.to(dev, torch.bool), swap.to(dev, torch.bool)
    rows = offs[:, :1] - rho + torch.arange(ch + 2 * rho, device=dev)  # [B, RH]
    cols = offs[:, 1:] - rho + torch.arange(cw + 2 * rho, device=dev)  # [B, RW]
    cols = torch.where(flip[:, None], cols.flip(-1), cols)
    first = torch.where(swap, pid[:, 1], pid[:, 0])
    second = torch.where(swap, pid[:, 0], pid[:, 1])
    out = {}
    for name, frame in (("im1", first), ("im2", second)):
        raw = store[frame[:, None, None], rows[:, :, None], cols[:, None, :]].float()
        out[f"{name}_raw"] = raw
        out[name] = raw[:, rho : rho + ch, rho : rho + cw].contiguous()
    out["start"] = torch.full((pid.shape[0], 2), float(rho), device=dev)
    return out
