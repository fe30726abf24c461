"""Host-side data pipeline — numpy copy of the reference's ``data/pipeline.py``.

Channels-last arrays ``[T, *S, C]``: channel 0 is the scalar field and
channels 1..ndim the optional GT flow.

- ``minmax_normalize``: per-dataset min-max of the scalar channel.
- ``temporal_resample``: every N-th frame, the N phase shifts concatenated.
- ``flip_augment``: append copies mirrored along spatial axes, with the flow
  component along the flipped axis negated.
- ``group_tuples``: exp=1 (img0, img1, gt) from frames (t, t+2, t+1); exp=2
  5-tuples; exp=3 9-tuples.  Output ``[N, slots, *S, C]``.
- ``pad_to_multiple``: one static edge-pad of the spatial axes to /32.

- ``device_flip_augment``: the same flips per sample on a torch batch that
  already lies on the device.
- ``TupleDataset``: shuffled minibatches, or index batches for a dataset kept
  on the device, from one numpy shuffle stream.
- ``PrefetchSampler``: background threads that fill a queue of batches from
  any ``.sample(batch)`` dataset (the KITTI frame pairs decode per sample).
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch


def minmax_normalize(data: np.ndarray) -> np.ndarray:
    """Min-max normalize the scalar channel to [0, 1]; flow channels untouched."""
    data = np.asarray(data, np.float32)
    if not np.isfinite(data).all():  # NaN sanitization
        data = np.nan_to_num(data)
    data = data.copy()
    field = data[..., 0]
    lo, hi = field.min(), field.max()
    if hi > lo:
        np.subtract(field, lo, out=field)
        np.divide(field, hi - lo, out=field)
    return data


def temporal_resample(data: np.ndarray, stride: int = 3) -> np.ndarray:
    """Concatenate the ``stride`` phase-shifted every-N subsequences."""
    return np.concatenate([data[s::stride] for s in range(stride)], axis=0)


def flip_augment(
    data: np.ndarray, flow_channels: bool = True, n_axes: int | None = None
) -> np.ndarray:
    """Append copies mirrored along spatial axes (axes 1.. of [T,*S,C]).

    ``n_axes`` limits how many leading spatial axes are mirrored (two by
    default, in 2-D and 3-D alike).  With ``flow_channels`` the flow component
    along the flipped axis is negated (flow channel i ↔ spatial axis i).
    """
    ndim = data.ndim - 2
    if n_axes is None:
        n_axes = min(ndim, 2)
    has_flow = flow_channels and data.shape[-1] == 1 + ndim
    out = data
    for axis in range(n_axes):
        flipped = np.flip(out, axis=1 + axis).copy()
        if has_flow:
            flipped[..., 1 + axis] *= -1.0
        out = np.concatenate([out, flipped], axis=0)
    return out


def group_tuples(data: np.ndarray, exp: int = 1) -> np.ndarray:
    """Group frames into training tuples ``[N, slots, *S, C]``.

    exp=1 → slots (img0, img1, gt) from frame triples (t, t+2, t+1);
    exp=2 → (img0, img1, gt1, gt2, gt3) from 5-frame runs;
    exp=3 → (img0, img1, gt1..gt7) from 9-frame runs.
    """
    run = 2**exp + 1
    n = (data.shape[0] // run) * run
    if n == 0:
        raise ValueError(f"need at least {run} frames, got {data.shape[0]}")
    blocks = data[:n].reshape(data.shape[0] // run, run, *data.shape[1:])
    order = [0, run - 1] + list(range(1, run - 1))
    return blocks[:, order]


def pad_to_multiple(
    data: np.ndarray, multiple: int = 32, leading_axes: int = 1
) -> tuple[np.ndarray, tuple[tuple[int, int], ...]]:
    """Edge-pad the spatial axes up to a multiple; returns (padded, pads).

    ``leading_axes`` counts non-spatial leading axes (1 for ``[T, *S, C]``,
    2 for grouped tuples ``[N, slots, *S, C]``); the last axis is channels.
    """
    nd = data.ndim
    pads = [(0, 0)] * nd
    for axis in range(leading_axes, nd - 1):
        s = data.shape[axis]
        target = ((s + multiple - 1) // multiple) * multiple
        pads[axis] = (0, target - s)
    padded = np.pad(data, pads, mode="edge")
    return padded, tuple(pads)


def device_flip_augment(batch: torch.Tensor, code: torch.Tensor, ndim: int) -> torch.Tensor:
    """On-device twin of ``flip_augment`` for the device-resident dataset.

    ``batch [B, slots, *S, C]``, ``code [B]`` ∈ {0..3} indexes the host
    augmentation order [base, flip_ax0, flip_ax1, flip_both]: bit0 mirrors
    spatial axis 0 (negating flow channel 1), bit1 mirrors spatial axis 1
    (negating flow channel 2).  Keeping only the unaugmented tuples resident
    and flipping per sample cuts the resident bytes 4x.
    """
    flip0 = (code & 1).bool()
    flip1 = ((code >> 1) & 1).bool()
    per_sample = (-1,) + (1,) * (batch.dim() - 1)
    out = torch.where(flip0.view(per_sample), batch.flip(2), batch)  # spatial axis 0 = dim 2
    out = torch.where(flip1.view(per_sample), out.flip(3), out)
    channels = batch.shape[-1]
    if channels == 1 + ndim:
        sign = torch.ones((batch.shape[0], channels), dtype=batch.dtype, device=batch.device)
        sign[:, 1] = 1 - 2 * flip0.to(batch.dtype)
        sign[:, 2] = 1 - 2 * flip1.to(batch.dtype)
        out = out * sign.view((-1,) + (1,) * (batch.dim() - 2) + (channels,))
    return out


class TupleDataset:
    """Shuffled minibatch iterator over grouped tuples held in one numpy array.

    ``epoch`` yields the batches themselves (the streaming path uploads each),
    ``epoch_indices`` yields index batches from the same shuffle stream for a
    dataset that already lies on the device.
    """

    def __init__(self, tuples: np.ndarray, batch_size: int, seed: int = 0,
                 drop_last: bool = True):
        self.tuples = tuples
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = self.tuples.shape[0]
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, shuffle: bool = True):
        idx = np.arange(self.tuples.shape[0])
        if shuffle:
            self.rng.shuffle(idx)
        for i in range(len(self)):
            sel = idx[i * self.batch_size : (i + 1) * self.batch_size]
            yield self.tuples[sel]

    def epoch_indices(self, shuffle: bool = True, n_virtual: int | None = None):
        """Index batches (same shuffle stream as ``epoch``).  ``n_virtual``
        extends the index space beyond the stored tuples (4x for on-device
        flip augmentation: index // n selects the flip)."""
        n = n_virtual if n_virtual is not None else self.tuples.shape[0]
        idx = np.arange(n)
        if shuffle:
            self.rng.shuffle(idx)
        for i in range(n // self.batch_size):
            yield idx[i * self.batch_size : (i + 1) * self.batch_size]


class PrefetchSampler:
    """Background-thread batch prefetch over any ``.sample(batch)`` dataset.

    ``workers`` threads each loop ``dataset.sample(batch_size)`` into a
    bounded queue (cv2 and numpy release the GIL for the heavy parts), so that
    the train loop's ``sample`` is a queue pop, as UPFlow's DataLoader workers
    hide per-sample decoding behind the train step.  ``KittiPairDataset.sample``
    draws from one numpy Generator per dataset, so with ``workers > 1`` pass
    ``make_dataset``, which builds one independently seeded dataset for each
    worker.
    """

    def __init__(self, dataset=None, batch_size: int = 8, depth: int = 4,
                 workers: int = 2, make_dataset=None):
        self.batch_size = batch_size
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._threads = []
        for w in range(workers):
            ds = make_dataset(w) if make_dataset is not None else dataset
            if workers > 1 and make_dataset is None:
                raise ValueError("workers > 1 needs make_dataset (per-worker RNG)")
            t = threading.Thread(target=self._loop, args=(ds,), daemon=True)
            t.start()
            self._threads.append(t)

    def _loop(self, ds):
        while not self._stop.is_set():
            batch = ds.sample(self.batch_size)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def sample(self, batch_size: int):
        if batch_size > self.batch_size:
            raise ValueError(
                f"prefetch built for batch {self.batch_size}, asked {batch_size}")
        batch = self._q.get()
        if batch_size == self.batch_size:
            return batch
        return {k: v[:batch_size] for k, v in batch.items()}

    def close(self):
        self._stop.set()
        # drain so producers blocked on put() can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
