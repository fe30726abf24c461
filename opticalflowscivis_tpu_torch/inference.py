"""Inference engine — pair/series interpolation with recursive bisection.

Counterpart of ``opticalflowscivis_tpu/inference.py``:

- ``Interpolator.pair``: student-only IFNet forward on ``[B, H, W, C]``
  numpy frames or ``[B, Z, Y, X, C]`` volumes, edge-padded to a multiple of 32
  on every spatial axis and cropped back, with optional flip test-time
  augmentation (TTA).
- ``interpolate_recursive`` / ``interpolate_ratio``: midpoint bisection.
- ``interpolate_series``: decimate a series by ``factor`` and reconstruct the
  missing frames; power-of-two factors without SSIM gates take the
  device-resident path (``interpolate_series_device``).
- ``batched_pair_inference``: ``pair`` over grouped test tuples.
- ``ZooInterpolator`` / ``load_pretrained_zoo``: the pretrained RIFE zoo
  models (HDv3, HD v1 and v2; ``models/ifnet_hd*.py``) behind the same
  ``pair``, from a checkpoint directory of upstream ``.pkl`` state dicts.

Arrays in and out are channels-last numpy; the model runs on the
interpolator's device under ``torch.inference_mode()``.
"""

from __future__ import annotations

import contextlib
import math
import mmap
import os
import queue
from collections import deque
from concurrent import futures
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from opticalflowscivis_tpu_torch.device import resolve_device
from opticalflowscivis_tpu_torch.models.ifnet import IFNet
from opticalflowscivis_tpu_torch.ops.resize import resize_flow_nchw
from opticalflowscivis_tpu_torch.ops.ssim import ssim
from opticalflowscivis_tpu_torch.utils.profiling import span


def _spatial_dims(x: torch.Tensor) -> tuple[int, ...]:
    """The spatial dims of a channels-first tensor ``[B, C, *S]``."""
    return tuple(range(2, x.dim()))


class _PaddedFrames:
    """Edge padding to ``pad_multiple`` and the numpy <-> device conversions
    of the interpolators (``pad_multiple`` and ``device`` set by each)."""

    pad_multiple: int
    device: torch.device

    def _pad(self, x: np.ndarray):
        m = self.pad_multiple
        pads = [(0, 0)] + [(0, (-s) % m) for s in x.shape[1:-1]] + [(0, 0)]
        return np.pad(x, pads, mode="edge"), x.shape

    def _to_tensor(self, x: np.ndarray) -> torch.Tensor:
        """``[N, *S, C]`` numpy → contiguous channels-first float32 on the device."""
        t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)
        return t.movedim(-1, 1).contiguous()

    @staticmethod
    def _to_numpy(t: torch.Tensor) -> np.ndarray:
        return t.float().movedim(1, -1).cpu().numpy()

    @staticmethod
    def _crop(orig_shape) -> tuple[slice, ...]:
        """Index that cuts a padded ``[N, *S, C]`` array back to ``orig_shape``'s
        spatial size."""
        return (slice(None),) + tuple(slice(0, s) for s in orig_shape[1:-1])


def _boxes(lo: int, hi: int, shape: tuple[int, ...]):
    """The flat range ``[lo, hi)`` of a C-contiguous array of ``shape`` as
    boxes in flat order: ``(index, size)``, the index some leading integers
    and one slice (the axes after it whole)."""
    inner = math.prod(shape[1:])
    i0, r0 = divmod(lo, inner)
    i1, r1 = divmod(hi, inner)
    if i0 == i1:
        for index, size in _boxes(r0, r1, shape[1:]) if r1 > r0 else ():
            yield (i0,) + index, size
        return
    if r0:
        for index, size in _boxes(r0, inner, shape[1:]):
            yield (i0,) + index, size
        i0 += 1
    if i1 > i0:
        yield (slice(i0, i1),), (i1 - i0) * inner
    if r1:
        for index, size in _boxes(0, r1, shape[1:]):
            yield (i1,) + index, size


# the series job's staging ring: 4 slots of 32 MiB, pinned once a process
STAGE_SLOT_BYTES = 32 << 20
STAGE_SLOTS = 4


def _inference(fn, *args):
    """``fn(*args)`` under ``torch.inference_mode()``: the destinations of
    the copy-outs are views made in it."""
    with torch.inference_mode():
        return fn(*args)


class _Download:
    """A device tensor ``[k, *R]`` queued for its host destination ``dst``
    (``[k, *R']``, ``R' <= R``: the rows cropped)."""

    def __init__(self, rows: torch.Tensor, dst: torch.Tensor, ready):
        self.shape = tuple(rows.shape)
        self.flat = rows.reshape(rows.shape[0], -1)  # [k, L]: a view where each row is contiguous
        self.dst = dst
        self.ready = ready  # the event the copies wait on (None on the CPU)


class _StagingRing:
    """The series job's host staging: ``slots`` slots of ``slot_bytes``
    bytes, reused across calls.

    ``download`` queues a device tensor, chunk by chunk (a slot each), and
    copies each chunk into a free slot; the chunk is then copied out into
    the host destination (torch's CPU ``copy_``, on the intra-op threads),
    which frees its slot for the next.  ``drain`` moves what is left and
    waits until every chunk has landed.  ``upload`` moves a host array the
    other way through the same slots, non-blocking on the current stream.

    On a CUDA device the slots are pinned, and the copies into them run on
    a copy stream of the ring's own, behind an event of the stream that
    queued the tensor: the caller enqueues them (so that every copy between
    host and device is in its ``ofs.series.download`` span) and goes on to
    enqueue the next stage, while a thread of the ring's own waits for each
    chunk, copies it out and frees its slot.  The thread also faults in the
    pages of the fresh destinations ahead of their copy-outs (``reserve``):
    a page's first touch costs more than copying it.  On the CPU the slots
    are plain memory and every copy is synchronous, through the same chunks.

    The copy stream reads only tensors that the caller holds until ``drain``
    has returned, so the caching allocator cannot hand their memory on while
    a chunk is in flight.  The allocation opens the span ``ofs.series.stage``:
    once a process, in the warm-up.  At the default 4 slots of 32 MiB a
    ``rife2d_interp_droplet`` call (513 frames at x8, 160x224, bf16 flows)
    moves 1 chunk up, and 1 + 1 + 2 frame chunks and 1 flow chunk down.
    """

    def __init__(self, device: torch.device, slot_bytes: int, slots: int):
        if slot_bytes % 8 or slot_bytes <= 0 or slots <= 0:
            raise ValueError(f"need slots of a positive multiple of 8 bytes, got "
                             f"{slots} of {slot_bytes}")
        self.device = device
        cuda = device.type == "cuda"
        with span("ofs.series.stage"):
            self.slots = torch.empty((slots, slot_bytes), dtype=torch.uint8, pin_memory=cuda)
        self.stream = torch.cuda.Stream(device) if cuda else None
        self.events = [torch.cuda.Event() if cuda else None for _ in range(slots)]
        self.worker = ThreadPoolExecutor(1, "ofs-staging") if cuda else None
        self.pending: list[Future] = []
        self.reset()

    def reset(self) -> None:
        """All slots free: wait out what a call that raised left running."""
        futures.wait(self.pending)
        self.pending = []
        self.queued: deque[tuple[_Download, int, int]] = deque()  # job, lo, hi
        self.free: queue.SimpleQueue[int] = queue.SimpleQueue()
        for s in range(len(self.events)):
            self.free.put(s)

    def _later(self, fn, *args) -> None:
        """``fn(*args)`` on the ring's thread after what it has, or now."""
        if self.worker is None:
            fn(*args)
        else:
            self.pending.append(self.worker.submit(_inference, fn, *args))

    def upload(self, host: np.ndarray) -> torch.Tensor:
        """``host`` (C-contiguous) as a tensor on the device."""
        src = torch.from_numpy(host).view(-1)
        out = torch.empty(host.shape, dtype=src.dtype, device=self.device)
        flat = out.view(-1)
        n = self.slots.shape[1] // src.element_size()
        for i, lo in enumerate(range(0, src.numel(), n)):
            s = i % len(self.events)
            hi = min(lo + n, src.numel())
            if self.events[s] is not None:
                self.events[s].synchronize()  # the slot's last copy has read it
            buf = self.slots[s].view(src.dtype)[:hi - lo]
            buf.copy_(src[lo:hi])
            flat[lo:hi].copy_(buf, non_blocking=True)
            if self.events[s] is not None:
                self.events[s].record(torch.cuda.current_stream(self.device))
        return out

    def reserve(self, a: np.ndarray) -> None:
        """Fault in the pages of a fresh host array on the ring's thread,
        ahead of the copy-outs into it (on the CPU, nothing)."""
        if self.worker is not None:
            flat = torch.from_numpy(a).view(-1)
            self._later(flat[::mmap.PAGESIZE // a.itemsize].zero_)
            self._later(flat[-1:].zero_)

    def host_copy(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """``dst.copy_(src)`` of host tensors, after the queued copy-outs."""
        self._later(dst.copy_, src)

    def download(self, rows: torch.Tensor, dst: torch.Tensor) -> None:
        """Queue ``rows`` (``[k, *R]``) for ``dst`` (``[k, *R']`` on the host,
        ``R' <= R``: ``rows`` cropped); it lands by the next ``drain``."""
        with span("ofs.series.download"):
            # the rows' own memory order (a channels-last flow is [k, *S, C]),
            # so that each row reads as one contiguous run
            order = [0] + sorted(range(1, rows.dim()), key=lambda d: -rows.stride(d))
            rows, dst = rows.permute(order), dst.permute(order)
            ready = None
            if self.stream is not None:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
            job = _Download(rows, dst, ready)
            k, length = job.flat.shape
            step = self.slots.shape[1] // job.flat.element_size()
            self.queued.extend((job, lo, min(lo + step, k * length))
                               for lo in range(0, k * length, step))
            self._pump(wait=False)

    def drain(self) -> None:
        """Move what is queued and wait until all of it has landed."""
        with span("ofs.series.download"):
            self._pump(wait=True)
            pending, self.pending = self.pending, []
            for f in pending:
                f.result()

    def _pump(self, wait: bool) -> None:
        """Copy queued chunks into free slots; with ``wait``, each as soon as
        a slot frees, until none is left."""
        while self.queued:
            try:
                s = self.free.get(block=wait)
            except queue.Empty:
                return
            job, lo, hi = self.queued.popleft()
            k, length = job.flat.shape
            buf = self.slots[s].view(job.flat.dtype)
            with (torch.cuda.stream(self.stream) if self.stream is not None
                  else contextlib.nullcontext()):
                if job.ready is not None and lo == 0:
                    self.stream.wait_event(job.ready)
                if job.flat.is_contiguous():
                    buf[:hi - lo].copy_(job.flat.view(-1)[lo:hi], non_blocking=True)
                else:  # rows apart on the device: a copy a row
                    for r in range(lo // length, (hi - 1) // length + 1):
                        a, b = max(lo, r * length), min(hi, (r + 1) * length)
                        buf[a - lo:b - lo].copy_(job.flat[r, a - r * length:b - r * length],
                                                 non_blocking=True)
                if self.events[s] is not None:
                    self.events[s].record(self.stream)
            self._later(self._copy_out, job, s, lo, hi)

    def _copy_out(self, job: _Download, s: int, lo: int, hi: int) -> None:
        """Elements ``[lo, hi)`` of ``job``'s tensor, landed in slot ``s``,
        into their place in its destination (the padding left out); then the
        slot is free."""
        try:
            if self.events[s] is not None:
                self.events[s].synchronize()
            buf, dst, at = self.slots[s].view(job.flat.dtype), job.dst, 0
            for index, size in _boxes(lo, hi, job.shape):
                head, cut = index[:-1], index[-1]
                src = buf[at:at + size].view((cut.stop - cut.start,) + job.shape[len(index):])
                at += size
                stop = min(cut.stop, dst.shape[len(head)])
                if stop <= cut.start or any(i >= c for i, c in zip(head, dst.shape)):
                    continue  # padding alone
                src = src[(slice(0, stop - cut.start),)
                          + tuple(slice(0, c) for c in dst.shape[len(index):])]
                dst[head + (slice(cut.start, stop),)].copy_(src)
        finally:
            self.free.put(s)


class Interpolator(_PaddedFrames):
    """Student-only IFNet forward with automatic /``pad_multiple`` padding.

    Runs on ``device`` (``cuda`` unless ``device="cpu"``); the model is moved
    there.
    """

    def __init__(self, model: IFNet, pad_multiple: int = 32, tta: bool = False,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.pad_multiple = pad_multiple
        self.tta = tta
        self._ring: _StagingRing | None = None

    def staging(self) -> _StagingRing:
        """The series job's staging ring on the current device: allocated at
        the first call, and again only when ``device`` changes."""
        if self._ring is None or self._ring.device != self.device:
            self._ring = _StagingRing(self.device, STAGE_SLOT_BYTES, STAGE_SLOTS)
        self._ring.reset()
        return self._ring

    def _forward_plain(self, img0: torch.Tensor, img1: torch.Tensor, timestep):
        out = self.model(img0, img1, None, timestep=timestep)
        return out["merged"][-1], out["flow_list"][-1], out["mask_list"][-1]

    def forward(self, img0: torch.Tensor, img1: torch.Tensor, timestep=0.5):
        """Channels-first device tensors → (merged, flow, mask), channels-first.

        With TTA a second pass runs on inputs mirrored along every spatial axis
        at the same timestep, and the un-mirrored merged frames are averaged;
        flow and mask stay from the primary pass.
        """
        with span("ofs.interpolate"), torch.inference_mode():
            merged, flow, mask = self._forward_plain(img0, img1, timestep)
            if self.tta:
                spatial = _spatial_dims(img0)
                m2, _, _ = self._forward_plain(img0.flip(spatial), img1.flip(spatial), timestep)
                merged = (merged + m2.flip(spatial)) / 2
        return merged, flow, mask

    def pair(self, img0: np.ndarray, img1: np.ndarray, timestep: float = 0.5):
        """Predict the frame at ``timestep`` between two ``[B, *S, C]`` frames.

        Returns numpy (merged ``[B, *S, C]``, flow ``[B, *S, 2 * ndim]``, mask
        ``[B, *S, 1]``).
        """
        p0, orig_shape = self._pad(np.asarray(img0, np.float32))
        p1, _ = self._pad(np.asarray(img1, np.float32))
        merged, flow, mask = self.forward(self._to_tensor(p0), self._to_tensor(p1), timestep)
        crop = self._crop(orig_shape)
        return self._to_numpy(merged)[crop], self._to_numpy(flow)[crop], self._to_numpy(mask)[crop]


def interpolate_recursive(
    interp: Interpolator, img0: np.ndarray, img1: np.ndarray, n: int
) -> list[np.ndarray]:
    """Insert ``n`` (= 2^k - 1) frames between img0/img1 by midpoint bisection."""
    if n <= 0:
        return []
    middle, _, _ = interp.pair(img0, img1)
    if n == 1:
        return [middle]
    left = interpolate_recursive(interp, img0, middle, n // 2)
    right = interpolate_recursive(interp, middle, img1, n // 2)
    # the exact midpoint is kept only for odd n (make_inference semantics)
    return left + [middle] + right if n % 2 else left + right


def interpolate_ratio(
    interp: Interpolator,
    img0: np.ndarray,
    img1: np.ndarray,
    ratio: float,
    rthreshold: float = 0.02,
    rmaxcycles: int = 8,
) -> np.ndarray:
    """Frame at an arbitrary time ``ratio`` via midpoint bisection.

    Midpoints are predicted repeatedly, recursing toward the target ratio
    until within ``rthreshold`` or after ``rmaxcycles`` rounds.
    """
    if ratio <= rthreshold:
        return np.asarray(img0)
    if ratio >= 1 - rthreshold:
        return np.asarray(img1)
    lo, hi = 0.0, 1.0
    a, b = np.asarray(img0), np.asarray(img1)
    middle = None
    for _ in range(rmaxcycles):
        mid_t = (lo + hi) / 2
        middle, _, _ = interp.pair(a, b)
        if abs(mid_t - ratio) <= rthreshold:
            return middle
        if ratio > mid_t:
            a, lo = middle, mid_t
        else:
            b, hi = middle, mid_t
    return middle


def interpolate_series(
    interp: Interpolator,
    frames: np.ndarray,
    factor: int,
    dup_ssim_gate: float | None = None,
    cut_ssim_gate: float | None = None,
    collect_flow: bool = False,
):
    """Decimate ``[T, *S, C]`` by ``factor`` and reconstruct by interpolation.

    Returns (reconstruction of length ``(T//factor-1)*factor + 1``, flows or
    None).  ``dup_ssim_gate`` copies img0 when a pair is near-identical
    (SSIM > gate); ``cut_ssim_gate`` copies img0 on scene cuts (SSIM < gate).
    Power-of-two factors without SSIM gates take the device-resident path.
    """
    if (
        factor >= 2 and factor & (factor - 1) == 0
        and dup_ssim_gate is None and cut_ssim_gate is None
        and type(interp) is Interpolator
    ):
        return interpolate_series_device(interp, frames, factor, collect_flow)
    kept = frames[::factor]
    out: list[np.ndarray] = []
    flows: list[np.ndarray] = []
    for a, b in zip(kept[:-1], kept[1:]):
        out.append(a)
        pair_ssim = None
        if dup_ssim_gate is not None or cut_ssim_gate is not None:
            pair_ssim = float(ssim(
                torch.from_numpy(np.asarray(a[None], np.float32)).to(interp.device),
                torch.from_numpy(np.asarray(b[None], np.float32)).to(interp.device),
            ))
        if (
            (dup_ssim_gate is not None and pair_ssim > dup_ssim_gate)
            or (cut_ssim_gate is not None and pair_ssim < cut_ssim_gate)
        ):
            mids = [a.copy() for _ in range(factor - 1)]
        else:
            mids = interpolate_recursive(interp, a[None], b[None], factor - 1)
            mids = [m[0] for m in mids]
            if collect_flow:
                _, flow, _ = interp.pair(a[None], b[None])
                flows.append(flow[0])
        out.extend(mids)
    out.append(kept[-1])
    recon = np.stack(out)
    return recon, (np.stack(flows) if flows else None)


def interpolate_series_device(
    interp: Interpolator,
    frames: np.ndarray,
    factor: int,
    collect_flow: bool = False,
):
    """Device-resident ``interpolate_series`` for power-of-two factors.

    The kept frames upload once, through the interpolator's staging ring
    (``Interpolator.staging``), and each bisection level runs as one batched
    forward on the device (level d fills the midpoints of all known pairs at
    gap ``factor / 2^d``).  The recursive-midpoint semantics are those of
    ``interpolate_recursive``.

    The results are fresh host arrays that own their memory (never views of
    the ring), allocated before the first level; the kept frames go into the
    reconstruction from the host input, never downloaded.  Each level's new
    rows (``starts + gap // 2``) download behind the next stage: once level
    d is enqueued, its rows are queued on the ring's copy stream behind an
    event of the compute stream, chunk by chunk into its pinned slots, and
    level d+1 (after the last level, the flows' forward) is enqueued while
    the ring's thread waits for level d's chunks and copies them into their
    rows of the reconstruction.  The flows (in the model's dtype, widened on
    the host) follow through the same ring.  The call returns once every
    byte is in the returned arrays; it holds ``recon`` and ``flow``, which
    the copy stream reads, until then.

    Spans: ``ofs.series`` around the call, with ``ofs.series.stage`` (the
    ring's allocation, at the first call), ``ofs.series.upload``, one
    ``ofs.series.level`` a bisection level, ``ofs.series.flows``, one
    ``ofs.series.download`` after each level and after the flows (its rows
    queued, and copied into the slots that are free), and a last one that
    copies the rest as slots free and waits until every chunk has landed:
    every copy between host and device is enqueued in ``ofs.series.upload``
    or ``ofs.series.download``.
    """
    if factor < 2 or factor & (factor - 1):
        raise ValueError(f"factor must be a power of two >= 2, got {factor}")
    kept = np.asarray(frames[::factor], np.float32)
    if kept.shape[0] < 2:
        return np.asarray(frames[:1], np.float32), None
    padded, _ = interp._pad(kept)
    n_out = (kept.shape[0] - 1) * factor + 1
    dev = interp.device
    out = np.empty((n_out,) + kept.shape[1:], np.float32)
    out_cf = torch.from_numpy(out).movedim(-1, 1)  # the rows as the device holds them, cropped
    flows = None
    if collect_flow:
        flows = np.empty((kept.shape[0] - 1,) + kept.shape[1:-1] + (2 * (kept.ndim - 2),),
                         np.float32)
    with span("ofs.series"):
        ring = interp.staging()
        ring.reserve(out)
        if flows is not None:
            ring.reserve(flows)
        with torch.inference_mode():
            with span("ofs.series.upload"):
                src = ring.upload(padded).movedim(-1, 1).contiguous()
            recon = torch.zeros((n_out,) + tuple(src.shape[1:]), dtype=torch.float32, device=dev)
            recon[::factor] = src
            gap = factor
            while gap > 1:
                with span("ofs.series.level"):
                    starts = torch.arange(0, n_out - 1, gap, device=dev)
                    merged, _, _ = interp.forward(recon[starts], recon[starts + gap], 0.5)
                    recon[starts + gap // 2] = merged.float()
                rows = slice(gap // 2, n_out - 1, gap)  # = starts + gap // 2
                ring.download(recon[rows], out_cf[rows])
                if gap == factor:
                    ring.host_copy(out_cf[::factor], torch.from_numpy(kept).movedim(-1, 1))
                gap //= 2
            if collect_flow:
                with span("ofs.series.flows"):
                    _, flow, _ = interp.forward(src[:-1], src[1:], 0.5)
                ring.download(flow, torch.from_numpy(flows).movedim(-1, 1))
            ring.drain()
    return out, flows


def batched_pair_inference(
    interp: Interpolator, tuples: np.ndarray, batch_size: int = 16
):
    """Run ``pair`` over grouped test tuples ``[N, slots, *S, C]`` (density ch).

    Returns a dict of stacked (pred, flow, mask, gt).
    """
    preds, flows, masks, gts = [], [], [], []
    for i in range(0, tuples.shape[0], batch_size):
        chunk = tuples[i : i + batch_size]
        img0 = chunk[:, 0, ..., :1]
        img1 = chunk[:, 1, ..., :1]
        gt = chunk[:, 2, ..., :1]
        pred, flow, mask = interp.pair(img0, img1)
        preds.append(pred)
        flows.append(flow)
        masks.append(mask)
        gts.append(gt)
    return {
        "pred": np.concatenate(preds),
        "flow": np.concatenate(flows),
        "mask": np.concatenate(masks),
        "gt": np.concatenate(gts),
    }


# -- the pretrained RIFE zoo (HDv3, HD v1 / v2) ------------------------------------------


class ZooInterpolator(_PaddedFrames):
    """``Interpolator.pair`` around a pretrained RIFE zoo model.

    Zoo models are RGB midpoint interpolators: single-channel frames are
    tiled to 3 channels on the way in and the prediction averaged back on the
    way out.  Frames are edge-padded to ``pad_multiple`` (32 for HDv3, 64 for
    the legacy networks).  ``kind`` is ``"hdv3"``, ``"hdv1"`` or ``"hdv2"``.
    Runs on ``device`` (``cuda`` unless ``device="cpu"``).
    """

    def __init__(self, kind: str, model: torch.nn.Module, pad_multiple: int,
                 device: str | torch.device | None = None):
        if kind not in ("hdv1", "hdv2", "hdv3"):
            raise ValueError(f"unknown zoo model kind {kind!r}")
        self.kind = kind
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.pad_multiple = pad_multiple

    def forward(self, img0: torch.Tensor, img1: torch.Tensor):
        """RGB channels-first device tensors → (merged, flow, mask), the flow
        at full resolution."""
        with torch.inference_mode():
            if self.kind == "hdv3":
                out = self.model(img0, img1)
                merged, flow, mask = out["merged"][-1], out["flow_list"][-1], out["mask"]
            else:
                merged, flow, mask = self.model.inference(img0, img1)
            if flow.shape[2:] != merged.shape[2:]:  # a half-resolution flow
                flow = resize_flow_nchw(flow, tuple(merged.shape[2:]))
        return merged, flow, mask

    def pair(self, img0: np.ndarray, img1: np.ndarray, timestep: float = 0.5):
        """The midpoint of two ``[B, H, W, C]`` frames (C = 1 or 3): numpy
        (merged ``[B, H, W, C]``, flow ``[B, H, W, 2 or 4]``, mask)."""
        if timestep != 0.5:
            raise ValueError(
                f"{self.kind} zoo models are midpoint-only interpolators; use "
                "recursive bisection (interpolate_recursive) for other ratios")
        p0, orig_shape = self._pad(np.asarray(img0, np.float32))
        p1, _ = self._pad(np.asarray(img1, np.float32))
        mono = p0.shape[-1] == 1
        if mono:
            p0, p1 = (np.repeat(p, 3, axis=-1) for p in (p0, p1))
        merged, flow, mask = self.forward(self._to_tensor(p0), self._to_tensor(p1))
        merged = self._to_numpy(merged)
        if mono:
            merged = merged.mean(axis=-1, keepdims=True)
        crop = self._crop(orig_shape)
        return merged[crop], self._to_numpy(flow)[crop], self._to_numpy(mask)[crop]


def load_pretrained_zoo(model_dir: str, device: str | torch.device | None = None
                        ) -> ZooInterpolator:
    """A ``ZooInterpolator`` from a pretrained RIFE checkpoint directory.

    A ``flownet.pkl`` / ``contextnet.pkl`` / ``unet.pkl`` trio is a legacy
    checkpoint, v2 where the flow network has ``convblock`` stacks, else v1;
    a lone ``flownet.pkl`` is HDv3.  The widths are read off the checkpoint.
    """
    from opticalflowscivis_tpu_torch.models.ifnet_hd import load_torch_rife_hdv3
    from opticalflowscivis_tpu_torch.models.ifnet_hd_legacy import load_torch_rife_hd_legacy

    trio = all(os.path.exists(os.path.join(model_dir, f))
               for f in ("flownet.pkl", "contextnet.pkl", "unet.pkl"))
    if trio:
        model = load_torch_rife_hd_legacy(model_dir)
        return ZooInterpolator(f"hdv{model.version}", model, 64, device)
    return ZooInterpolator("hdv3", load_torch_rife_hdv3(os.path.join(model_dir, "flownet.pkl")),
                           32, device)
