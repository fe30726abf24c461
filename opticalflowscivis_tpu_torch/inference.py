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

import os

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

    The kept frames upload once, each bisection level runs as one batched
    forward on the device (level d fills the midpoints of all known pairs at
    gap ``factor / 2^d``), and the reconstruction downloads once.  The
    recursive-midpoint semantics are those of ``interpolate_recursive``.
    Spans: ``ofs.series`` around the call, with ``ofs.series.upload``, one
    ``ofs.series.level`` a bisection level, ``ofs.series.flows`` and
    ``ofs.series.download`` (every copy to the host) inside it.
    """
    if factor < 2 or factor & (factor - 1):
        raise ValueError(f"factor must be a power of two >= 2, got {factor}")
    kept = np.asarray(frames[::factor], np.float32)
    if kept.shape[0] < 2:
        return np.asarray(frames[:1], np.float32), None
    padded, orig_shape = interp._pad(kept)
    n_out = (kept.shape[0] - 1) * factor + 1
    dev = interp.device
    with span("ofs.series"), torch.inference_mode():
        with span("ofs.series.upload"):
            src = interp._to_tensor(padded)
        recon = torch.zeros((n_out,) + tuple(src.shape[1:]), dtype=torch.float32, device=dev)
        recon[::factor] = src
        gap = factor
        while gap > 1:
            with span("ofs.series.level"):
                starts = torch.arange(0, n_out - 1, gap, device=dev)
                merged, _, _ = interp.forward(recon[starts], recon[starts + gap], 0.5)
                recon[starts + gap // 2] = merged.float()
            gap //= 2

        flow = None
        if collect_flow:
            with span("ofs.series.flows"):
                _, flow, _ = interp.forward(src[:-1], src[1:], 0.5)
        crop = interp._crop(orig_shape)
        with span("ofs.series.download"):
            flows = None if flow is None else interp._to_numpy(flow)[crop]
            return interp._to_numpy(recon)[crop], flows


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
