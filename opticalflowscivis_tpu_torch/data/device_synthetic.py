"""Synthetic frames composed on the device from integer positions.

Counterpart of ``opticalflowscivis_tpu/data/device_synthetic.py``.  A
rectangle dataset's frames are fixed by a small integer box trajectory
(``synthetic._box_trajectory``).  At 256^3 a frame is 67 MB, its trajectory a
few bytes: composing the frames on the device from positions makes a fresh
training tuple cost its positions in host-to-device traffic, so every epoch
can train on a new scene instead of a fixed export.

- Host helpers (numpy, the same random streams as the numpy generators):
  ``tuple_positions``, ``pan_scene_host`` / ``pan_pair_positions`` and
  ``multibox_pan_scene_host`` / ``multibox_pan_pair_positions``;
- device functions (plain torch on the positions' device, batched by index
  arithmetic and gathers, no Python loop over the batch):
  ``box_density_device``, ``pan_pairs_device`` and
  ``multibox_pan_pairs_device``.

For the same trajectory the device frames equal ``rectangle_3d(with_flow=
False)``, ``rectangle_2d(background="pan")`` and ``rectangles_2d(background=
"pan")`` bit for bit.  Like ``jax.lax.dynamic_update_slice`` and
``dynamic_slice`` in the reference, a corner is placed as ``_start`` says:
a negative one counts from the end, then it is clamped so that the box lies
inside the canvas and the camera window inside the background.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflowscivis_tpu_torch.data.synthetic import (
    _box_trajectory,
    _hf_texture,
    _multi_octave_field,
)


def box_density_device(pos: torch.Tensor, grid: tuple[int, ...],
                       box: tuple[int, ...]) -> torch.Tensor:
    """Constant-1 box density from integer corner positions, on ``pos``'s device.

    ``pos [..., ndim]`` → ``[..., *grid, 1] float32``: each leading index
    stamps one frame, 1.0 where ``pos[a] <= axis_a < pos[a] + box[a]`` for
    every spatial axis and 0 elsewhere.
    """
    nd = len(grid)
    lead = pos.shape[:-1]
    mask = None
    for a in range(nd):
        shape = [1] * nd
        shape[a] = grid[a]
        i = torch.arange(grid[a], device=pos.device).view(shape)
        p = pos[..., a].reshape(lead + (1,) * nd)
        m = (i >= p) & (i < p + box[a])
        mask = m if mask is None else mask & m
    return mask.to(torch.float32).unsqueeze(-1)


def tuple_positions(
    rng: np.random.Generator,
    n_tuples: int,
    grid: tuple[int, ...],
    box: tuple[int, ...],
    vel_max: int = 8,
    max_seq: int = 10,
) -> np.ndarray:
    """``[N, 3, ndim] int32`` box corners for (img0, img1, gt).

    Slot order is ``pipeline.group_tuples(..., exp=1)``'s: tuple ``k`` takes
    trajectory frames ``(3k, 3k+2, 3k+1)``.
    """
    traj = _box_trajectory(rng, 3 * n_tuples, grid, box, vel_max, max_seq)
    k = np.arange(n_tuples) * 3
    return np.stack([traj[k], traj[k + 2], traj[k + 1]], axis=1).astype(np.int32)


# -- 2-D pan scenes (rectangle_2d(background="pan")) ------------------------------

PAN_PAD = 48  # margin of the background field around the camera window


def pan_scene_host(
    rng: np.random.Generator,
    n_frames: int,
    grid: tuple[int, int],
    box: tuple[int, int],
    vel_max: int = 6,
    max_seq: int = 15,
    pan_vel_max: int = 3,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(tex, big, box_traj, cam_traj)`` of one pan scene.

    Draws from ``rng`` in ``rectangle_2d(background="pan")``'s order (texture,
    box trajectory, background field, camera trajectory), so that the device
    composition reproduces that generator for the same seed.  ``tex`` and
    ``big`` are the scene's constants (about 100 KB at 128 x 128).
    """
    tex = _hf_texture(rng, box)
    box_traj = _box_trajectory(rng, n_frames, grid, box, vel_max, max_seq)
    big = _multi_octave_field(rng, (grid[0] + 2 * PAN_PAD, grid[1] + 2 * PAN_PAD))
    cam_traj = _box_trajectory(
        rng, n_frames, tuple(g + 2 * PAN_PAD for g in grid), grid, pan_vel_max, max_seq,
    )
    return tex, big, box_traj.astype(np.int32), cam_traj.astype(np.int32)


def _start(p: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """Start index of a slice of ``size`` along an axis of ``dim``, as
    ``jax.lax.dynamic_slice`` and ``dynamic_update_slice`` take it: a negative
    ``p`` counts from the end, and the result is clamped to ``[0, dim - size]``."""
    p = p.long()
    return torch.where(p < 0, p + dim, p).clamp(0, dim - size)


def _window(big: torch.Tensor, cam: torch.Tensor, grid: tuple[int, int]) -> torch.Tensor:
    """``[B, H, W]`` camera windows of ``big`` at corners ``cam [B, 2]``."""
    h, w = grid
    c0 = _start(cam[:, 0], big.shape[0], h)
    c1 = _start(cam[:, 1], big.shape[1], w)
    ys = c0[:, None] + torch.arange(h, device=big.device)
    xs = c1[:, None] + torch.arange(w, device=big.device)
    return big[ys[:, :, None], xs[:, None, :]]


def _canvas(tex: torch.Tensor, corner: torch.Tensor, grid: tuple[int, int]) -> torch.Tensor:
    """``[B, H, W]`` zero canvases with ``tex`` stamped at ``corner [B, 2]``."""
    h, w = grid
    bh, bw = tex.shape
    b0 = _start(corner[:, 0], h, bh)
    b1 = _start(corner[:, 1], w, bw)
    ty = torch.arange(h, device=tex.device) - b0[:, None]
    tx = torch.arange(w, device=tex.device) - b1[:, None]
    inside = (((ty >= 0) & (ty < bh))[:, :, None]) & (((tx >= 0) & (tx < bw))[:, None, :])
    stamped = tex[ty.clamp(0, bh - 1)[:, :, None], tx.clamp(0, bw - 1)[:, None, :]]
    return torch.where(inside, stamped, torch.zeros((), dtype=tex.dtype, device=tex.device))


def _channels(f: torch.Tensor, in_channels: int) -> torch.Tensor:
    return f.unsqueeze(-1).expand(*f.shape, in_channels).contiguous()


def _paint(big: torch.Tensor, cam: torch.Tensor, texs: list[torch.Tensor],
           corners: torch.Tensor, grid: tuple[int, int]):
    """``N`` frames ``[N, H, W]``: the camera windows of ``big`` at ``cam [N,
    2]`` with each of ``texs`` stamped over them at ``corners[:, k] [N, 2]``,
    later boxes on top; and each box's coverage ``[N, H, W]`` (``canvas >
    0``: texture values are >= 30/255).  Both frames of a pair go through in
    one batch: half the launches of one call per frame."""
    out = _window(big, cam, grid)
    covs = []
    for k, tex in enumerate(texs):
        canvas = _canvas(tex, corners[:, k], grid)
        cov = canvas > 0
        out = torch.where(cov, canvas, out)
        covs.append(cov)
    return out, covs


def pan_pairs_device(
    tex: torch.Tensor,
    big: torch.Tensor,
    box_pos: torch.Tensor,
    cam_pos: torch.Tensor,
    grid: tuple[int, int],
    in_channels: int = 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pan-scene frame pairs composed on the device from integer positions.

    ``tex [*box]`` and ``big [H+2p, W+2p]`` are the scene's constants on the
    device; ``box_pos`` and ``cam_pos [B, 2, 2]`` hold the (frame t, frame
    t+1) corners.  Returns ``(im1, im2) [B, H, W, in_channels]`` and the
    true flow of frame t ``[B, H, W, 2]``: the box's step on the box, the
    negated camera step on the background.
    """
    b, (h, w) = box_pos.shape[0], grid
    frames, (cov,) = _paint(big, cam_pos.reshape(-1, 2), [tex], box_pos.reshape(-1, 1, 2), grid)
    frames = frames.view(b, 2, h, w)
    box_step = (box_pos[:, 1] - box_pos[:, 0]).to(torch.float32)[:, None, None, :]
    cam_step = -(cam_pos[:, 1] - cam_pos[:, 0]).to(torch.float32)[:, None, None, :]
    flow = torch.where(cov.view(b, 2, h, w)[:, 0, ..., None], box_step, cam_step)
    return _channels(frames[:, 0], in_channels), _channels(frames[:, 1], in_channels), flow


def pan_pair_positions(box_traj: np.ndarray, cam_traj: np.ndarray,
                       idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pair-slot positions ``([N, 2, 2], [N, 2, 2])`` for frame indices ``idx``."""
    def take(tr):
        return np.stack([tr[idx], tr[idx + 1]], axis=1)

    return take(box_traj), take(cam_traj)


# -- multi-box pan scenes (rectangles_2d(background="pan")) -----------------------


def multibox_pan_scene_host(
    rng: np.random.Generator,
    n_frames: int,
    grid: tuple[int, int],
    boxes: tuple[tuple[int, int], ...],
    vel_max: int = 6,
    max_seq: int = 15,
    pan_vel_max: int = 8,
) -> tuple[list[np.ndarray], np.ndarray, np.ndarray, np.ndarray]:
    """``(textures, big, box_trajs [n_boxes, T+1, 2], cam_traj)`` of a pan
    scene with several rigid textured boxes moving independently over the
    panning background; draws in ``rectangles_2d(background="pan")``'s order
    (each box's texture and trajectory, the background field, the camera)."""
    texs, trajs = [], []
    for b in boxes:
        texs.append(_hf_texture(rng, b))
        trajs.append(_box_trajectory(rng, n_frames, grid, b, vel_max, max_seq))
    big = _multi_octave_field(rng, (grid[0] + 2 * PAN_PAD, grid[1] + 2 * PAN_PAD))
    cam = _box_trajectory(
        rng, n_frames, tuple(g + 2 * PAN_PAD for g in grid), grid, pan_vel_max, max_seq,
    )
    return texs, big, np.stack(trajs).astype(np.int32), cam.astype(np.int32)


def multibox_pan_pairs_device(
    texs: list[torch.Tensor],
    big: torch.Tensor,
    box_pos: torch.Tensor,
    cam_pos: torch.Tensor,
    grid: tuple[int, int],
    in_channels: int = 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-box pan pairs composed on the device.  ``box_pos [B, n_boxes, 2,
    2]`` (box, frame of the pair, yx); later boxes overwrite earlier ones,
    pixels and flow alike, in ``rectangles_2d``'s painter order."""
    (b, n), (h, w) = box_pos.shape[:2], grid
    corners = box_pos.transpose(1, 2).reshape(-1, n, 2)  # [2B, n_boxes, 2], frame-major
    frames, covs = _paint(big, cam_pos.reshape(-1, 2), texs, corners, grid)
    frames = frames.view(b, 2, h, w)
    steps = (box_pos[:, :, 1] - box_pos[:, :, 0]).to(torch.float32)  # [B, n_boxes, 2]
    box_flow = torch.zeros((b, h, w, 2), dtype=torch.float32, device=frames.device)
    covered = torch.zeros((b, h, w), dtype=torch.bool, device=frames.device)
    for k, cov in enumerate(covs):
        cov1 = cov.view(b, 2, h, w)[:, 0]  # frame t
        box_flow = torch.where(cov1[..., None], steps[:, k, None, None, :], box_flow)
        covered = covered | cov1
    cam_step = -(cam_pos[:, 1] - cam_pos[:, 0]).to(torch.float32)[:, None, None, :]
    flow = torch.where(covered[..., None], box_flow, cam_step)
    return _channels(frames[:, 0], in_channels), _channels(frames[:, 1], in_channels), flow


def multibox_pan_pair_positions(box_trajs: np.ndarray, cam_traj: np.ndarray,
                                idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pair-slot positions ``([N, n_boxes, 2, 2], [N, 2, 2])`` for ``idx``."""
    bp = np.stack([box_trajs[:, idx], box_trajs[:, idx + 1]], axis=2)
    bp = np.moveaxis(bp, 0, 1)  # [N, n_boxes, 2, 2]
    cp = np.stack([cam_traj[idx], cam_traj[idx + 1]], axis=1)
    return bp.astype(np.int32), cp.astype(np.int32)
