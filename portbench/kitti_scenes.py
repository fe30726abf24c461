"""KITTI-like multi-view sequences made on the device from a seed, stored as
UPFlow's KITTI training keeps its frames on the card: ``[F, H, W, 3]``
bfloat16, normalised as ``kitti_photometric_normalize`` leaves them (RGB in
[0, 1] less UPFlow's fixed channel means).

A sequence is a camera moving smoothly over a textured plane, with a few
opaque patches moving on their own in front of it:

- the plane is periodic and holds ``blobs`` coloured blobs, each a product
  of one profile per axis (a Gaussian of the wrapped distance to its centre,
  of 3 to 30 pixels' deviation, times a ripple), so that a frame is one
  matrix product over the blobs; ``tanh`` saturates where they overlap;
- the camera's velocity along each axis is a constant plus a slow sine,
  each frame at most ``max_shift`` pixels along either axis;
- each patch is a soft-edged rectangle carrying its own ripple texture; it
  starts inside the frame and moves at its own velocity (at most
  ``max_shift`` a frame), covering and uncovering the plane, so that the
  forward-backward check finds real occlusions.

Sequence s holds frames ``s * frames`` to ``s * frames + frames - 1``; the
pairs are every two consecutive frames of a sequence.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# UPFlow's input normalisation: the BGR means 104.920005, 110.1753,
# 114.785955 of its KITTI loader, in RGB order over 255
KITTI_MEAN_RGB01 = (114.785955 / 255.0, 110.1753 / 255.0, 104.920005 / 255.0)


def pairs(sequences: int, frames: int) -> np.ndarray:
    """``[sequences * (frames - 1), 2]`` int32: consecutive frames of each sequence."""
    t = np.arange(frames - 1)
    return np.concatenate([np.stack([s * frames + t, s * frames + t + 1], 1)
                           for s in range(sequences)]).astype(np.int32)


def kitti_scenes(seed: int, sequences: int, frames: int, size: tuple[int, int],
                 max_shift: float, device, blobs: int = 768, patches: int = 4) -> torch.Tensor:
    """``[sequences * frames, H, W, 3]`` bfloat16 on ``device``; the same seed
    gives the same frames."""
    h, w = size
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    plane = torch.tensor([2.0 * h, 2.0 * w], device=device)
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    mean = torch.tensor(KITTI_MEAN_RGB01, device=device)
    store = torch.empty((sequences * frames, h, w, 3), dtype=torch.bfloat16, device=device)
    for s in range(sequences):
        centre = uniform(0.0, 1.0, blobs, 2) * plane
        sigma = uniform(3.0, 30.0, blobs, 1)
        wave = 2 * math.pi / uniform(4.0, 24.0, blobs, 2)
        phase = uniform(0.0, 2 * math.pi, blobs, 2)
        colour = uniform(-1.0, 1.0, blobs, 3)
        base = uniform(0.3, 0.6, 3)
        # camera: velocity v0 + a sin(omega t + phi) per axis, |v| <= max_shift
        v0 = uniform(-0.6, 0.6, 2) * max_shift
        amp = uniform(0.0, 0.4, 2) * max_shift
        omega, phi = uniform(0.1, 0.5, 2), uniform(0.0, 2 * math.pi, 2)
        # patches: centre, half sizes, velocity, colour and ripple
        p_at = uniform(0.1, 0.9, patches, 2) * torch.tensor([h, w], device=device)
        p_half = uniform(15.0, 50.0, patches, 2) * torch.tensor([1.0, 2.0], device=device)
        p_vel = uniform(-1.0, 1.0, patches, 2) * max_shift
        p_colour = uniform(0.1, 0.9, patches, 3)
        p_wave = 2 * math.pi / uniform(6.0, 20.0, patches, 2)
        p_phase = uniform(0.0, 2 * math.pi, patches, 2)
        for t in range(frames):
            # the camera's offset after t frames: the sum of the velocities before
            k = torch.arange(t, dtype=torch.float32, device=device)[:, None]
            origin = (v0 + amp * torch.sin(omega * k + phi)).sum(0) if t else v0 * 0
            profiles = []
            for a, u in enumerate((ys, xs)):
                d = torch.remainder(u[None] + origin[a] - centre[:, a:a + 1] + plane[a] / 2,
                                    plane[a]) - plane[a] / 2
                ripple = 1 + 0.5 * torch.cos(wave[:, a:a + 1] * d + phase[:, a:a + 1])
                profiles.append(torch.exp(-d * d / (2 * sigma * sigma)) * ripple)
            img = base + 0.45 * torch.tanh(torch.einsum("ky,kx,kc->yxc", *profiles, colour))
            for p in range(patches):
                c = p_at[p] + p_vel[p] * t
                dy, dx = ys - c[0], xs - c[1]
                alpha = (torch.sigmoid((p_half[p, 0] - dy.abs()) / 1.5)[:, None]
                         * torch.sigmoid((p_half[p, 1] - dx.abs()) / 1.5)[None])[..., None]
                tex = p_colour[p] + 0.3 * (torch.cos(p_wave[p, 0] * dy + p_phase[p, 0])[:, None]
                                           * torch.cos(p_wave[p, 1] * dx + p_phase[p, 1])[None]
                                           )[..., None]
                img = img * (1 - alpha) + tex * alpha
            store[s * frames + t] = (img.clamp(0.0, 1.0) - mean).to(torch.bfloat16)
    return store
