"""Droplet-like series made on the device from a seed: smooth, textured
blobs that drift with constant velocities through a periodic domain.

Each blob is a product of one profile per axis, a Gaussian of the distance
to its centre (wrapped around the domain) times a ripple that moves with it,
so a frame is a sum of separable terms computed as one tensor contraction;
``tanh`` saturates overlapping blobs, as droplets' densities do.  Every
velocity component is at most ``max_shift`` a frame (the model's warp
radius), so the flow from a middle frame to its neighbours stays inside the
warps' bound.  Values lie in [0, 1)."""

from __future__ import annotations

import math

import torch


def droplet_series(seed: int, frames: int, spatial: tuple[int, ...], max_shift: float,
                   device, blobs: int = 32) -> torch.Tensor:
    """``[frames, *spatial]`` float32 on ``device``; the same seed gives the
    same series."""
    nd = len(spatial)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    size = torch.tensor(spatial, dtype=torch.float32, device=device)
    centre = uniform(0.0, 1.0, blobs, nd) * size
    velocity = uniform(-max_shift, max_shift, blobs, nd)
    sigma = uniform(0.03, 0.09, blobs, 1) * min(spatial)
    wave = 2 * math.pi / uniform(5.0, 14.0, blobs, nd)
    phase = uniform(0.0, 2 * math.pi, blobs, nd)
    amp = uniform(0.6, 1.4, blobs)
    axes = [torch.arange(n, dtype=torch.float32, device=device) for n in spatial]
    letters = "zyx"[-nd:]
    equation = ",".join("k" + a for a in letters) + ",k->" + letters
    out = torch.empty((frames,) + tuple(spatial), device=device)
    for t in range(frames):
        at = centre + velocity * t
        profiles = []
        for a, u in enumerate(axes):
            d = torch.remainder(u[None] - at[:, a:a + 1] + spatial[a] / 2, spatial[a]) - spatial[a] / 2
            ripple = 1 + 0.35 * torch.cos(wave[:, a:a + 1] * d + phase[:, a:a + 1])
            profiles.append(torch.exp(-d * d / (2 * sigma * sigma)) * ripple)
        out[t] = torch.tanh(torch.einsum(equation, *profiles, amp))
    return out
