"""Lattice-Boltzmann D2Q9 simulation of flow past a cylinder (``lbs2d``).

Counterpart of ``opticalflowscivis_tpu/data/lbs.py``, which runs the
simulation as a jitted ``lax.scan``; here it runs as PyTorch on a device,
the GPU unless the caller asks for the CPU.  Physics as the reference's:

- 400x100 grid, rho0 = 100, tau = 0.6, 33 000 steps, one kept state every
  10th step after a burn-in of 3000;
- D2Q9 velocities and weights, a rightward initial drive on channel 3 with a
  4-period cosine perturbation and noise, built in float64 numpy from the
  seed and cast to float32;
- a cylinder of radius ny/4 at (nx/4, ny/2) with full bounce-back;
- an optional sustained velocity inlet on the left column and a
  zero-gradient outflow on the right (``inflow_u``).

Each step is a handful of elementwise kernels on the populations, held
channels-first ``[9, ny, nx]``; the drift of all nine channels is one gather
(``torch.take`` of precomputed source indices, the same as nine
``torch.roll``).  The loop runs eagerly, one step after another: no CUDA
graph.  The output is ``[T, ny, nx, 3]`` (density, uy, ux) float32, flow
channels row-major, density normalised to [0, 1] at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflowscivis_tpu_torch.device import resolve_device

# D2Q9: (cx, cy) per channel, in the reference's order
_CXS = np.array([0, 0, 1, 1, 1, 0, -1, -1, -1])
_CYS = np.array([0, 1, 1, 0, -1, -1, -1, 0, 1])
_W = np.array([4 / 9, 1 / 9, 1 / 36, 1 / 9, 1 / 36, 1 / 9, 1 / 36, 1 / 9, 1 / 36])
# bounce-back: the opposite channel of each of the 9 directions
_OPP = np.array([0, 5, 6, 7, 8, 1, 2, 3, 4])


def initial_state(nx: int, ny: int, rho0: float, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``(F [ny, nx, 9] float32, cylinder [ny, nx] bool)``: the populations
    drawn in float64 from ``seed`` and cast to float32, and the obstacle."""
    rng = np.random.default_rng(seed)
    F = np.ones((ny, nx, 9)) + 0.01 * rng.standard_normal((ny, nx, 9))
    X = np.arange(nx)[None, :].repeat(ny, 0)
    F[:, :, 3] += 2 * (1 + 0.2 * np.cos(2 * np.pi * X / nx * 4))
    rho = F.sum(-1, keepdims=True)
    F *= rho0 / rho
    Y = np.arange(ny)[:, None].repeat(nx, 1)
    cylinder = ((X - nx / 4) ** 2 + (Y - ny / 2) ** 2) < (ny / 4) ** 2
    return F.astype(np.float32), cylinder


def lattice_boltzmann_2d(
    nx: int = 400,
    ny: int = 100,
    n_steps: int = 33000,
    skip: int = 3000,
    sample_every: int = 10,
    rho0: float = 100.0,
    tau: float = 0.6,
    seed: int = 42,
    inflow_u: float = 0.0,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Run the simulation on ``device`` (the GPU unless ``"cpu"``); returns
    ``[(n_steps - skip) // sample_every, ny, nx, 3]`` (density, uy, ux)."""
    dev = resolve_device(device)
    F0, cylinder = initial_state(nx, ny, rho0, seed)
    F = torch.from_numpy(F0).permute(2, 0, 1).contiguous().to(dev)  # [9, ny, nx]
    cyl = torch.from_numpy(cylinder).to(dev)
    cxs = torch.from_numpy(_CXS).to(dev, torch.float32)[:, None, None]
    cys = torch.from_numpy(_CYS).to(dev, torch.float32)[:, None, None]
    w = torch.from_numpy(_W).to(dev, torch.float32)[:, None, None]
    opp = torch.from_numpy(_OPP).to(dev)
    # drift: channel i moves by (cy_i, cx_i) with wrap-around, so each target
    # cell reads the source cell (y - cy_i, x - cx_i) of its own channel
    y = np.arange(ny)[None, :, None]
    x = np.arange(nx)[None, None, :]
    src = (np.arange(9)[:, None, None] * ny * nx
           + ((y - _CYS[:, None, None]) % ny) * nx + (x - _CXS[:, None, None]) % nx)
    src = torch.from_numpy(src).to(dev)
    if inflow_u:
        cu_in = 3.0 * cxs * inflow_u
        feq_in = rho0 * w * (1 + cu_in + cu_in**2 / 2 - 1.5 * inflow_u**2)  # [9, 1, 1]

    def step(F: torch.Tensor, keep: bool):
        F = torch.take(F, src)
        bndry = F[opp]  # bounce-back inside the cylinder: reflected populations
        rho = F.sum(0)
        ux = (F * cxs).sum(0) / rho
        uy = (F * cys).sum(0) / rho
        cu = cxs * ux + cys * uy
        Feq = rho * w * (1 + 3 * cu + 9 * cu**2 / 2 - 3 * (ux**2 + uy**2) / 2)
        F = F - (1.0 / tau) * (F - Feq)
        F = torch.where(cyl, bndry, F)
        if inflow_u:
            # velocity inlet: equilibrium populations at (rho0, inflow_u);
            # outflow: a zero-gradient copy of the second-to-last column
            F[:, :, 0] = feq_in[:, :, 0]
            F[:, :, -1] = F[:, :, -2]
        if not keep:
            return F, None
        zero = torch.zeros((), device=dev)
        return F, torch.stack([rho, torch.where(cyl, zero, uy), torch.where(cyl, zero, ux)], -1)

    n_keep = (n_steps - skip) // sample_every
    kept = torch.empty((n_keep, ny, nx, 3), device=dev)
    with torch.no_grad():
        for _ in range(skip):
            F, _ = step(F, False)
        for k in range(n_keep):
            F, kept[k] = step(F, True)
            for _ in range(sample_every - 1):
                F, _ = step(F, False)
    out = kept.cpu().numpy()
    # density normalised to [0, 1] for the scalar channel, as the loader expects
    d = out[..., 0]
    out[..., 0] = (d - d.min()) / max(d.max() - d.min(), 1e-9)
    return out
