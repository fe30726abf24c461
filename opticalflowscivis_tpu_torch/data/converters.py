"""Offline dataset converters — NetCDF / raw / CSV → framework arrays.

A numpy copy of the reference package's ``data/converters.py`` (the port
imports nothing of that package); a test pins the pkl files it writes to the
original's from the same inputs.  Parity with ``Datasets/read_data.py``:
- ``convert_droplet3d``   ⇔ :93-200 — N raw 256^3 uint8 volumes → 2x (2,2,2)
  local-mean downscale → 64^3 float, split into train/val pkls.
- ``convert_fluidsimml``  ⇔ :202-358 — per-simulation CSV fields, downsampled,
  density + (u, v) flow pkls.
- ``convert_netcdf_2d``   ⇔ :360-436 — generic 2-D NetCDF u/v pair → flow pkl
  ``[T, H, W, 2]`` + magnitude pkl ``[T, H, W, 1]``.
- ``convert_netcdf_3d``   ⇔ :438-533 — 3-D NetCDF (tangaroa/tornado) magnitude,
  downsampled.
- ``convert_5jets``: the 5Jets raw ``.dat`` fields, streamed one step at a time.

netCDF4 is not installed in every image — NetCDF readers raise a clear
ImportError message if absent.  Outputs use the framework layout (channels-last,
flow row-major) and are written with pickle protocol 4 like the reference.
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np


def downscale_local_mean(arr: np.ndarray, factors: tuple[int, ...]) -> np.ndarray:
    """Block-mean downscaling (skimage.transform.downscale_local_mean parity)."""
    slices = tuple(slice(0, (s // f) * f) for s, f in zip(arr.shape, factors))
    arr = arr[slices]
    for axis, f in enumerate(factors):
        if f == 1:
            continue
        shape = arr.shape
        new = shape[:axis] + (shape[axis] // f, f) + shape[axis + 1 :]
        arr = arr.reshape(new).mean(axis=axis + 1)
    return arr


def _save_pkl(arr: np.ndarray, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(np.asarray(arr, np.float32), f, protocol=4)
    return path


def convert_5jets(
    src_dir: str,
    out_path: str,
    downscale: int = 2,
    flow_scale: float = 1.0,
    limit: int = 0,
) -> str:
    """5Jets raw ``.dat`` fields → ``[T, 128//k, 128//k, 128//k, 4]`` pkl.

    The reference reads these exploratorily (Datasets/5Jets/read_data.py:14-21):
    ``Velocity/ns_<step>_v.dat`` is raw float32 reshaped (128,128,128,3) and
    ``Density/ns_<step>_r.dat`` is raw float32 (128,128,128); README.md:24-26
    lists 2000 steps (~80 GB), which is why this converter streams one step at
    a time and block-mean downsamples (``downscale`` per axis, like the
    droplet3d path, read_data.py:149-159).

    Output channels: density + per-step displacement flow, components ordered
    row-major ``(d_axis0, d_axis1, d_axis2)`` — the file's (c0, c1, c2) velocity
    components are assumed to align with the array axes in order; ``flow_scale``
    converts physical velocity to voxels/step in the *downsampled* grid.
    """
    # numeric step sort — lexicographic order scrambles 4- vs 5-digit steps
    vel_files = sorted(
        glob.glob(os.path.join(src_dir, "Velocity", "ns_*_v.dat")),
        key=lambda p: int(os.path.basename(p).split("_")[1]),
    )
    if limit:
        vel_files = vel_files[:limit]
    if not vel_files:
        raise FileNotFoundError(f"no Velocity/ns_*_v.dat under {src_dir}")
    frames = []
    k = downscale
    for vf in vel_files:
        step = os.path.basename(vf).split("_")[1]
        rf = os.path.join(src_dir, "Density", f"ns_{step}_r.dat")
        vel = np.fromfile(vf, dtype=np.float32).reshape(128, 128, 128, 3)
        rho = (
            np.fromfile(rf, dtype=np.float32).reshape(128, 128, 128)
            if os.path.exists(rf)
            else np.linalg.norm(vel, axis=-1)  # density file missing → |v|
        )
        if k > 1:
            rho = downscale_local_mean(rho, (k, k, k))
            vel = downscale_local_mean(vel, (k, k, k, 1)) / k
        frames.append(
            np.concatenate([rho[..., None], vel * flow_scale], axis=-1)
        )
    return _save_pkl(np.stack(frames), out_path)


def convert_droplet3d(
    raw_dir: str,
    out_dir: str,
    volume_shape: tuple[int, int, int] = (256, 256, 256),
    downscale: int = 4,
    train_frac: float = 0.9,
    pattern: str = "*.raw",
) -> tuple[str, str]:
    """Raw uint8 volumes → downscaled train/val pkls (read_data.py:93-200)."""
    files = sorted(glob.glob(os.path.join(raw_dir, pattern)))
    if not files:
        raise FileNotFoundError(f"no {pattern} files in {raw_dir}")
    vols = []
    for path in files:
        raw = np.fromfile(path, dtype=np.uint8)
        vol = raw.reshape(volume_shape).astype(np.float32) / 255.0
        # two successive (2,2,2) local-mean passes in the reference == one
        # (downscale,)*3 block mean
        vol = downscale_local_mean(vol, (downscale,) * 3)
        vols.append(vol[..., None])
    data = np.stack(vols)
    n_train = int(len(data) * train_frac)
    side = volume_shape[0] // downscale
    p_train = _save_pkl(data[:n_train], os.path.join(out_dir, f"droplet3d_{side}_train.pkl"))
    p_val = _save_pkl(data[n_train:], os.path.join(out_dir, f"droplet3d_{side}_val.pkl"))
    return p_train, p_val


def convert_fluidsimml(
    csv_paths: list[str],
    out_dir: str,
    grid: tuple[int, int] = (512, 512),
    downscale: int = 1,
) -> str:
    """FluidSimML CSV members → stacked density+flow pkl (read_data.py:202-358).

    Each CSV row holds (density, u, v) per cell for one timestep.
    """
    frames = []
    for path in csv_paths:
        table = np.loadtxt(path, delimiter=",", dtype=np.float32)
        t = table.reshape(-1, grid[0], grid[1], 3)
        if downscale > 1:
            t = downscale_local_mean(t, (1, downscale, downscale, 1))
        # CSV order (density, u=x, v=y) → framework (density, dy, dx)
        frames.append(np.stack([t[..., 0], t[..., 2], t[..., 1]], axis=-1))
    data = np.concatenate(frames)
    return _save_pkl(data, os.path.join(out_dir, "FluidSimML2d.pkl"))


def _require_netcdf():
    try:
        import netCDF4  # noqa: F401

        return netCDF4
    except ImportError as e:
        raise ImportError(
            "netCDF4 is not installed in this image; NetCDF converters are "
            "gated (install netCDF4 to convert cylinder/tangaroa/tornado data)"
        ) from e


def convert_netcdf_2d(
    nc_path: str, out_dir: str, name: str, u_var: str = "u", v_var: str = "v"
) -> str:
    """2-D NetCDF u/v velocity → ``[T, H, W, 3]`` magnitude+flow pkl
    (read_data.py:360-436)."""
    netCDF4 = _require_netcdf()
    with netCDF4.Dataset(nc_path) as ds:
        u = np.asarray(ds.variables[u_var][:], np.float32)
        v = np.asarray(ds.variables[v_var][:], np.float32)
    mag = np.sqrt(u**2 + v**2)
    data = np.stack([mag, v, u], axis=-1)  # (magnitude, dy, dx)
    return _save_pkl(data, os.path.join(out_dir, f"{name}.pkl"))


def convert_netcdf_3d(
    nc_path: str, out_dir: str, name: str, var: str = "magnitude",
    downscale: tuple[int, int, int] = (1, 1, 1),
) -> str:
    """3-D NetCDF scalar series → downsampled pkl (read_data.py:438-533)."""
    netCDF4 = _require_netcdf()
    with netCDF4.Dataset(nc_path) as ds:
        data = np.asarray(ds.variables[var][:], np.float32)
    if any(f > 1 for f in downscale):
        data = downscale_local_mean(data, (1, *downscale))
    return _save_pkl(data[..., None], os.path.join(out_dir, f"{name}_downs.pkl"))
