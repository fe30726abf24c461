"""PyTorch port: the offline converters and the raw YUV420 I/O, the twins of
``tests/test_data_io.py``'s converter cases and ``tests/test_evalsuite.py``'s
YUV round trip, each also pinned to the JAX package's module on the same
inputs: the pkl files the converters write load back equal, the colour
conversions are equal, and the YUV files written are the same byte for byte.
"""

import os
import pickle

import numpy as np
import pytest

from opticalflowscivis_tpu.data import converters as jax_converters
from opticalflowscivis_tpu.data import yuv_io as jax_yuv_io
from opticalflowscivis_tpu_torch.data import yuv_io
from opticalflowscivis_tpu_torch.data.converters import (
    convert_5jets,
    convert_droplet3d,
    convert_fluidsimml,
    convert_netcdf_2d,
    convert_netcdf_3d,
    downscale_local_mean,
)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _same_pkl(ours: str, theirs: str) -> np.ndarray:
    a, b = _load(ours), _load(theirs)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    return a


def test_downscale_local_mean():
    x = np.arange(16, dtype=np.float32).reshape(4, 4)
    out = downscale_local_mean(x, (2, 2))
    np.testing.assert_allclose(out, [[2.5, 4.5], [10.5, 12.5]])
    y = np.random.default_rng(0).normal(size=(7, 9, 5)).astype(np.float32)
    np.testing.assert_array_equal(downscale_local_mean(y, (2, 3, 1)),
                                  jax_converters.downscale_local_mean(y, (2, 3, 1)))


def test_convert_droplet3d(tmp_path):
    raw_dir = tmp_path / "raw"
    raw_dir.mkdir()
    rng = np.random.default_rng(2)
    for i in range(4):
        vol = rng.integers(0, 256, (16, 16, 16), dtype=np.uint8)
        vol.tofile(str(raw_dir / f"v{i}.raw"))
    kw = dict(volume_shape=(16, 16, 16), downscale=4, train_frac=0.75)
    p_train, p_val = convert_droplet3d(str(raw_dir), str(tmp_path / "out"), **kw)
    q_train, q_val = jax_converters.convert_droplet3d(str(raw_dir), str(tmp_path / "ref"), **kw)
    train = _same_pkl(p_train, q_train)
    assert train.shape == (3, 4, 4, 4, 1)
    assert os.path.exists(p_val)
    _same_pkl(p_val, q_val)


def test_convert_fluidsimml(tmp_path):
    rng = np.random.default_rng(3)
    csv = tmp_path / "sim.csv"
    table = rng.normal(0, 1, (2 * 8 * 8, 3)).astype(np.float32)
    np.savetxt(str(csv), table, delimiter=",")
    out = convert_fluidsimml([str(csv)], str(tmp_path / "o"), grid=(8, 8))
    data = _same_pkl(out, jax_converters.convert_fluidsimml([str(csv)], str(tmp_path / "r"),
                                                            grid=(8, 8)))
    assert data.shape == (2, 8, 8, 3)
    # channel order converted to (density, dy, dx)
    np.testing.assert_allclose(data[0, 0, 0], table[0][[0, 2, 1]], atol=1e-6)


@pytest.mark.parametrize("convert", [convert_netcdf_2d, convert_netcdf_3d])
def test_netcdf_gated(convert):
    with pytest.raises(ImportError, match="netCDF4"):
        convert("/nonexistent.nc", "/tmp", "x")


def test_convert_5jets(tmp_path):
    """raw float32 .dat pairs → downsampled [T,D,H,W,4] pkl, equal to the
    reference converter's."""
    os.makedirs(tmp_path / "Velocity")
    os.makedirs(tmp_path / "Density")
    rng = np.random.default_rng(0)
    for step in (1000, 1010):
        vel = rng.normal(size=(128, 128, 128, 3)).astype(np.float32)
        rho = rng.uniform(size=(128, 128, 128)).astype(np.float32)
        vel.tofile(tmp_path / "Velocity" / f"ns_{step}_v.dat")
        rho.tofile(tmp_path / "Density" / f"ns_{step}_r.dat")
    out = convert_5jets(str(tmp_path), str(tmp_path / "jets3d.pkl"), downscale=4)
    arr = _same_pkl(out, jax_converters.convert_5jets(str(tmp_path), str(tmp_path / "r.pkl"),
                                                      downscale=4))
    assert arr.shape == (2, 32, 32, 32, 4)
    assert np.isfinite(arr).all()


def test_convert_5jets_missing_density(tmp_path):
    os.makedirs(tmp_path / "Velocity")
    vel = np.ones((128, 128, 128, 3), np.float32)
    vel.tofile(tmp_path / "Velocity" / "ns_5_v.dat")
    arr = _load(convert_5jets(str(tmp_path), str(tmp_path / "o.pkl"), downscale=8))
    # density falls back to |v| = sqrt(3)
    np.testing.assert_allclose(arr[..., 0], np.sqrt(3), rtol=1e-5)
    np.testing.assert_allclose(arr[..., 1:], 1.0 / 8, rtol=1e-5)


def _frames(seed: int, h: int = 32, w: int = 48, n: int = 3) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8) for _ in range(n)]
    # smooth the chroma so 4:2:0 subsampling loses little
    return [np.repeat(np.repeat(f[::2, ::2], 2, 0), 2, 1) for f in frames]


def test_yuv_io_roundtrip(tmp_path):
    """YUV420 write → read round-trips RGB to within chroma-subsample error."""
    frames = _frames(0)
    path = str(tmp_path / "seq.yuv")
    with yuv_io.YUVWriter(path) as w:
        for f in frames:
            w.write(f)
    with yuv_io.YUVReader(path, 32, 48) as r:
        for f in frames:
            got, ok = r.read()
            assert ok
            assert got.shape == (32, 48, 3)
            assert np.mean(np.abs(got.astype(int) - f.astype(int))) < 6.0
        _, ok = r.read()
        assert not ok
    with yuv_io.YUVReader(path, 32, 48) as r:  # seek path
        got2, ok = r.read(2)
        assert ok
        assert np.mean(np.abs(got2.astype(int) - frames[2].astype(int))) < 6.0


@pytest.mark.parametrize("from_rgb", [True, False])
def test_yuv_files_and_frames_equal_the_reference(tmp_path, from_rgb):
    """The same frames written by both writers give the same bytes; both
    readers give the same frames (RGB uint8, or YUV planes) from that file."""
    frames = _frames(5, n=4)
    ours, theirs = str(tmp_path / "a.yuv"), str(tmp_path / "b.yuv")
    for mod, path in ((yuv_io, ours), (jax_yuv_io, theirs)):
        with mod.YUVWriter(path, from_rgb=from_rgb) as w:
            for f in frames:
                w.write(f)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    with yuv_io.YUVReader(ours, 32, 48, to_rgb=from_rgb) as r, \
            jax_yuv_io.YUVReader(ours, 32, 48, to_rgb=from_rgb) as q:
        for i in (0, 3, 1):
            (got, ok), (want, ok2) = r.read(i), q.read(i)
            assert ok and ok2
            np.testing.assert_array_equal(got, want)


def test_color_matrices_equal_the_reference():
    x = np.random.default_rng(6).random((5, 7, 3))
    np.testing.assert_array_equal(yuv_io.rgb2yuv(x), jax_yuv_io.rgb2yuv(x))
    np.testing.assert_array_equal(yuv_io.yuv2rgb(x), jax_yuv_io.yuv2rgb(x))
    np.testing.assert_allclose(yuv_io.yuv2rgb(yuv_io.rgb2yuv(x)), x, atol=1e-12)
