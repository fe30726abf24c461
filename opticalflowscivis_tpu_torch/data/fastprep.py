"""ctypes binding of the native fused dataset-prep engine (``csrc/fastprep.cpp``).

The counterpart of the reference package's ``data/fastprep.py``.  The C++
library at the repository root computes resample + flip-augment + tuple
grouping in one multithreaded pass, in place of about six transient numpy
copies of the series.  The result is bit-equal to
``group_tuples(flip_augment(temporal_resample(data)))`` (the tests hold it
there).

The source is read, never written: the library is built with ``g++`` at first
use into this package's git-ignored ``build/`` directory, under a name that
hashes the flags and the source, and written to a temporary file renamed into
place, so that concurrent first uses never load a torn library.  A failure to
build or to load raises; nothing falls back to numpy.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from opticalflowscivis_tpu_torch.ops.kernels.build import BUILD_DIR, PACKAGE_DIR

SOURCE = PACKAGE_DIR.parent / "csrc" / "fastprep.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")


def library_path() -> Path:
    """Where the library built from ``SOURCE`` with ``CXX_FLAGS`` lives."""
    if not SOURCE.exists():
        raise FileNotFoundError(f"fastprep source {SOURCE} is missing")
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfastprep-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/fastprep.cpp`` unless this source is built already;
    raises ``RuntimeError`` with the compiler's output when ``g++`` fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; it builds csrc/fastprep.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed (g++ exit {res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with its C signatures declared (built first if needed)."""
    lib = ctypes.CDLL(str(build()))
    lib.fastprep_tuples.restype = ctypes.c_int64
    lib.fastprep_tuples.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.fastprep_count.restype = ctypes.c_int64
    lib.fastprep_count.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    return lib


def prepare_tuples_native(
    data: np.ndarray,
    exp: int = 1,
    resample_stride: int = 3,
    flip_axes: int = 2,
    negate_flow: bool | None = None,
    n_threads: int = 0,
) -> np.ndarray:
    """Fused resample+flip+group: ``[T, *spatial, C] → [N, slots, *spatial, C]``.

    Equal to ``group_tuples(flip_augment(temporal_resample(data)))``, bit for
    bit.  Both 2-D ``[T, H, W, C]`` and 3-D ``[T, Z, Y, X, C]`` series; flips
    always mirror the first two spatial axes (the reference's behaviour in both
    ranks).  ``n_threads`` 0 lets the library pick.
    """
    data = np.ascontiguousarray(data, np.float32)
    if data.ndim not in (4, 5):
        raise ValueError(f"expected a [T, *spatial, C] series of 2 or 3 spatial dims, "
                         f"got shape {data.shape}")
    ndim = data.ndim - 2
    c_real = data.shape[-1]
    if negate_flow is None:
        negate_flow = c_real == 1 + ndim
    t, a, b_axis = data.shape[0], data.shape[1], data.shape[2]
    inner = int(np.prod(data.shape[3:]))  # trailing spatial axes x channels
    lib = load_library()
    n = int(lib.fastprep_count(t, flip_axes, exp))
    out = np.empty((n, 2**exp + 1) + data.shape[1:], np.float32)
    got = lib.fastprep_tuples(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        t, a, b_axis, inner, c_real, resample_stride, flip_axes, exp,
        int(negate_flow), n_threads,
    )
    if got != n:
        raise RuntimeError(f"fastprep returned {got} tuples, expected {n}")
    return out
