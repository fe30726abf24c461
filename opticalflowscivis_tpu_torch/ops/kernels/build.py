"""Build the package's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/lib<name>-<hash>.so`` inside this package (the directory is
git-ignored); the hash is of the flags, the source and the headers beside it
(``csrc/*.cuh``), so an edited source or header rebuilds.  ``nvcc``'s output,
with ptxas's registers and spills of each kernel, is kept beside the library
as ``lib<name>-<hash>.log`` (``ptxas_log``).
Builds happen at first use, so running ``chip_smoke.py`` alone builds every
kernel; ``build`` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU-only test host has no ``nvcc``.
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

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError(f"nvcc not found on PATH or at {default}")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, Path]:
    """Compile each named source not yet built, all ``nvcc`` runs in parallel.

    Each output is written to a temporary file and renamed into place, so a
    concurrent build of the same source never leaves a torn library.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name) for name in names}
    jobs = []
    for name, so in paths.items():
        if so.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        jobs.append((name, so, tmp, proc))
    failures = []
    for name, so, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            so.with_suffix(".log").write_bytes(log)
            os.replace(tmp, so)
        else:
            os.unlink(tmp)
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log.decode(errors='replace')}")
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def ptxas_log(name: str) -> str:
    """``nvcc``'s output from the build of ``csrc/<name>.cu`` (built first if
    needed): ptxas's registers, spills and shared memory of each kernel."""
    return build([name])[name].with_suffix(".log").read_text(errors="replace")


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    return ctypes.CDLL(str(build([name])[name]))
