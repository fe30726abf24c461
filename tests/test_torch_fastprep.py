"""PyTorch port: the native fastprep binding against the numpy pipeline, bit
for bit — the twins of ``tests/test_fastprep.py`` — and the JAX package's
binding on the same inputs; a build that fails raises, and the build writes
nothing beside the C++ source."""

import numpy as np
import pytest

from opticalflowscivis_tpu.data.fastprep import prepare_tuples_native as jax_prepare_tuples
from opticalflowscivis_tpu.data.registry import _prepare as jax_prepare
from opticalflowscivis_tpu.data.registry import get_spec as jax_get_spec
from opticalflowscivis_tpu_torch.data import (
    flip_augment,
    group_tuples,
    rectangle_2d,
    rectangle_3d,
    temporal_resample,
)
from opticalflowscivis_tpu_torch.data import fastprep
from opticalflowscivis_tpu_torch.data.fastprep import prepare_tuples_native
from opticalflowscivis_tpu_torch.data.registry import _prepare, _split_or_fraction, get_spec


@pytest.mark.parametrize("exp", [1, 2])
def test_native_matches_numpy(exp):
    arr = rectangle_2d(n_frames=99, grid=(32, 32), box=(10, 14), seed=1)
    ref = group_tuples(flip_augment(temporal_resample(arr, 3)), exp)
    out = prepare_tuples_native(arr, exp=exp, resample_stride=3, flip_axes=2)
    assert np.array_equal(ref, out)
    assert np.array_equal(out, jax_prepare_tuples(arr, exp=exp, resample_stride=3, flip_axes=2))


def test_native_no_aug_no_resample():
    arr = rectangle_2d(n_frames=30, grid=(16, 16), box=(6, 8), seed=2)
    ref = group_tuples(arr, 1)
    out = prepare_tuples_native(arr, exp=1, resample_stride=1, flip_axes=0)
    assert np.array_equal(ref, out)


def test_native_single_channel():
    arr = rectangle_2d(n_frames=45, grid=(16, 16), box=(6, 8), seed=3)[..., :1]
    ref = group_tuples(flip_augment(temporal_resample(arr, 3)), 1)
    out = prepare_tuples_native(arr, exp=1)
    assert np.array_equal(ref, out)


def test_registry_prepare_native_equals_numpy():
    """The registry's ``_prepare`` takes the native path; it equals the numpy
    pipeline on the same split, and the JAX package's ``_prepare``."""
    spec = get_spec("rectangle2d")
    arr = rectangle_2d(n_frames=99, grid=(32, 32), box=(10, 14), seed=4)
    native = _prepare(spec, arr, [(0, 99)], 1, augment=True)
    sub = _split_or_fraction(arr, [(0, 99)], "train")
    ref = group_tuples(flip_augment(temporal_resample(sub, spec.resample_stride)), 1)
    assert np.array_equal(native, ref)
    theirs = jax_prepare(jax_get_spec("rectangle2d"), arr, [(0, 99)], 1, augment=True)
    assert np.array_equal(native, theirs)


def test_native_3d_matches_numpy():
    vol = rectangle_3d(n_frames=60, grid=(16, 16, 16), box=(6, 8, 6), seed=7)
    ref = group_tuples(flip_augment(vol), 1)  # 3-D path: no temporal resample
    out = prepare_tuples_native(vol, resample_stride=1, flip_axes=2)
    assert np.array_equal(ref, out)


def test_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output; no
    library is left behind and nothing falls back to numpy."""
    bad = tmp_path / "fastprep.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(fastprep, "SOURCE", bad)
    monkeypatch.setattr(fastprep, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
        fastprep.build()
    assert list((tmp_path / "build").iterdir()) == []
    monkeypatch.setattr(fastprep, "SOURCE", tmp_path / "missing.cpp")
    with pytest.raises(FileNotFoundError):
        fastprep.build()


def test_build_writes_nothing_under_csrc(tmp_path, monkeypatch):
    """The library is built into the package's build directory (here a fresh
    one), named by the hash of the flags and the source; ``csrc/`` keeps its
    files and their times (but for ``libfastprep.so``, which the JAX
    package's binding builds there, maybe in another test worker)."""
    csrc = fastprep.SOURCE.parent

    def listing():
        return {p.name: p.stat().st_mtime_ns for p in csrc.iterdir()
                if p.name != "libfastprep.so"}

    before = listing()
    monkeypatch.setattr(fastprep, "BUILD_DIR", tmp_path / "build")
    so = fastprep.build()
    assert so.parent == tmp_path / "build" and so.name.startswith("libfastprep-")
    assert listing() == before
    assert fastprep.build() == so  # built once
