"""PyTorch port: the numpy data copies equal the JAX package's originals.

The port keeps its own copies of these numpy-only modules (importing the
originals would import jax); here they are pinned to them, bit for bit, on
fixed seeds.
"""

import pickle

import numpy as np
import pytest

from opticalflowscivis_tpu.data import pipeline as jpipe
from opticalflowscivis_tpu.data import registry as jreg
from opticalflowscivis_tpu.data import synthetic as jsyn
from opticalflowscivis_tpu_torch.data import pipeline as tpipe
from opticalflowscivis_tpu_torch.data import registry as treg
from opticalflowscivis_tpu_torch.data import synthetic as tsyn


@pytest.mark.parametrize("background", ["zero", "texture", "pan"])
def test_rectangle_2d_equals_reference(background):
    kw = {"n_frames": 12, "grid": (48, 64), "box": (20, 24), "seed": 3,
          "background": background}
    np.testing.assert_array_equal(tsyn.rectangle_2d(**kw), jsyn.rectangle_2d(**kw))


def test_rectangles_and_rectangle_3d_equal_reference():
    kw2 = {"n_frames": 8, "grid": (40, 48), "boxes": ((10, 12), (8, 6)), "seed": 1}
    np.testing.assert_array_equal(tsyn.rectangles_2d(**kw2), jsyn.rectangles_2d(**kw2))
    kw3 = {"n_frames": 4, "grid": (12, 14, 16), "box": (4, 5, 6), "seed": 2}
    np.testing.assert_array_equal(tsyn.rectangle_3d(**kw3), jsyn.rectangle_3d(**kw3))


@pytest.mark.parametrize("exp", [1, 2, 3])
def test_group_tuples_equals_reference(exp):
    data = np.random.default_rng(exp).random((29, 6, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(tpipe.group_tuples(data, exp), jpipe.group_tuples(data, exp))


@pytest.mark.parametrize("leading_axes", [1, 2])
def test_pad_to_multiple_equals_reference(leading_axes):
    data = np.random.default_rng(4).random((3, 2, 37, 50, 1)[2 - leading_axes:])
    out, pads = tpipe.pad_to_multiple(data, 32, leading_axes)
    ref, ref_pads = jpipe.pad_to_multiple(data, 32, leading_axes)
    np.testing.assert_array_equal(out, ref)
    assert pads == ref_pads


def test_normalize_resample_flip_equal_reference():
    data = np.random.default_rng(5).normal(size=(9, 6, 8, 3)).astype(np.float32)
    data[0, 0, 0, 0] = np.nan
    for fn, args in (("minmax_normalize", ()), ("temporal_resample", (3,)),
                     ("flip_augment", ()), ("flip_augment", (False, 1))):
        np.testing.assert_array_equal(
            getattr(tpipe, fn)(data, *args), getattr(jpipe, fn)(data, *args), err_msg=fn
        )


def test_load_raw_series_and_load_data_equal_reference(tmp_path):
    """A small cached ``rectangle2d.pkl`` goes through both registries."""
    series = jsyn.rectangle_2d(n_frames=40, grid=(32, 48), box=(12, 16), seed=0)
    with open(tmp_path / "rectangle2d.pkl", "wb") as f:
        pickle.dump(series, f, protocol=4)
    for which in ("train", "val", "test"):
        np.testing.assert_array_equal(
            treg.load_raw_series("rectangle2d", str(tmp_path), which),
            jreg.load_raw_series("rectangle2d", str(tmp_path), which),
        )
    out = treg.load_data("rectangle2d", exp=1, mode="test", data_dir=str(tmp_path),
                         use_cache=False)
    ref = jreg.load_data("rectangle2d", exp=1, mode="test", data_dir=str(tmp_path),
                         use_cache=False)
    np.testing.assert_array_equal(out, ref)
    assert treg.get_spec("rectangle2d").test == jreg.get_spec("rectangle2d").test
    assert sorted(treg.REGISTRY) == sorted(jreg.REGISTRY)


@pytest.mark.parametrize("seed", [0, 3])
def test_jets_3d_equals_reference(seed):
    kw = {"n_frames": 6, "grid": (16, 20, 24), "seed": seed}
    np.testing.assert_array_equal(tsyn.jets_3d(**kw), jsyn.jets_3d(**kw))
