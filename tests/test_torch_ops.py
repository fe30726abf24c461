"""PyTorch port: resize and SSIM against the JAX package.

Inputs are drawn with numpy from fixed seeds.  Tolerances:
- resize 1e-6: both sides interpolate between 2 taps per axis in float32;
- SSIM 1e-5 ('same', [0, 1] range) and 1e-4 (MATLAB protocol, 255 range):
  the variance terms E[x^2] - mu^2 cancel in float32, and the two sides sum
  the 11 taps in other fused orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowscivis_tpu.ops import resize as jresize
from opticalflowscivis_tpu.ops.ssim import ssim as jax_ssim
from opticalflowscivis_tpu.ops.ssim import ssim_matlab as jax_ssim_matlab
from opticalflowscivis_tpu_torch.ops import resize as tresize
from opticalflowscivis_tpu_torch.ops.ssim import ssim, ssim_matlab

SIZES = {"down4": (8, 12), "down2": (16, 24), "up2": (64, 96), "up4": (128, 192)}


@pytest.mark.parametrize("target", sorted(SIZES))
def test_resize_spatial_matches_jax(target):
    x = np.random.default_rng(0).uniform(0, 1, (2, 32, 48, 3)).astype(np.float32)
    ref = jresize.resize_spatial(jnp.asarray(x), SIZES[target])
    out = tresize.resize_spatial(torch.from_numpy(x), SIZES[target])
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("target", sorted(SIZES))
def test_resize_flow_matches_jax(target):
    """Flow values rescale per axis by the size ratio (anisotropic here)."""
    f = np.random.default_rng(1).standard_normal((2, 32, 48, 4)).astype(np.float32)
    h, w = SIZES[target]
    spatial = (h, w * 2) if target.startswith("up") else (h, w // 2)
    ref = jresize.resize_flow(jnp.asarray(f), spatial)
    out = tresize.resize_flow(torch.from_numpy(f), spatial)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_resize_like_and_identity():
    x = np.random.default_rng(2).uniform(0, 1, (1, 20, 30, 2)).astype(np.float32)
    ref = np.zeros((1, 10, 15, 1), np.float32)
    out = tresize.resize_like(torch.from_numpy(x), torch.from_numpy(ref))
    np.testing.assert_allclose(
        out.numpy(),
        np.asarray(jresize.resize_like(jnp.asarray(x), jnp.asarray(ref))),
        atol=1e-6,
    )
    same = torch.from_numpy(x)
    assert tresize.resize_spatial(same, (20, 30)).data_ptr() == same.data_ptr()
    np.testing.assert_allclose(
        tresize.resize_spatial(same, (10, 15), align_corners=True).numpy(),
        np.asarray(jresize.resize_spatial(jnp.asarray(x), (10, 15), align_corners=True)),
        atol=1e-5,
    )


@pytest.mark.parametrize("valid", [False, True])
def test_ssim_matches_jax(valid):
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (2, 24, 30, 2)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ref = float(jax_ssim(jnp.asarray(a), jnp.asarray(b), valid=valid))
    out = float(ssim(torch.from_numpy(a), torch.from_numpy(b), valid=valid))
    assert out == pytest.approx(ref, abs=1e-5)


def test_ssim_matlab_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 255, (1, 40, 52, 1)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 20, a.shape), 0, 255).astype(np.float32)
    ref = float(jax_ssim_matlab(jnp.asarray(a), jnp.asarray(b)))
    out = float(ssim_matlab(torch.from_numpy(a), torch.from_numpy(b)))
    assert out == pytest.approx(ref, abs=1e-4)
    assert float(ssim_matlab(torch.from_numpy(a), torch.from_numpy(a))) == pytest.approx(1.0, abs=1e-4)
