"""PyTorch port: the cost volume's plain version against the JAX package.

The same numpy-drawn feature maps go through
``opticalflowscivis_tpu.ops.correlation._cost_volume_jnp``, through the Pallas
kernel ``cost_volume_pallas`` under ``pltpu.force_tpu_interpret_mode()`` (as
``tests/test_pallas_kernels.py`` runs it on the CPU) and through the port's
``cost_volume_plain``, the oracle of the Hopper kernel in ``csrc/corr.cu``.

Tolerances: values 1e-5 (float32 sums of C products in another order),
gradients 1e-4 of the largest gradient (sums of up to (2 md + 1)^2 terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opticalflowscivis_tpu.ops.correlation import _cost_volume_jnp
from opticalflowscivis_tpu.ops.pallas.correlation import cost_volume_pallas
from opticalflowscivis_tpu_torch.ops import cost_volume, cost_volume_plain
from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES
from opticalflowscivis_tpu_torch.ops.kernels.correlation import cost_volume_kernel

VAL_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers side by side: a few threads each keep
    the many small ops of these tests from fighting over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _features(seed, shape):
    """Two channels-last feature maps ``[B, *S, C]`` and a gradient seed for
    the cost volume, float32."""
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal(shape).astype(np.float32)
    f2 = rng.standard_normal(shape).astype(np.float32)
    return f1, f2


def _first(x):  # channels-last numpy → channels-first tensor
    return torch.from_numpy(x).movedim(-1, 1)


def _last(t):  # channels-first tensor → channels-last numpy
    return t.detach().movedim(1, -1).numpy()


def _grads(f1, f2, md, g):
    """(df1, df2) of sum(cost_volume * g) in both packages, channels-last numpy."""
    a, b = _first(f1).requires_grad_(True), _first(f2).requires_grad_(True)
    (cost_volume_plain(a, b, md) * _first(g)).sum().backward()
    ref = jax.grad(lambda x, y: jnp.sum(_cost_volume_jnp(x, y, md) * g), argnums=(0, 1))(f1, f2)
    return (_last(a.grad), _last(b.grad)), tuple(np.asarray(r) for r in ref)


@pytest.mark.parametrize("shape, md", [
    ((2, 8, 12, 5), 4), ((1, 7, 11, 13), 2), ((2, 5, 4, 3), 1), ((1, 4, 13, 6), 0),
    ((1, 6, 8, 3), 5), ((1, 5, 6, 7, 3), 1),
], ids=["md4", "odd_md2", "md1", "md0", "md5_beyond_the_plane", "3d_md1"])
def test_plain_cost_volume_matches_jnp_values_and_gradients(shape, md):
    f1, f2 = _features(len(shape) * 10 + md, shape)
    out = cost_volume_plain(_first(f1), _first(f2), md)
    ref = np.asarray(_cost_volume_jnp(f1, f2, md))
    assert out.shape == (shape[0], (2 * md + 1) ** (len(shape) - 2)) + shape[1:-1]
    np.testing.assert_allclose(_last(out), ref, atol=VAL_TOL)
    g = np.random.default_rng(1).standard_normal(ref.shape).astype(np.float32)
    ours, theirs = _grads(f1, f2, md, g)
    for got, want in zip(ours, theirs):
        np.testing.assert_allclose(got, want, atol=GRAD_TOL * np.abs(want).max())


@pytest.mark.parametrize("shape, md", [((2, 16, 24, 8), 4), ((1, 8, 16, 5), 2)],
                         ids=["md4", "md2"])
def test_plain_cost_volume_matches_the_pallas_kernel_in_interpret_mode(shape, md):
    """The TPU kernel itself, values and its jnp VJP."""
    f1, f2 = _features(7, shape)
    g = np.random.default_rng(2).standard_normal(
        shape[:-1] + ((2 * md + 1) ** 2,)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(cost_volume_pallas(f1, f2, md))
        dref = jax.grad(lambda x, y: jnp.sum(cost_volume_pallas(x, y, md) * g),
                        argnums=(0, 1))(f1, f2)
    np.testing.assert_allclose(_last(cost_volume_plain(_first(f1), _first(f2), md)), ref,
                               atol=VAL_TOL)
    a, b = _first(f1).requires_grad_(True), _first(f2).requires_grad_(True)
    (cost_volume_plain(a, b, md) * _first(g)).sum().backward()
    for got, want in zip((a.grad, b.grad), dref):
        want = np.asarray(want)
        np.testing.assert_allclose(_last(got), want, atol=GRAD_TOL * np.abs(want).max())


def test_argmax_of_the_cost_volume_finds_a_known_shift():
    """f2 is f1 moved by (dy, dx) = (2, -1): the best displacement of every
    interior pixel is k = (2 + md) * (2 md + 1) + (-1 + md)."""
    md = 3
    rng = np.random.default_rng(3)
    f1 = rng.standard_normal((1, 64, 20, 20)).astype(np.float32)
    f2 = np.roll(f1, (2, -1), axis=(2, 3))
    out = cost_volume_plain(torch.from_numpy(f1), torch.from_numpy(f2), md)
    best = out[0, :, 5:-5, 5:-5].argmax(dim=0)
    assert bool((best == (2 + md) * (2 * md + 1) + (-1 + md)).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_on_cpu_runs_the_plain_version(dtype):
    """CPU tensors launch nothing; channels-last strides are taken as they
    are; bf16 features give a bf16 volume from float32 sums."""
    dt = getattr(torch, dtype)
    f1, f2 = _features(4, (2, 9, 11, 6))
    a = torch.from_numpy(f1).movedim(-1, 1).to(dt)  # a channels-last view
    b = torch.from_numpy(f2).movedim(-1, 1).to(dt).contiguous()
    before = dict(LAUNCHES)
    out = cost_volume_kernel(a, b, 2)
    assert LAUNCHES == before
    assert out.dtype == dt and out.shape == (2, 25, 9, 11)
    ref = cost_volume_plain(a.float(), b.float(), 2)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                               atol=VAL_TOL if dt == torch.float32 else 2e-2)
    # the public channels-last form goes the same way
    pub = cost_volume(a.movedim(1, -1), b.movedim(1, -1), 2)
    assert pub.shape == (2, 9, 11, 25)
    assert torch.equal(pub.movedim(-1, 1), out)


def test_public_cost_volume_takes_volumes_through_the_plain_version():
    f1, f2 = _features(5, (1, 4, 5, 6, 3))
    out = cost_volume(torch.from_numpy(f1), torch.from_numpy(f2), 1)
    assert out.shape == (1, 4, 5, 6, 27)
    np.testing.assert_allclose(out.numpy(), np.asarray(_cost_volume_jnp(f1, f2, 1)),
                               atol=VAL_TOL)


@pytest.mark.parametrize("kwargs, error", [
    ({"md": -1}, ValueError),
    ({"md": 1.5}, ValueError),
    ({"shape2": (2, 3, 9, 10)}, ValueError),
    ({"shape1": (2, 3, 9, 11, 4), "shape2": (2, 3, 9, 11, 4)}, ValueError),
], ids=["negative_md", "float_md", "shape_mismatch", "volume"])
def test_wrapper_rejects_what_it_does_not_take(kwargs, error):
    f1 = torch.zeros(kwargs.get("shape1", (2, 3, 9, 11)))
    f2 = torch.zeros(kwargs.get("shape2", (2, 3, 9, 11)))
    with pytest.raises(error):
        cost_volume_kernel(f1, f2, kwargs.get("md", 2))
    with pytest.raises(ValueError):
        cost_volume_plain(torch.zeros(2, 3, 4, 4), torch.zeros(2, 3, 4, 5), 1)
