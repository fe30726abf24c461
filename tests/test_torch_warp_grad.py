"""PyTorch port: gradients of the plain bounded warp (the Hopper backward
kernel's plain version) against the JAX package.

``r > 0`` is held against ``jax.grad`` of ``backward_warp_pallas`` in
interpret mode, ``r = 0`` against ``ops.warp.backward_warp``.  Inputs are
drawn with numpy from fixed seeds.  Flows lie beyond ±r in places, and one
case puts flows exactly on ±r, where the gradient must vanish as beyond it.
Zeros-mode flows are kept off integers: the in-bounds weight is piecewise
linear and both sides pick their own subgradient at its kinks.

Tolerance 1e-4 absolute on gradients of sum(out²) with out in [0, 1]: the
image gradient sums up to a few dozen contributions per source pixel in
another order (as ``tests/test_fast_warp.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opticalflowscivis_tpu.ops.pallas.warp import backward_warp_pallas
from opticalflowscivis_tpu.ops.warp import backward_warp as jax_backward_warp
from opticalflowscivis_tpu_torch.ops import warp as tw
from opticalflowscivis_tpu_torch.ops.kernels.warp import warp2d

GRAD_TOL = 1e-4
R = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small torch ops; with several test workers on one
    machine the intra-op thread pools oversubscribe the cores and such loops
    slow down a hundredfold.  One thread per worker is the fastest setting."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, c, on_bound=False):
    rng = np.random.default_rng(seed)
    shape = (2, 16, 32)
    img = rng.uniform(0, 1, shape + (c,)).astype(np.float32)
    # off-integer flows, a good share beyond ±R
    flow = np.round(rng.standard_normal(shape + (2,)) * 6.0) + 0.21
    flow = flow.astype(np.float32)
    if on_bound:
        flow[:, :, 0:8, 0] = R
        flow[:, :, 8:16, 1] = -R
    return img, flow


def _torch_grads(fn, img, flow):
    ti = torch.from_numpy(img).requires_grad_()
    tf = torch.from_numpy(flow).requires_grad_()
    (fn(ti, tf) ** 2).sum().backward()
    return ti.grad.numpy(), tf.grad.numpy()


@pytest.mark.parametrize("on_bound", [False, True], ids=["beyond_r", "on_r"])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_bounded_warp_grads_match_pallas_interpret(padding, c, on_bound):
    img, flow = _inputs(11 + c, c, on_bound)
    assert (np.abs(flow) > R).any()
    with pltpu.force_tpu_interpret_mode():
        gi_ref, gf_ref = jax.grad(
            lambda im, fl: jnp.sum(backward_warp_pallas(im, fl, R, padding) ** 2), (0, 1)
        )(jnp.asarray(img), jnp.asarray(flow))
    gi, gf = _torch_grads(lambda i, f: tw.backward_warp_bounded(i, f, R, padding), img, flow)
    np.testing.assert_allclose(gi, np.asarray(gi_ref), atol=GRAD_TOL)
    np.testing.assert_allclose(gf, np.asarray(gf_ref), atol=GRAD_TOL)
    clamped = np.abs(flow) >= R
    assert (gf[clamped] == 0).all()  # on the bound as beyond it
    assert (gf[~clamped] != 0).any()


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_unbounded_warp_grads_match_jax(padding, c):
    img, flow = _inputs(21 + c, c)
    gi_ref, gf_ref = jax.grad(
        lambda im, fl: jnp.sum(jax_backward_warp(im, fl, padding=padding) ** 2), (0, 1)
    )(jnp.asarray(img), jnp.asarray(flow))
    gi, gf = _torch_grads(lambda i, f: tw.backward_warp_bounded(i, f, 0, padding), img, flow)
    np.testing.assert_allclose(gi, np.asarray(gi_ref), atol=GRAD_TOL)
    np.testing.assert_allclose(gf, np.asarray(gf_ref), atol=GRAD_TOL)


@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_wrapper_on_cpu_backpropagates_through_the_plain_version(padding):
    """``warp2d`` on CPU tensors (NCHW, flow a channel slice) gives the
    gradients of the channels-last plain warp."""
    img, flow = _inputs(31, 3)
    gi_ref, gf_ref = _torch_grads(lambda i, f: tw.backward_warp_bounded(i, f, R, padding),
                                  img, flow)
    ti = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous().requires_grad_()
    flow4 = torch.from_numpy(np.concatenate([flow * 0.5, flow], -1)).permute(0, 3, 1, 2)
    flow4 = flow4.contiguous().requires_grad_()
    (warp2d(ti, flow4[:, 2:4], R, padding) ** 2).sum().backward()
    np.testing.assert_allclose(ti.grad.permute(0, 2, 3, 1).numpy(), gi_ref, atol=0)
    np.testing.assert_allclose(flow4.grad[:, 2:4].permute(0, 2, 3, 1).numpy(), gf_ref, atol=0)
    assert (flow4.grad[:, :2] == 0).all()
