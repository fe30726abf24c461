"""PyTorch port: the VGG19 perceptual loss against the JAX package's and the
reference's loop (``tests/test_perceptual.py``'s torch oracle), on one random
VGG19 state dict that both packages' ``params_from_torch_state_dict`` take.

32 x 32 frames, batch 2, float32 on the CPU.  Loss rtol 2e-5 and ``d/dx``
within 1e-4 of its largest element: float32 convolutions through 13 layers
summed in other orders.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn as tnn

from opticalflowscivis_tpu.losses import perceptual as jax_perceptual
from opticalflowscivis_tpu_torch.losses import vgg_perceptual_loss
from opticalflowscivis_tpu_torch.losses.perceptual import init_params, params_from_torch_state_dict

SHAPE = (2, 32, 32, 3)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers side by side: a few threads each keep
    the many small ops of these tests from fighting over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _torch_vgg19_features():
    """torchvision's ``vgg19().features`` layer layout, random init."""
    plan = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
            512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
    layers, c_in = [], 3
    for c in plan:
        if c == "M":
            layers.append(tnn.MaxPool2d(2, 2))
        else:
            layers.append(tnn.Conv2d(c_in, c, 3, padding=1))
            layers.append(tnn.ReLU(inplace=False))
            c_in = c
    return tnn.Sequential(*layers)


def _reference_loss(feats, x, y):
    """The reference's forward (Flow-2D/model/loss.py:108-120) with its
    MeanShift normalisation, NCHW."""
    mean = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
    X, Y = (x - mean) / std, (y - mean) / std
    indices = [2, 7, 12, 21, 30]
    weights = [1.0 / 2.6, 1.0 / 4.8, 1.0 / 3.7, 1.0 / 5.6, 10 / 1.5]
    k, loss = 0, 0.0
    for i in range(indices[-1]):
        X = feats[i](X)
        Y = feats[i](Y)
        if (i + 1) in indices:
            loss = loss + weights[k] * (X - Y.detach()).abs().mean() * 0.1
            k += 1
    return loss


@pytest.fixture(scope="module")
def vgg():
    torch.manual_seed(0)
    feats = _torch_vgg19_features().eval()
    return feats, feats.state_dict()


def _frames(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=shape).astype(np.float32) for _ in range(2)]


def test_perceptual_loss_and_grad_match_jax_and_the_reference(vgg):
    feats, state = vgg
    x, y = _frames(1)
    params = params_from_torch_state_dict(state, device="cpu")
    assert len(params) == 13 and params[0]["w"].shape == (64, 3, 3, 3)
    jparams = jax_perceptual.params_from_torch_state_dict(state)

    xt = torch.from_numpy(x).requires_grad_(True)
    loss = vgg_perceptual_loss(params, xt, torch.from_numpy(y))
    loss.backward()
    loss = loss.detach()
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda a: jax_perceptual.vgg_perceptual_loss(jparams, a, y)))(x)
    assert float(loss) == pytest.approx(float(jloss), rel=2e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               atol=1e-4 * float(np.abs(jgrad).max()), rtol=0)

    xr = torch.from_numpy(x).permute(0, 3, 1, 2).clone().requires_grad_(True)
    ref = _reference_loss(feats, xr, torch.from_numpy(y).permute(0, 3, 1, 2))
    ref.backward()
    ref = ref.detach()
    assert float(loss) == pytest.approx(float(ref), rel=2e-5)
    ref_grad = xr.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(xt.grad.numpy(), ref_grad,
                               atol=1e-4 * float(np.abs(ref_grad).max()), rtol=0)


def test_full_vgg19_state_dict_keys_load(vgg):
    """A whole ``vgg19`` state dict carries ``features.`` prefixes."""
    _, state = vgg
    full = {f"features.{k}": v for k, v in state.items()}
    full["classifier.0.weight"] = torch.zeros(4, 4)
    a = params_from_torch_state_dict(state, device="cpu")
    b = params_from_torch_state_dict(full, device="cpu")
    assert all(torch.equal(p["w"], q["w"]) and torch.equal(p["b"], q["b"]) for p, q in zip(a, b))
    with pytest.raises(KeyError):
        params_from_torch_state_dict({}, device="cpu")


def test_grey_input_is_tiled_and_y_gets_no_gradient(vgg):
    _, state = vgg
    params = params_from_torch_state_dict(state, device="cpu")
    x, y = _frames(2, (1, 32, 32, 1))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    loss = vgg_perceptual_loss(params, xt, yt)
    tiled = vgg_perceptual_loss(params, torch.from_numpy(x).repeat(1, 1, 1, 3),
                                torch.from_numpy(y).repeat(1, 1, 1, 3))
    loss.backward()
    loss = loss.detach()
    assert float(loss) == pytest.approx(float(tiled), rel=1e-6)
    assert yt.grad is None or float(yt.grad.abs().max()) == 0.0
    assert float(xt.grad.abs().max()) > 0
    jloss = jax_perceptual.vgg_perceptual_loss(
        jax_perceptual.params_from_torch_state_dict(state), x, y)
    assert float(loss) == pytest.approx(float(jloss), rel=2e-5)


def test_init_params_identical_inputs_give_zero_loss():
    params = init_params(seed=0, device="cpu")
    assert [p["w"].shape[0] for p in params] == [64, 64, 128, 128, 256, 256, 256, 256,
                                                 512, 512, 512, 512, 512]
    x = torch.from_numpy(_frames(3, (1, 32, 32, 1))[0])
    # zero up to float32 rounding: the two feature passes are separate calls
    assert float(vgg_perceptual_loss(params, x, x)) < 1e-7
    again = init_params(seed=0, device="cpu")
    assert all(torch.equal(p["w"], q["w"]) for p, q in zip(params, again))
