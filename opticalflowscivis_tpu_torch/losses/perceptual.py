"""VGG19 perceptual loss.

Counterpart of ``opticalflowscivis_tpu/losses/perceptual.py``: ImageNet
mean / std normalisation, the torchvision ``vgg19().features`` prefix up to
relu5_1, and L1 feature distances after the ReLUs of convs 0, 2, 4, 8 and 12
(relu1_1, relu2_1, relu3_1, relu4_1, relu5_1) with weights
``1/2.6, 1/4.8, 1/3.7, 1/5.6, 10/1.5`` and the global factor 0.1.  The
features of ``y`` are constants (detached).

No weights are downloaded: ``params_from_torch_state_dict`` takes a locally
available torchvision ``vgg19`` state dict, ``init_params`` draws random ones
(tests, architecture-only use).  Params are a list of ``{"w": [O, I, 3, 3],
"b": [O]}``, one per conv of the prefix.  The convs are ``F.conv2d`` (cuDNN on
the card): the reference computes them outside any Pallas kernel too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from opticalflowscivis_tpu_torch.device import resolve_device

# torchvision vgg19 "features" conv plan: channels per conv, "M" = maxpool;
# only the prefix up to layer index 29 (relu5_1) takes part in the loss
_VGG19_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
               512, 512, 512, 512, "M", 512)

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

# the convs (counting convs only) whose ReLU is tapped: torchvision layer
# indices 2, 7, 12, 21, 30 are the ReLUs after convs 0, 2, 4, 8, 12
_TAP_AFTER_CONV = (0, 2, 4, 8, 12)
_TAP_WEIGHTS = (1.0 / 2.6, 1.0 / 4.8, 1.0 / 3.7, 1.0 / 5.6, 10.0 / 1.5)


def _convs():
    c_in = 3
    for c in _VGG19_PLAN:
        if c != "M":
            yield c_in, c
            c_in = c


def init_params(seed: int = 0, dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None) -> list[dict]:
    """Random conv params of the tapped VGG19 prefix, He-scaled, from ``seed``."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = []
    for c_in, c in _convs():
        w = torch.randn((c, c_in, 3, 3), generator=gen) * math.sqrt(2.0 / (9 * c_in))
        params.append({"w": w.to(device, dtype), "b": torch.zeros(c, dtype=dtype, device=device)})
    return params


def params_from_torch_state_dict(sd, device: str | torch.device | None = None) -> list[dict]:
    """Params from torchvision's ``vgg19().features.state_dict()`` (or a full
    ``vgg19`` state dict, whose keys carry a ``features.`` prefix)."""
    device = resolve_device(device)

    def get(name):
        for key in (name, f"features.{name}"):
            if key in sd:
                return torch.as_tensor(sd[key]).detach().to(device, torch.float32)
        raise KeyError(name)

    params, layer = [], 0
    for c in _VGG19_PLAN:
        if c == "M":
            layer += 1
            continue
        params.append({"w": get(f"{layer}.weight"), "b": get(f"{layer}.bias")})
        layer += 2  # conv + relu
    return params


def _features(params: list[dict], x: torch.Tensor) -> list[torch.Tensor]:
    """The VGG19 prefix on ``[B, 3, H, W]``: the tapped activations."""
    taps = []
    conv_i = 0
    for c in _VGG19_PLAN:
        if c == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        p = params[conv_i]
        x = F.relu(F.conv2d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), padding=1))
        if conv_i in _TAP_AFTER_CONV:
            taps.append(x)
            if conv_i == _TAP_AFTER_CONV[-1]:
                break
        conv_i += 1
    return taps


def vgg_perceptual_loss(params: list[dict], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """L1 feature-distance loss of channels-last ``x, y [B, H, W, C]`` in
    [0, 1]; single-channel inputs are tiled to RGB.  No gradient flows into ``y``."""
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], 3)
        y = y.expand(*y.shape[:-1], 3)
    mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    fx = _features(params, (x.movedim(-1, 1) - mean) / std)
    fy = _features(params, (y.detach().movedim(-1, 1) - mean) / std)
    loss = x.new_zeros(())
    for w, a, b in zip(_TAP_WEIGHTS, fx, fy):
        loss = loss + w * (a - b.detach()).abs().mean() * 0.1
    return loss
