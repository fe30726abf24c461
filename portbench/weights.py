"""Seeded weights: one state dict for the program and the reference alike,
drawn on the device in one call from a ``torch.Generator`` seeded with the
run's seed.  Conv and transposed-conv kernels are LeCun-normal (standard
deviation sqrt(1 / fan-in) over a unit normal cut at +-2, as flax's
initialiser scales it), biases 0, PReLU slopes 0.25: the program's own
initial distribution."""

from __future__ import annotations

import math

import torch
from torch import nn

_TRUNC_STD = 0.87962566103423978  # std of a unit normal cut at +-2


def seeded_state(model: nn.Module, seed: int, device) -> dict[str, torch.Tensor]:
    """A state dict with ``model``'s names and shapes (``model`` may live on
    the meta device), float32 on ``device``."""
    fan_in = {}
    for name, m in model.named_modules():
        if isinstance(m, nn.modules.conv._ConvNd):
            w = m.weight
            cin = w.shape[0] if m.transposed else w.shape[1]
            fan_in[f"{name}.weight"] = cin * math.prod(w.shape[2:])
    params = list(model.named_parameters())
    n = sum(p.numel() for name, p in params if name in fan_in)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    draws = torch.randn(n, generator=gen, device=device).clamp_(-2.0, 2.0)
    state, at = {}, 0
    for name, p in params:
        if name in fan_in:
            k = p.numel()
            std = math.sqrt(1.0 / fan_in[name]) / _TRUNC_STD
            state[name] = (draws[at:at + k] * std).view(p.shape)
            at += k
        elif name.endswith(".slope"):
            state[name] = torch.full(p.shape, 0.25, device=device)
        else:
            state[name] = torch.zeros(p.shape, device=device)
    return state
