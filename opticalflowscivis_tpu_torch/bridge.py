"""Weights bridge: the reference's flax params → this port's ``state_dict``s.

``ifnet_params_from_flax(tree)`` takes the params as a nested dict of numpy
arrays (``{"params": {...}}`` or the inner dict) and returns a ``state_dict``
for ``models.ifnet.IFNet``:

- conv kernels HWIO → OIHW (3-D: DHWIO → OIDHW);
- transposed-conv kernels HWIO → IOHW (3-D: DHWIO → IODHW) plus a flip of
  every spatial axis (flax ``ConvTranspose`` does not flip its kernel, torch's
  transposed conv does);
- biases as they are, PReLU ``slope`` as they are.

Flax module paths (as ``models/ifnet_hd.py:111-126`` of the reference lists
them) map to torch keys as follows, per block (``block{i}`` or ``block_tea``):

| flax                                   | torch                         |
| -------------------------------------- | ----------------------------- |
| ``ConvPReLU_{k}/Conv_0``               | ``conv0.{k}.conv``            |
| ``ConvPReLU_{k}/PReLU_0``              | ``conv0.{k}.prelu``           |
| ``ResConvBlock_{j}/ConvPReLU_{k}/...`` | ``convblock.{j}.convs.{k}...``|
| ``DeconvPReLU_0/ConvTranspose_0``      | ``flow_head.up.deconv``       |
| ``DeconvPReLU_0/PReLU_0``              | ``flow_head.up.prelu``        |
| ``ConvTranspose_0``                    | ``flow_head.out``             |
| ``DeconvPReLU_1/...``, ``ConvTranspose_1`` | ``mask_head.up...``, ``mask_head.out`` |

and for the refinement of ``IFNet(refine=True)`` (``models/refine.py``):

| flax                                                | torch                              |
| --------------------------------------------------- | ---------------------------------- |
| ``contextnet/Conv2_{i}/ConvPReLU_{j}/Conv_0``       | ``contextnet.conv{i+1}.conv{j+1}.conv`` |
| ``contextnet/Conv2_{i}/ConvPReLU_{j}/PReLU_0``      | ``contextnet.conv{i+1}.conv{j+1}.prelu`` |
| ``unet/Conv2_{i}/ConvPReLU_{j}/...``                | ``unet.down{i}.conv{j+1}...``      |
| ``unet/DeconvPReLU_{i}/ConvTranspose_0``            | ``unet.up{i}.deconv``              |
| ``unet/DeconvPReLU_{i}/PReLU_0``                    | ``unet.up{i}.prelu``               |
| ``unet/Conv_0``                                     | ``unet.conv``                      |

``conv_stack_params_from_flax(tree)`` takes the params of a flax
``nn.Sequential(conv_stack(...))`` (``layers_{i}/Conv_0``, ``layers_{i}/PReLU_0``)
and returns a ``state_dict`` for ``nn.Sequential(*models.layers.conv_stack(...))``
(``{i}.conv``, ``{i}.prelu``).

``upflow_params_from_flax(tree)`` does the same for ``models.upflow.UPFlowNet``
(conv kernels HWIO → OIHW, biases as they are).  Flax names its
``nn.compact`` children ``ConvLeaky_{k}/Conv_0`` in call order:

| flax                                              | torch                                        |
| ------------------------------------------------- | -------------------------------------------- |
| ``FeatureExtractor_0/ConvLeaky_{k}/Conv_0``       | ``feature_extractor.convs.{k}.conv``         |
| ``conv_1x1_{l}/Conv_0``                           | ``conv_1x1.{l}.conv``                        |
| ``flow_estimators/ConvLeaky_{k}/Conv_0``          | ``flow_estimators.convs.{k}.conv``           |
| ``context_networks/ConvLeaky_{k}/Conv_0``         | ``context_networks.convs.{k}.conv``          |
| ``sgi_model/dense_estimator_mask/ConvLeaky_{k}/Conv_0`` | ``sgi_model.dense_estimator_mask.convs.{k}.conv`` |
| ``sgu_output_conv/ConvLeaky_{k}/Conv_0``          | ``sgu_output_conv.convs.{k}.conv``           |

Every flax leaf is used exactly once; an unknown path or a collision raises.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_LEAF = {"kernel": "weight", "bias": "bias", "slope": "slope"}

_MODULE_RULES = [
    (re.compile(r"^ConvPReLU_(\d+)/Conv_0$"), r"conv0.\1.conv"),
    (re.compile(r"^ConvPReLU_(\d+)/PReLU_0$"), r"conv0.\1.prelu"),
    (re.compile(r"^ResConvBlock_(\d+)/ConvPReLU_(\d+)/Conv_0$"), r"convblock.\1.convs.\2.conv"),
    (re.compile(r"^ResConvBlock_(\d+)/ConvPReLU_(\d+)/PReLU_0$"), r"convblock.\1.convs.\2.prelu"),
    (re.compile(r"^DeconvPReLU_0/ConvTranspose_0$"), "flow_head.up.deconv"),
    (re.compile(r"^DeconvPReLU_0/PReLU_0$"), "flow_head.up.prelu"),
    (re.compile(r"^ConvTranspose_0$"), "flow_head.out"),
    (re.compile(r"^DeconvPReLU_1/ConvTranspose_0$"), "mask_head.up.deconv"),
    (re.compile(r"^DeconvPReLU_1/PReLU_0$"), "mask_head.up.prelu"),
    (re.compile(r"^ConvTranspose_1$"), "mask_head.out"),
]

_BLOCK = re.compile(r"^(block\d+|block_tea)$")


def _next(m: re.Match, group: int) -> str:
    return str(int(m.group(group)) + 1)


_CONV2 = r"ConvPReLU_(\d+)/(Conv|PReLU)_0$"
_LAYER = {"Conv": "conv", "PReLU": "prelu"}
_REFINE_RULES = {
    "contextnet": [
        (re.compile(r"^Conv2_(\d+)/" + _CONV2),
         lambda m: f"conv{_next(m, 1)}.conv{_next(m, 2)}.{_LAYER[m.group(3)]}"),
    ],
    "unet": [
        (re.compile(r"^Conv2_(\d+)/" + _CONV2),
         lambda m: f"down{m.group(1)}.conv{_next(m, 2)}.{_LAYER[m.group(3)]}"),
        (re.compile(r"^DeconvPReLU_(\d+)/ConvTranspose_0$"), lambda m: f"up{m.group(1)}.deconv"),
        (re.compile(r"^DeconvPReLU_(\d+)/PReLU_0$"), lambda m: f"up{m.group(1)}.prelu"),
        (re.compile(r"^Conv_0$"), lambda m: "conv"),
    ],
}


def _flatten(tree: Mapping, prefix: tuple = ()) -> list[tuple[tuple, np.ndarray]]:
    leaves = []
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            leaves.extend(_flatten(value, path))
        else:
            leaves.append((path, np.asarray(value, np.float32)))
    return leaves


def _torch_key(path: tuple) -> str:
    block, *module, leaf = path
    module = "/".join(module)
    if leaf not in _LEAF:
        raise KeyError(f"unmapped flax leaf {'/'.join(path)}")
    for pattern, repl in _REFINE_RULES.get(block, []):
        m = pattern.match(module)
        if m:
            return f"{block}.{repl(m)}.{_LEAF[leaf]}"
    if not _BLOCK.match(block):
        raise KeyError(f"unmapped flax leaf {'/'.join(path)}")
    for pattern, repl in _MODULE_RULES:
        if pattern.match(module):
            return f"{block}.{pattern.sub(repl, module)}.{_LEAF[leaf]}"
    raise KeyError(f"unmapped flax leaf {'/'.join(path)}")


def _convert(path: tuple, arr: np.ndarray) -> np.ndarray:
    if path[-1] != "kernel":
        return arr
    if arr.ndim not in (4, 5):
        raise ValueError(f"{'/'.join(path)}: expected a 2-D or 3-D conv kernel, got {arr.shape}")
    nd = arr.ndim - 2
    spatial = tuple(range(nd))
    if "ConvTranspose" in path[-2]:
        # [*k, I, O] → [I, O, *k], taps flipped on every spatial axis (torch's
        # transposed conv flips, flax's does not)
        moved = arr.transpose((nd, nd + 1) + spatial)
        return np.flip(moved, axis=tuple(range(2, 2 + nd))).copy()
    return arr.transpose((nd + 1, nd) + spatial).copy()  # [*k, I, O] → [O, I, *k]


def ifnet_params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Convert flax ``IFNet`` params (nested numpy dict) to a torch ``state_dict``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(tree):
        key = _torch_key(path)
        if key in state:
            raise KeyError(f"flax leaf {'/'.join(path)} collides on {key}")
        state[key] = torch.tensor(_convert(path, arr))
    return state


_CONV_STACK = re.compile(r"^layers_(\d+)/(Conv|PReLU)_0$")


def conv_stack_params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Convert the params of a flax ``nn.Sequential(conv_stack(...))`` to a
    torch ``state_dict`` of ``nn.Sequential(*conv_stack(...))``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(tree):
        m = _CONV_STACK.match("/".join(path[:-1]))
        if m is None or path[-1] not in _LEAF:
            raise KeyError(f"unmapped flax leaf {'/'.join(path)}")
        state[f"{m.group(1)}.{_LAYER[m.group(2)]}.{_LEAF[path[-1]]}"] = torch.tensor(
            _convert(path, arr))
    return state


_UPFLOW_RULES = [
    (re.compile(r"^FeatureExtractor_0/ConvLeaky_(\d+)/Conv_0$"), r"feature_extractor.convs.\1.conv"),
    (re.compile(r"^conv_1x1_(\d+)/Conv_0$"), r"conv_1x1.\1.conv"),
    (re.compile(r"^flow_estimators/ConvLeaky_(\d+)/Conv_0$"), r"flow_estimators.convs.\1.conv"),
    (re.compile(r"^context_networks/ConvLeaky_(\d+)/Conv_0$"), r"context_networks.convs.\1.conv"),
    (re.compile(r"^sgi_model/dense_estimator_mask/ConvLeaky_(\d+)/Conv_0$"),
     r"sgi_model.dense_estimator_mask.convs.\1.conv"),
    (re.compile(r"^sgu_output_conv/ConvLeaky_(\d+)/Conv_0$"), r"sgu_output_conv.convs.\1.conv"),
]


def upflow_params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Convert flax ``UPFlowNet`` params (nested numpy dict) to a torch ``state_dict``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(tree):
        module, leaf = "/".join(path[:-1]), path[-1]
        for pattern, repl in _UPFLOW_RULES:
            if pattern.match(module) and leaf in ("kernel", "bias"):
                key = f"{pattern.sub(repl, module)}.{_LEAF[leaf]}"
                break
        else:
            raise KeyError(f"unmapped flax leaf {'/'.join(path)}")
        if key in state:
            raise KeyError(f"flax leaf {'/'.join(path)} collides on {key}")
        state[key] = torch.tensor(_convert(path, arr))
    return state
