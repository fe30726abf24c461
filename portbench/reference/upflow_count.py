"""The benchmark's own count of a UPFlow training step's work, taken on the
plain reference at one pair of the cell's crops on the meta device:

- ``flops``: the convolutions' floating-point operations, forward and
  backward (``torch.utils.flop_counter``; the cost volume, the warps and the
  losses are not counted);
- ``warps``: every call the program sends to ``warp2d`` / ``warp2d_with_mask``
  (``site``, ``shape``, ``image_bytes``, ``flow_bytes``, ``mask``,
  ``image_grad``, ``backward``): the masked feature warps of the decoded
  levels, SGU's masked guidance warps and its flow resampling, and the
  occlusion check's two warps (which take no gradient); the photometric
  gathers take no kernel;
- ``corrs``: every ``corr`` call (``site``, ``shape``, ``bytes``, ``grads``,
  ``backward``), one ``corr_bwd`` call where ``backward`` holds.

Where the configuration decodes both directions stacked
(``batch_directions``) the program sends one call of the doubled batch
where the reference makes one a direction; the count merges them (the
occlusion check's warps stay one a direction, as the program calls them).
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import roofline, roofline_corr
from portbench.reference.upflow import RefUPFlow


def _stacked(calls: list[dict]) -> list[dict]:
    merged: dict = {}
    out = []
    for call in calls:
        key = call["site"]
        if key == "occ" or key not in merged:
            call = dict(call, shape=list(call["shape"]))
            merged.setdefault(key, call)
            out.append(call)
        else:
            merged[key]["shape"][0] += call["shape"][0]
    return out


def count(config: dict, crop: tuple[int, int], rho: int) -> dict:
    """``{"flops", "warps", "corrs"}`` of one pair's train step at ``crop``
    with rho-dilated windows."""
    model = RefUPFlow(config["model"], device="meta", bfloat16=config["bfloat16"])
    record: list = []
    model.record = record
    h, w = crop
    im1, im2 = (torch.empty((1, 3, h, w), device="meta") for _ in range(2))
    raw = tuple(torch.empty((1, 3, h + 2 * rho, w + 2 * rho), device="meta") for _ in range(2))
    start = torch.empty((1, 2), device="meta")
    with FlopCounterMode(display=False) as counter:
        out = model(im1, im2)
        total, _ = model.losses(out, im1, im2, raw + (start,), config["loss"])
        total.backward()
    warps = [c for c in record if "mask" in c]
    corrs = [c for c in record if "grads" in c]
    if config["model"]["batch_directions"]:
        warps, corrs = _stacked(warps), _stacked(corrs)
    return {"flops": counter.get_total_flops(), "warps": warps, "corrs": corrs}


def warp_bound_s(calls: list[dict]) -> float:
    """Seconds the warp ``calls`` take at least, forward (the mask plane
    written too where there is one) and, where reached, backward; image and
    flow at their own element sizes."""
    total = 0.0
    for call in calls:
        shape, img, flow = call["shape"], call["image_bytes"], call["flow_bytes"]
        nbytes, ops = roofline.warp2d_forward_work(shape, img, flow)
        if call["mask"]:
            nbytes += shape[0] * shape[2] * shape[3] * img
        total += roofline.bound_s((nbytes, ops))
        if call["backward"]:
            total += roofline.bound_s(
                roofline.warp2d_backward_work(shape, img, flow, call["image_grad"]))
    return total


def work(config: dict, crop: tuple[int, int], rho: int) -> dict:
    """A record's ``work``: FLOPs, the warps' and the cost volumes' least
    seconds, each for one pair."""
    counted = count(config, crop, rho)
    md = config["model"]["search_range"]
    return {"flops_per_sample": counted["flops"],
            "warp_bound_s_per_sample": warp_bound_s(counted["warps"]),
            "corr_bound_s_per_sample": roofline_corr.corr_bound_s(counted["corrs"], md)}
